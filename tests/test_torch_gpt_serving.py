"""The port's GPT serving path against the JAX package, on CPU.

A tiny GPT is built in the JAX package, its weights carried into the
port through `load_paddle_tpu_state`, and the two are held together:
dense logits, paged prefill, and the engines' greedy tokens under
concurrent interleaved requests (also with the JAX side on its real
Pallas paged kernel in interpret mode).  The rest mirrors the JAX
engine's own tests (tests/test_serving.py) on the port: pool refcounts
and leaks, eos, streaming, sampled determinism, preemption and resume,
shedding and drain, validation.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.text import GPTConfig as JaxGPTConfig
from paddle_tpu.text import GPTForCausalLM as JaxGPT
from paddle_tpu.text import generation as jax_generation
from paddle_tpu_torch.serving import (BlockPool, LLMEngine, PoolExhausted,
                                      ShedRequest)
from paddle_tpu_torch.text import (BucketPolicy, GPTConfig, GPTForCausalLM,
                                   filter_logits)
from paddle_tpu_torch.weights import load_paddle_tpu_state

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)


def _pair(**cfg):
    """A JAX GPT from seed 0 and the port's GPT carrying its weights."""
    pt.seed(0)
    jm = JaxGPT(JaxGPTConfig(tensor_parallel=False, **cfg))
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v)
                               for k, v in jm.state_dict().items()})
    return jm, tm.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair(**TINY)


@pytest.fixture(scope="module")
def engine(pair):
    """One port engine shared by the behaviour tests (each drains)."""
    return LLMEngine(pair[1], num_blocks=48, block_size=8, max_running=9,
                     prefill_chunk=16)


def _dense_greedy(model, prompt, n, eos=None):
    """Greedy decoding by full dense forwards: the plainest reference."""
    ids = list(prompt)
    for _ in range(n):
        with torch.no_grad():
            tok = int(model(torch.tensor([ids]))[0, -1].argmax())
        ids.append(tok)
        if tok == eos:
            break
    return ids[len(prompt):]


# ===================================================================
# weights and the dense / paged forward
# ===================================================================
def test_dense_logits_match_jax(pair):
    jm, tm = pair
    ids = np.random.RandomState(0).randint(0, 64, size=(2, 10))
    ref = jm(pt.to_tensor(ids.astype("int64"))).numpy()
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    # float32 on both sides; the matmuls sum in another order
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_load_rejects_missing_names_and_bad_shapes(pair):
    jm, _ = pair
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    with pytest.raises(KeyError):
        load_paddle_tpu_state(tm, {k: v for k, v in arrays.items()
                                   if k != "gpt.ln_f.bias"})
    bad = dict(arrays)
    bad["gpt.h.0.attn.qkv_proj.weight"] = bad[
        "gpt.h.0.attn.qkv_proj.weight"].T      # already transposed
    with pytest.raises(ValueError):
        load_paddle_tpu_state(tm, bad)


def test_paged_prefill_matches_dense_forward(pair):
    """One whole-prompt paged forward == the dense forward (mirrors the
    JAX package's test of the same name)."""
    tm = pair[1]
    ids = torch.randint(0, 64, (1, 6),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        full = tm(ids)
        pool = BlockPool.for_model(tm, num_blocks=8, block_size=4)
        caches = [{"k": pool.k[i], "v": pool.v[i],
                   "table": torch.tensor([[3, 5]], dtype=torch.int32),
                   "pos": torch.zeros(1, dtype=torch.int32),
                   "limit": torch.full((1,), 6, dtype=torch.int32)}
                  for i in range(pool.num_layers)]
        paged = tm(ids, caches=caches)
    torch.testing.assert_close(paged, full, rtol=2e-4, atol=2e-5)
    assert pool.k[0][[3, 5]].abs().sum() > 0     # written in place


# ===================================================================
# engine token parity with the JAX engine
# ===================================================================
def _interleaved(eng, prompts, n):
    """First wave mid-flight when the rest join the batch."""
    reqs = [eng.add_request(p, max_new_tokens=n) for p in prompts[:5]]
    for _ in range(3):
        eng.step()
    reqs += [eng.add_request(p, max_new_tokens=n) for p in prompts[5:]]
    eng.run()
    return [list(r.generated) for r in reqs]


def test_engine_parity_with_jax_concurrent_interleaved(pair, engine):
    jm, tm = pair
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 64, size=n).tolist()
               for n in (5, 11, 3, 9, 14, 7, 4, 12, 6)]
    ref = _interleaved(JaxEngine(jm, num_blocks=48, block_size=8,
                                 max_running=9, prefill_chunk=16),
                       prompts, 7)
    assert _interleaved(engine, prompts, 7) == ref
    assert engine.pool.check_leaks() == ([], [])
    assert engine.pool.free_blocks == engine.pool.num_blocks


def test_engine_parity_with_jax_pallas_kernel_d128(monkeypatch):
    """D = 128, so the JAX engine's decode runs the Pallas paged kernel
    (interpret mode on the CPU) rather than its gather path."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
    jm, tm = _pair(vocab_size=64, hidden_size=256, num_layers=2,
                   num_heads=2, max_position_embeddings=32,
                   hidden_dropout=0.0, attention_dropout=0.0)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 64, size=n).tolist() for n in (5, 9, 3)]
    kw = dict(num_blocks=16, block_size=8, max_running=3, prefill_chunk=16)
    ref = JaxEngine(jm, **kw).generate_batch(prompts, max_new_tokens=4)
    assert LLMEngine(tm, **kw).generate_batch(prompts,
                                              max_new_tokens=4) == ref


def test_preemption_resume_parity_with_jax(pair):
    jm, tm = pair
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 64, size=n).tolist()
               for n in (7, 11, 5, 9, 6, 4)]
    ref = JaxEngine(jm, num_blocks=48, block_size=8, max_running=6,
                    prefill_chunk=16).generate_batch(prompts,
                                                     max_new_tokens=8)
    # 6 blocks of 4 tokens cannot hold 6 requests of 12-19 tokens:
    # preemption must fire, and evicted requests re-prefill and resume
    eng = LLMEngine(tm, num_blocks=6, block_size=4, max_running=6,
                    prefill_chunk=8)
    reqs = [eng.add_request(p, max_new_tokens=8) for p in prompts]
    eng.run()
    assert sum(r.preemptions for r in reqs) >= 1
    assert [list(r.generated) for r in reqs] == ref
    assert eng.pool.free_blocks == eng.pool.num_blocks


# ===================================================================
# engine behaviour
# ===================================================================
def test_engine_matches_dense_greedy(pair, engine):
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 11, 12]]
    refs = [_dense_greedy(pair[1], p, 6) for p in prompts]
    assert engine.generate_batch(prompts, max_new_tokens=6) == refs


def test_engine_eos_stops_request(pair, engine):
    prompt = [1, 2, 3, 4, 5]
    first = _dense_greedy(pair[1], prompt, 1)[0]
    ref = _dense_greedy(pair[1], prompt, 6, eos=first)
    [out] = engine.generate_batch([prompt], max_new_tokens=6,
                                  eos_token_id=first)
    assert out == ref and len(out) < 6
    assert engine._finished[-1].finish_reason == "eos"


def test_streaming_callbacks_order(engine):
    got, done = [], []
    req = engine.add_request([3, 1, 4, 1, 5], max_new_tokens=5,
                             on_token=lambda r, t: got.append(t),
                             on_finish=lambda r: done.append(r.id))
    engine.run()
    assert got == list(req.generated) and len(got) == 5
    assert done == [req.id]


def test_sampled_requests_deterministic_per_seed(engine):
    prompts = [[5, 6, 7], [9, 8, 7, 6]]
    kw = dict(max_new_tokens=6, do_sample=True, temperature=0.9,
              top_k=20, seed=123)
    a = engine.generate_batch(prompts, **kw)
    b = engine.generate_batch(list(reversed(prompts)), **kw)
    # a per-(seed, position) numpy stream: independent of the batch
    assert a == list(reversed(b))
    c = engine.generate_batch(prompts, **dict(kw, seed=124))
    assert c != a


def test_nonfinite_logits_fail_only_that_request(pair, monkeypatch):
    tm = pair[1]
    eng = LLMEngine(tm, num_blocks=16, block_size=8, max_running=4,
                    prefill_chunk=16)
    forward = tm.forward

    def poisoned(*args, **kw):        # ruin row 0 of the first decode
        out = forward(*args, **kw)
        if not poisoned.fired:
            poisoned.fired = True
            out[0] = float("nan")
        return out

    poisoned.fired = False
    monkeypatch.setattr(tm, "forward", poisoned)
    a = eng.add_request([1, 2, 3], max_new_tokens=4)
    b = eng.add_request([4, 5, 6], max_new_tokens=4)
    eng.run()
    assert a.finish_reason == "error" and a.generated == []
    assert b.finish_reason == "length" and len(b.generated) == 4
    assert eng.pool.check_leaks() == ([], [])


def test_preempted_request_keeps_queue_front(pair):
    eng = LLMEngine(pair[1], num_blocks=4, block_size=4, max_running=2,
                    prefill_chunk=8)
    a = eng.add_request([1] * 9, max_new_tokens=6)
    b = eng.add_request([2] * 9, max_new_tokens=6)
    eng.run()
    assert a.finish_reason == "length" and b.finish_reason == "length"
    assert eng.pool.check_leaks() == ([], [])


def test_shed_drain_and_close(pair):
    eng = LLMEngine(pair[1], num_blocks=16, block_size=8, max_running=1,
                    prefill_chunk=16, shed_queue_depth=2)
    running = eng.add_request([1, 2, 3], max_new_tokens=3)
    eng.step()                                     # admitted, decoding
    queued = [eng.add_request([4, 5], max_new_tokens=3) for _ in range(2)]
    with pytest.raises(ShedRequest) as e:
        eng.add_request([6], max_new_tokens=3)
    assert e.value.reason == "queue_depth"
    summary = eng.drain()
    assert summary["drained"] == 2
    assert [r.finish_reason for r in queued] == ["drained", "drained"]
    assert running.finish_reason == "length"
    with pytest.raises(ShedRequest):
        eng.add_request([7], max_new_tokens=3)
    assert eng.close() == ([], [])
    snap = {r["name"] for r in eng.metrics_snapshot()}
    assert {"serving_requests_shed_total",
            "serving_decode_step_seconds"} <= snap


def test_add_request_validation(pair):
    eng = LLMEngine(pair[1], num_blocks=4, block_size=4)   # 16-token pool
    with pytest.raises(ValueError):
        eng.add_request([], max_new_tokens=4)
    with pytest.raises(ValueError):
        eng.add_request([1] * 60, max_new_tokens=10)     # > max_model_len
    with pytest.raises(PoolExhausted):
        eng.add_request([1] * 20, max_new_tokens=10)     # > whole pool


# ===================================================================
# block pool invariants (mirror tests/test_serving.py)
# ===================================================================
def test_block_pool_alloc_free_refcount():
    pool = BlockPool(num_layers=1, num_blocks=8, block_size=4,
                     num_kv_heads=2, head_dim=8, device="cpu")
    a = pool.allocate(3)
    assert len(a) == 3 and pool.free_blocks == 5
    pool.ref(a)
    pool.free(a)
    assert pool.free_blocks == 5          # still held once
    pool.free(a)
    assert pool.free_blocks == 8
    with pytest.raises(ValueError):
        pool.free(a)                      # double free
    b = pool.allocate(8)
    assert pool.allocate(1) is None       # exhausted: None, not a raise
    with pytest.raises(PoolExhausted):
        pool.allocate(9)                  # can never fit
    pool.free(b)
    assert pool.check_leaks() == ([], [])
    with pytest.raises(ValueError):
        pool.ref([0])


def test_block_pool_blocks_for_and_layout():
    pool = BlockPool(2, 8, 16, 2, 8, dtype=torch.bfloat16, device="cpu")
    assert [pool.blocks_for(n) for n in (1, 16, 17, 32)] == [1, 1, 2, 2]
    assert pool.k[1].shape == (8, 16, 2, 8)
    assert pool.v[0].dtype == torch.bfloat16


@pytest.mark.parametrize("seed", range(8))
def test_block_pool_random_interleavings_property(seed):
    """Any interleaving of allocate / ref / free / bulk free ends with a
    full free list and no refcount drift; a shadow refcount model checks
    every intermediate state."""
    rng = np.random.RandomState(seed)
    pool = BlockPool(num_layers=1, num_blocks=16, block_size=4,
                     num_kv_heads=2, head_dim=8, device="cpu")
    shadow, tables = {}, []
    for _ in range(300):
        op = rng.randint(4)
        if op == 0:
            n = int(rng.randint(1, 5))
            got = pool.allocate(n)
            if got is None:
                continue
            assert len(set(got)) == n
            assert not any(shadow.get(b, 0) > 0 for b in got)
            for b in got:
                shadow[b] = 1
            tables.append(list(got))
        elif op == 1 and tables:
            t = tables[int(rng.randint(len(tables)))]
            pool.ref(t)
            tables.append(list(t))
            for b in t:
                shadow[b] += 1
        elif op == 2 and tables:
            t = tables.pop(int(rng.randint(len(tables))))
            pool.free(t)
            for b in t:
                shadow[b] -= 1
        elif op == 3 and tables:
            for _ in range(int(rng.randint(1, len(tables) + 1))):
                t = tables.pop()
                pool.free(t)
                for b in t:
                    shadow[b] -= 1
        held = sum(1 for r in shadow.values() if r > 0)
        assert pool.free_blocks == pool.num_blocks - held
        assert pool._refs == [shadow.get(b, 0)
                              for b in range(pool.num_blocks)]
    for t in tables:
        pool.free(t)
    assert pool.check_leaks() == ([], [])
    assert sorted(pool._free) == list(range(pool.num_blocks))


# ===================================================================
# sampling helpers against the JAX package
# ===================================================================
@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 5, None), (1.3, None, 0.8), (0.9, 10, 0.6)])
def test_filter_logits_matches_jax(temperature, top_k, top_p):
    import jax.numpy as jnp
    logits = np.random.RandomState(6).randn(3, 50).astype(np.float32) * 3
    ref = np.asarray(jax_generation.filter_logits(
        jnp.asarray(logits), temperature, top_k, top_p))
    out = filter_logits(torch.from_numpy(logits), temperature, top_k,
                        top_p).numpy()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    keep = np.isfinite(ref)
    np.testing.assert_allclose(out[keep], ref[keep], rtol=1e-6)


def test_filter_logits_top_p_cutoff_past_the_end():
    """Rounding can leave the whole cumsum below a top_p just under 1, so
    the cutoff index runs past the row: JAX's gather yields NaN there and
    masks nothing, and the port must do the same, not index out of
    range."""
    top_p, hits = 1 - 1e-9, 0
    for seed in range(20):          # one row at a time, as the engine calls
        logits = torch.from_numpy(
            np.random.RandomState(seed).randn(1, 50).astype(np.float32) * 3)
        out = filter_logits(logits, 1.0, None, top_p)
        cum = torch.softmax(logits.sort(dim=-1, descending=True).values,
                            dim=-1).cumsum(dim=-1)
        if bool((cum < top_p).all()):
            hits += 1
            assert torch.isfinite(out).all()
    assert hits                     # the case occurs among these seeds


def test_sampled_tokens_match_jax_engine(pair, engine):
    """Both engines draw from np.random.default_rng([seed, position]) over
    the same filtered float32 distribution."""
    jm, _ = pair
    prompts = [[5, 6, 7], [9, 8, 7, 6], [1, 2]]
    kw = dict(max_new_tokens=6, do_sample=True, temperature=0.8,
              top_k=12, top_p=0.9, seed=7)
    ref = JaxEngine(jm, num_blocks=48, block_size=8, max_running=9,
                    prefill_chunk=16).generate_batch(prompts, **kw)
    assert engine.generate_batch(prompts, **kw) == ref


def test_metrics_registry_matches_jax():
    """The port's copy of the registry gives the JAX package's snapshot
    for the same operations, reservoir sampling included."""
    from paddle_tpu.observability.metrics import MetricsRegistry as JaxReg
    from paddle_tpu_torch.observability.metrics import MetricsRegistry
    snaps = []
    for reg in (JaxReg(), MetricsRegistry()):
        reg.counter("serving_requests_shed_total", reason="queue").inc(3)
        reg.counter("serving_decode_steps_total").inc()
        reg.gauge("serving_free_blocks").set(17)
        h = reg.histogram("serving_ttft_seconds", reservoir=16)
        for v in np.random.RandomState(8).rand(100):
            h.observe(v)
        with pytest.raises(ValueError):
            reg.gauge("serving_decode_steps_total")
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0]


def test_bucket_policy_matches_jax():
    for buckets in (None, [8, 24, 100]):
        ours, ref = BucketPolicy(buckets), jax_generation.BucketPolicy(
            buckets)
        assert [ours.bucket(n) for n in range(1, 300, 7)] == \
            [ref.bucket(n) for n in range(1, 300, 7)]
    for spec in (None, "off", "auto", "16,64"):
        a = BucketPolicy.from_spec(spec)
        b = jax_generation.BucketPolicy.from_spec(spec)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.buckets, a.min_bucket) == (b.buckets, b.min_bucket)
