"""The port's generation against the JAX package, on the CPU.

A tiny GPT is built in the JAX package and its weights carried into the
port through `load_paddle_tpu_state`.  Mirrors tests/test_decode.py and
tests/test_speculative.py on the port: `dyn_update_seq`, the
preallocated and concat caches, `jit_generate`, eager and bucketed
`generate`, eager and jitted beam search and speculative decoding.
Greedy decoding is held token for token to the JAX package's (float32 on
both sides); sampled runs are held to shapes, eos padding and program
reuse only, since JAX's threefry and torch's Philox streams never match.

On the CPU `jit_generate` runs its static decode step without capture;
tests/test_torch_decode_capture.py (torch only, so that it also runs on
the card's machine) holds the captured step against the uncaptured one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.ops.kernels import dyn_update_seq_k
from paddle_tpu.text import GPTConfig as JaxGPTConfig
from paddle_tpu.text import GPTForCausalLM as JaxGPT
from paddle_tpu.text import decode as jax_decode
from paddle_tpu.text import generation as jax_generation
from paddle_tpu_torch import ops
from paddle_tpu_torch.text import (GPTConfig, GPTForCausalLM, beam_search,
                                   generate)
from paddle_tpu_torch.text import decode
from paddle_tpu_torch.text.generation import (BucketPolicy,
                                              _resolve_bucket_policy)
from paddle_tpu_torch.weights import load_paddle_tpu_state

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)
# float32 on both sides, matmuls summed in another order
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)


def _pair(seed=0, **over):
    """A JAX GPT from `seed` and the port's GPT carrying its weights."""
    cfg = dict(TINY, **over)
    pt.seed(seed)
    jm = JaxGPT(JaxGPTConfig(tensor_parallel=False, **cfg))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v)
                               for k, v in jm.state_dict().items()})
    return jm, tm.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def draft():
    """A 1-layer draft of the same vocabulary, its own weights."""
    return _pair(seed=7, num_layers=1)


def _ids(b, n, seed=0, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, n))


def _j(ids):
    return pt.to_tensor(np.asarray(ids).astype("int64"))


def _t(ids):
    return torch.from_numpy(np.asarray(ids).astype(np.int64))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x.numpy())


# ===================================================================
# dyn_update_seq and the preallocated cache
# ===================================================================
@pytest.mark.parametrize("pos", [
    3, 0, 7, -5,      # scalar: inside, at 0, past L - s, from the end
    [0, 5, 2], [9, -2, -20],   # per row: inside; clamped, from the end
], ids=["scalar", "scalar0", "scalar_clamped", "scalar_negative", "rows",
        "rows_clamped"])
def test_dyn_update_seq_matches_jax(pos):
    rng = np.random.RandomState(0)
    buf = rng.randn(3, 8, 2, 4).astype(np.float32)
    val = rng.randn(3, 3, 2, 4).astype(np.float32)
    p = np.asarray(pos, np.int32)
    want = np.asarray(dyn_update_seq_k(jnp.asarray(buf), jnp.asarray(val),
                                       jnp.asarray(p)))
    tb = torch.from_numpy(buf.copy())
    out = ops.dyn_update_seq(tb, torch.from_numpy(val), torch.from_numpy(p))
    assert out is tb                   # written in place
    np.testing.assert_array_equal(tb.numpy(), want)


def test_prealloc_cache_matches_full_forward_and_jax(pair):
    jm, tm = pair
    ids = _ids(2, 6)
    with torch.no_grad():
        full = tm(_t(ids))
        caches = tm.new_caches(2, max_length=10)
        pre = tm(_t(ids), caches=caches)
        # one decode step at pos 6 against the dense forward of 7 tokens
        nxt = _ids(2, 1, seed=1)
        for c in caches:
            c["pos"].fill_(6)
        step = tm(_t(nxt), caches=caches)
        dense7 = tm(_t(np.concatenate([ids, nxt], 1)))
    torch.testing.assert_close(pre, full, **LOGIT_TOL)
    torch.testing.assert_close(step[:, 0], dense7[:, -1], **LOGIT_TOL)
    jc = jm.new_caches(2, max_length=10)
    with pt.no_grad():
        jpre = jm(_j(ids), caches=jc)
    np.testing.assert_allclose(pre.numpy(), _np(jpre), **LOGIT_TOL)
    assert caches[0]["k"].shape == (2, 10, 4, 8)
    assert caches[0]["k"][:, 7:].abs().sum() == 0   # past pos: untouched


def test_concat_cache_matches_full_forward(pair):
    _, tm = pair
    ids = _ids(2, 7, seed=2)
    with torch.no_grad():
        caches = tm.new_caches(2)
        assert caches[0]["k"].shape == (2, 0, 4, 8) and "pos" not in caches[0]
        first = tm(_t(ids[:, :5]), caches=caches)
        second = tm(_t(ids[:, 5:]), caches=caches)
        full = tm(_t(ids))
    torch.testing.assert_close(torch.cat([first, second], 1), full,
                               **LOGIT_TOL)
    assert caches[1]["v"].shape == (2, 7, 4, 8)


# ===================================================================
# greedy token identity with the JAX package
# ===================================================================
@pytest.fixture(scope="module")
def greedy_ref(pair):
    """JAX's greedy tokens of a 2-row batch, and a token it emits (used
    as eos by the eos tests)."""
    jm, _ = pair
    ids = _ids(2, 5, seed=3)
    out = _np(jax_decode.jit_generate(jm, _j(ids), max_new_tokens=8))
    return ids, out, int(out[0, 5 + 2])


def test_jit_generate_matches_jax(pair, greedy_ref):
    _, tm = pair
    ids, want, _ = greedy_ref
    got = decode.jit_generate(tm, _t(ids), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (2, 13) and got.dtype == torch.long


def test_jit_generate_with_eos_matches_jax(pair, greedy_ref):
    jm, tm = pair
    ids, _, eos = greedy_ref
    want = _np(jax_decode.jit_generate(jm, _j(ids), max_new_tokens=8,
                                       eos_token_id=eos))
    got = tm.generate(_t(ids), max_new_tokens=8, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    # every position after a row's eos is eos
    for row in got.numpy():
        hit = np.flatnonzero(row[5:] == eos)
        if hit.size:
            assert (row[5 + hit[0]:] == eos).all()


def test_eager_generate_matches_jax_and_jit(pair, greedy_ref):
    jm, tm = pair
    ids, want, eos = greedy_ref
    got = tm.generate(_t(ids), max_new_tokens=8, use_jit=False)
    np.testing.assert_array_equal(got.numpy(), want)
    jeos = _np(jax_generation.generate(jm, _j(ids), max_new_tokens=8,
                                       eos_token_id=eos))
    np.testing.assert_array_equal(
        generate(tm, _t(ids), max_new_tokens=8, eos_token_id=eos).numpy(),
        jeos)


@pytest.mark.parametrize("spec", ["on", "8,16", [32], BucketPolicy()],
                         ids=["on", "explicit", "list", "policy"])
def test_bucketed_generate_equals_eager(pair, greedy_ref, spec):
    _, tm = pair
    ids, want, eos = greedy_ref
    got = generate(tm, _t(ids), max_new_tokens=8, shape_buckets=spec)
    np.testing.assert_array_equal(got.numpy(), want)
    with_eos = generate(tm, _t(ids), max_new_tokens=8, eos_token_id=eos,
                        shape_buckets=spec)
    plain = generate(tm, _t(ids), max_new_tokens=8, eos_token_id=eos)
    np.testing.assert_array_equal(with_eos.numpy(), plain.numpy())


class Wrapper:
    """Stands for a `to_static` of `layer` as the compile tracker's owner."""

    def __init__(self, layer):
        self.layer = layer


def test_bucket_policy_resolution(pair, monkeypatch):
    from paddle_tpu_torch.observability import compile_tracker as ct
    _, tm = pair
    ct.reset()
    # no shape-change recompile recorded yet: "auto" is no bucketing
    assert _resolve_bucket_policy("auto", tm) is None
    assert _resolve_bucket_policy("off", tm) is None
    assert _resolve_bucket_policy(None, tm) is None
    monkeypatch.setenv("PADDLE_TPU_SHAPE_BUCKETS", "16,64")
    assert _resolve_bucket_policy(None, tm).buckets == [16, 64]
    monkeypatch.setenv("PADDLE_TPU_SHAPE_BUCKETS", "auto")
    assert _resolve_bucket_policy(None, tm) is None
    # two shape-change recompiles of a compiled entry wrapping the model
    # arm it, as the JAX package's tracker does; those of another model
    # under the same label do not
    label = f"to_static({type(tm).__name__})"
    other, wrapper = Wrapper(object()), Wrapper(tm)

    def recompile(owner):
        for n in (4, 5, 6):
            tok = ct.on_call(label, ct.signature_of([torch.zeros(1, n)]),
                             owner=owner)
            ct.finish(tok)
    try:
        recompile(other)
        assert _resolve_bucket_policy("auto", tm) is None
        recompile(wrapper)
        assert isinstance(_resolve_bucket_policy(None, tm), BucketPolicy)
        assert isinstance(_resolve_bucket_policy("auto", tm), BucketPolicy)
    finally:
        ct.reset()


def test_bucketed_past_position_table_warns_and_matches(pair,
                                                        monkeypatch):
    """A request past max_position_embeddings keeps the unbucketed loop
    (with a warning) instead of clamping positions."""
    _, tm = pair
    monkeypatch.setattr(tm.cfg, "max_position_embeddings", 10)
    ids = _t(_ids(1, 6, seed=4))
    with pytest.warns(UserWarning, match="max_position_embeddings"):
        got = generate(tm, ids, max_new_tokens=6, shape_buckets="on")
    np.testing.assert_array_equal(
        got.numpy(), generate(tm, ids, max_new_tokens=6).numpy())


# ===================================================================
# beam search
# ===================================================================
@pytest.fixture(scope="module")
def beam_pair():
    return _pair(seed=11, vocab_size=96, hidden_size=48, num_layers=3,
                 max_position_embeddings=96)


BEAM_IDS = np.array([[5, 17, 40, 3], [1, 2, 3, 4]])


def test_beam_search_matches_jax(beam_pair):
    jm, tm = beam_pair
    want = _np(jax_generation.beam_search(jm, _j(BEAM_IDS), beam_size=4,
                                          max_new_tokens=10,
                                          length_penalty=0.8))
    eager = beam_search(tm, _t(BEAM_IDS), beam_size=4, max_new_tokens=10,
                        length_penalty=0.8)
    jitted = decode.jit_beam_search(tm, _t(BEAM_IDS), beam_size=4,
                                    max_new_tokens=10, length_penalty=0.8)
    np.testing.assert_array_equal(eager.numpy(), want)
    np.testing.assert_array_equal(jitted.numpy(), want)


def test_beam_search_with_eos_matches_jax(beam_pair):
    jm, tm = beam_pair
    plain = beam_search(tm, _t(BEAM_IDS), beam_size=3, max_new_tokens=12)
    eos = int(plain[0, 4 + 2])          # a token a beam really emits
    want = _np(jax_generation.beam_search(jm, _j(BEAM_IDS), beam_size=3,
                                          max_new_tokens=12,
                                          eos_token_id=eos))
    jwant = _np(jax_decode.jit_beam_search(jm, _j(BEAM_IDS), beam_size=3,
                                           max_new_tokens=12,
                                           eos_token_id=eos))
    eager = beam_search(tm, _t(BEAM_IDS), beam_size=3, max_new_tokens=12,
                        eos_token_id=eos)
    jitted = decode.jit_beam_search(tm, _t(BEAM_IDS), beam_size=3,
                                    max_new_tokens=12, eos_token_id=eos)
    np.testing.assert_array_equal(eager.numpy(), want)
    np.testing.assert_array_equal(jitted.numpy(), jwant)
    L = want.shape[1]
    np.testing.assert_array_equal(jitted.numpy()[:, :L], want)
    assert (jitted.numpy()[:, L:] == eos).all()   # frozen-beam padding


def test_generate_routes_num_beams(beam_pair):
    _, tm = beam_pair
    ids = _t(BEAM_IDS[:1])
    want = beam_search(tm, ids, beam_size=3, max_new_tokens=6)
    got = generate(tm, ids, max_new_tokens=6, num_beams=3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(NotImplementedError, match="compose"):
        generate(tm, ids, num_beams=2, do_sample=True)


# ===================================================================
# speculative decoding
# ===================================================================
@pytest.mark.parametrize("k", [1, 3, 5])
def test_speculative_greedy_equals_jit_generate(pair, draft, k):
    jm, tm = pair
    jd, td = draft
    ids = _ids(3, 6, seed=5)
    want = decode.jit_generate(tm, _t(ids), max_new_tokens=12)
    got = decode.speculative_generate(tm, td, _t(ids), max_new_tokens=12,
                                      num_speculative_tokens=k)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if k == 3:
        jgot = _np(jax_decode.speculative_generate(
            jm, jd, _j(ids), max_new_tokens=12, num_speculative_tokens=k))
        np.testing.assert_array_equal(got.numpy(), jgot)


def test_speculative_greedy_with_eos(pair, draft, greedy_ref):
    _, tm = pair
    _, td = draft
    ids, _, eos = greedy_ref
    want = decode.jit_generate(tm, _t(ids), max_new_tokens=8,
                               eos_token_id=eos)
    got = generate(tm, _t(ids), max_new_tokens=8, eos_token_id=eos,
                   draft_model=td, num_speculative_tokens=3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_speculative_rejects_zero_tokens(pair, draft):
    with pytest.raises(ValueError, match=">= 1"):
        decode.speculative_generate(pair[1], draft[1], _t(_ids(1, 3)),
                                    num_speculative_tokens=0)


# ===================================================================
# sampling: shapes, eos padding, generators, program reuse
# ===================================================================
def test_jit_sampling_shapes_and_program_reuse():
    _, tm = _pair()
    ids = _t(_ids(2, 4))
    kw = dict(max_new_tokens=5, do_sample=True, top_k=10, top_p=0.9,
              temperature=0.8)
    out = tm.generate(ids, **kw)
    assert out.shape == (2, 9)
    out2 = tm.generate(ids, **kw)                 # the same program
    assert out2.shape == (2, 9)
    assert len(tm._jit_decode_cache) == 1
    assert ((out >= 0) & (out < 64)).all()
    np.testing.assert_array_equal(out[:, :4].numpy(), ids.numpy())


def test_sampled_eos_padding(pair):
    """A sampled row that draws eos emits only eos after it, in every
    loop; the output stops after the last row's eos."""
    _, tm = pair
    ids = _t(_ids(4, 3, seed=6))
    eos = 7
    g = torch.Generator().manual_seed(0)
    for fn in (lambda **kw: decode.jit_generate(tm, ids, **kw),
               lambda **kw: generate(tm, ids, **kw)):
        out = fn(max_new_tokens=30, do_sample=True, temperature=3.0,
                 eos_token_id=eos, generator=g).numpy()
        for row in out:
            hit = np.flatnonzero(row[3:] == eos)
            if hit.size:
                assert (row[3 + hit[0]:] == eos).all()
        assert out.shape[1] <= 33


def test_speculative_sampling_shapes_and_eos(pair, draft):
    _, tm = pair
    _, td = draft
    ids = _t(_ids(3, 4, seed=8))
    g = torch.Generator().manual_seed(3)
    out = decode.speculative_generate(tm, td, ids, max_new_tokens=9,
                                      num_speculative_tokens=3,
                                      do_sample=True, top_k=20,
                                      temperature=0.9, generator=g)
    assert out.shape == (3, 13)
    np.testing.assert_array_equal(out[:, :4].numpy(), ids.numpy())
    out = decode.speculative_generate(tm, td, ids, max_new_tokens=20,
                                      num_speculative_tokens=2,
                                      do_sample=True, temperature=3.0,
                                      eos_token_id=5, generator=g).numpy()
    for row in out:
        hit = np.flatnonzero(row[4:] == 5)
        if hit.size:
            assert (row[4 + hit[0]:] == 5).all()


def test_truncate_at_eos_matches_jax():
    out = np.array([[1, 2, 9, 3, 9, 9], [1, 2, 4, 4, 9, 9],
                    [1, 2, 5, 5, 5, 5]])
    for rows in (out, out[:2], out[:1]):
        want = np.asarray(jax_decode._truncate_at_eos(rows, 2, 9))
        got = decode._truncate_at_eos(torch.from_numpy(rows), 2, 9)
        np.testing.assert_array_equal(got.numpy(), want)
