"""The port's AOT serving and inference artifacts against the JAX package's
behaviour, on the CPU.

`paddle_tpu_torch.serving.aot`, the engine's program layer
(`program_keys`, `program_structs`, `_run_program`, `retire_aot`), the
worker's `load_aot`, the router's `warm_start` and
`jit.save_inference(aot=True)` / `load_inference(prefer_aot=,
strict_aot=)`:

* without a compile: the inventory equals the JAX engine's for the same
  chunk, ladder and prompt lengths; program names round-trip as the JAX
  ones do; each stamp refusal names its field; a missing manifest is
  refused and `strict` raises `AOTIncompatible`;
* one module fixture compiles a tiny GPT's inventory (2 layers, hidden
  64, decode + prefill 32) in float32: the engine serving from it gives
  the greedy tokens of the port's eager engine and of the JAX engine on
  the same weights, with every call through a package; a flipped byte
  and an edited stamp are refused and counted; `retire_aot` serves
  eagerly with the same tokens; a call of another shape falls back; a
  worker process loads both programs and serves from them; a router
  warm-starts its respawned replica;
* one tiny ERNIE `save_inference(aot=True)`: it loads with `is_aot`,
  its logits equal the exported program's and match the JAX model's
  (loaded `prefer_aot=False`), a damaged package is refused (or raises
  under `strict_aot`), and a call of another dtype falls back.

AOTInductor compiles C++ here (about 15-45 s a program): the file
compiles three programs.  The known-red JAX AOT tests
(`test_serving_aot_roundtrip_zero_compile`,
`test_aot_roundtrip_serves_without_compilation`) are not leaned on: the
JAX engines here serve live.

Tolerances: tokens exact; ERNIE logits equal the exported program's
within 1e-5 (float32, fused in another order by the compiler) and the
JAX model's within rtol 1e-5, atol 1e-5.
"""
import json
import os
import shutil
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.jit import save_load as jax_save_load
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import aot as jax_aot
from paddle_tpu.text import GPTConfig as JaxGPTConfig
from paddle_tpu.text import GPTForCausalLM as JaxGPT
from paddle_tpu.text import ernie as jernie
from paddle_tpu_torch.jit import InputSpec, load_inference, save_inference
from paddle_tpu_torch.jit import save_load
from paddle_tpu_torch.jit.save_load import AOTIncompatible
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.resilience import backoff, chaos
from paddle_tpu_torch.serving import (LLMEngine, Router,
                                      export_serving_artifacts,
                                      load_serving_artifacts)
from paddle_tpu_torch.serving import aot
from paddle_tpu_torch.serving import transport as tr
from paddle_tpu_torch.serving import worker as sw
from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.text import ernie as ternie
from paddle_tpu_torch.weights import load_paddle_tpu_state

CFG = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=128, hidden_dropout=0.0,
           attention_dropout=0.0)
ENGINE = dict(num_blocks=40, block_size=8, max_running=4, prefill_chunk=32,
              buckets=[32])
# a 1-token prompt (no prefill), chunked prompts past the 32-token chunk
LENS = (1, 5, 40, 70, 17, 33)
NEW = 10
DEADLINE_S = 120.0


def _counter(name, **labels):
    return metrics.registry().counter(name, **labels).value


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], size=n).tolist()
            for n in LENS]


@pytest.fixture(scope="module")
def pair():
    """The JAX GPT from seed 0 and the port's GPT on its weights."""
    pt.seed(0)
    jm = JaxGPT(JaxGPTConfig(tensor_parallel=False, **CFG))
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v)
                               for k, v in jm.state_dict().items()})
    return jm, tm.eval()


@pytest.fixture(scope="module")
def artifacts(pair, tmp_path_factory):
    """The tiny GPT's inventory compiled once, its two programs in two
    child processes side by side: (directory, manifest)."""
    path = str(tmp_path_factory.mktemp("serving_aot"))
    before = _counter("serving_aot_exported_total")
    eng = LLMEngine(pair[1], **ENGINE)
    manifest = export_serving_artifacts(eng, path)
    assert eng.close() == ([], [])
    assert os.path.exists(os.path.join(path, aot._MANIFEST))
    assert _counter("serving_aot_exported_total") - before == 2
    return path, manifest


@pytest.fixture(scope="module")
def live_tokens(pair):
    eng = LLMEngine(pair[1], **ENGINE)
    out = eng.generate_batch(_prompts(), max_new_tokens=NEW)
    assert eng.close() == ([], [])
    return out


# ===================================================================
# without a compile
# ===================================================================
@pytest.mark.parametrize("chunk,buckets,prompt_lens", [
    (64, None, ()),
    (64, None, (10, 100, 1)),
    (16, [16], ()),
    (100, [8, 24, 50], (3, 30, 200)),
    (32, [32], (5, 40)),
    (512, None, ()),
])
def test_program_keys_match_the_jax_engine(pair, chunk, buckets,
                                           prompt_lens):
    jm, tm = pair
    kw = dict(num_blocks=16, block_size=8, max_running=4,
              prefill_chunk=chunk, buckets=buckets)
    want = JaxEngine(jm, **kw).program_keys(prompt_lens=prompt_lens)
    assert LLMEngine(tm, **kw).program_keys(prompt_lens=prompt_lens) == want


@pytest.mark.parametrize("key", [("decode",), ("prefill", 32),
                                 ("prefill", 512)])
def test_program_names_round_trip_as_jax(key):
    name = aot._key_name(key)
    assert name == jax_aot._key_name(key)
    assert aot._name_key(name) == jax_aot._name_key(name) == key


def test_program_structs_rejects_an_unknown_key(pair):
    with pytest.raises(KeyError, match="unknown serving program key"):
        LLMEngine(pair[1], **ENGINE).program_structs(("verify", 4))


def test_stamp_of_this_host_is_compatible():
    stamp = save_load._env_stamp("cpu")
    assert stamp["platform"] == "cpu" and stamp["torch"] == torch.__version__
    assert save_load._aot_compatible(stamp) == (True, "")


@pytest.mark.parametrize("field,what,value", [
    ("platform", "backend platform", "gpu"),
    ("device_kind", "device kind", "NVIDIA H100 80GB HBM3"),
    ("n_devices", "device count", 4),
    ("capability", "compute capability", "9.0"),
    ("torch", "torch version", "0.0.0"),
    ("cuda", "CUDA version", "99.9"),
])
def test_stamp_refusal_names_the_field(field, what, value):
    stamp = dict(save_load._env_stamp("cpu"), **{field: value})
    ok, reason = save_load._aot_compatible(stamp)
    assert not ok
    if field != "platform":      # a gpu stamp is read on the cuda stamp
        cur = save_load._env_stamp("cpu")[field]
        assert reason == (f"{what} mismatch: artifact compiled for "
                          f"{value!r}, this host is {cur!r}")
    assert reason.startswith(f"{what} mismatch")


@pytest.mark.parametrize("strict", [False, True])
def test_missing_manifest_is_refused(pair, tmp_path, strict):
    eng = LLMEngine(pair[1], **ENGINE)
    if strict:
        with pytest.raises(AOTIncompatible, match="unreadable serving "
                                                  "manifest"):
            load_serving_artifacts(eng, str(tmp_path), strict=True)
    else:
        with pytest.warns(UserWarning, match="no serving AOT manifest"):
            assert load_serving_artifacts(eng, str(tmp_path)) == []
    assert eng._aot_execs == {}


# ===================================================================
# the compiled inventory
# ===================================================================
def test_inventory_is_small_and_holds_no_weights(pair, artifacts):
    path, manifest = artifacts
    assert sorted(manifest["programs"]) == ["decode", "prefill_32"]
    on_disk = json.load(open(os.path.join(path, aot._MANIFEST)))
    assert on_disk["stamp"] == save_load._env_stamp("cpu")
    n_weights = sum(1 for _ in pair[1].parameters())
    for name, entry in manifest["programs"].items():
        f = os.path.join(path, entry["file"])
        assert os.path.getsize(f) == entry["bytes"]
        assert entry["file"] == os.path.join("programs", f"{name}.pt2")
        # the weights are the program's first inputs, the pools next
        assert len(entry["signature"]) > n_weights
    dec = manifest["programs"]["decode"]["signature"]
    assert dec[-1]["shape"] == [["R", 1, 4], 1]           # tokens [R, 1]
    assert dec[-3]["shape"] == [["R", 1, 4], ["M", 1, 16]]  # tables


def test_aot_engine_tokens_equal_live_and_jax(pair, artifacts,
                                              live_tokens):
    jm, tm = pair
    path, _ = artifacts
    eng = LLMEngine(tm, **ENGINE)
    loaded = load_serving_artifacts(eng, path, strict=True)
    assert sorted(loaded) == [("decode",), ("prefill", 32)]
    aot0 = _counter("serving_program_calls_total", route="aot")
    live0 = _counter("serving_program_calls_total", route="live")
    out = eng.generate_batch(_prompts(), max_new_tokens=NEW)
    assert _counter("serving_program_calls_total", route="live") == live0
    assert _counter("serving_program_calls_total", route="aot") > aot0
    assert eng.close() == ([], [])
    jeng = JaxEngine(jm, **ENGINE)
    want = jeng.generate_batch([np.asarray(p) for p in _prompts()],
                               max_new_tokens=NEW)
    assert out == live_tokens == [list(map(int, w)) for w in want]


def test_retire_aot_serves_eagerly_with_the_same_tokens(pair, artifacts,
                                                        live_tokens):
    eng = LLMEngine(pair[1], **ENGINE)
    load_serving_artifacts(eng, artifacts[0], strict=True)
    assert eng.retire_aot(("prefill", 32)) == [("prefill", 32)]
    assert list(eng._aot_execs) == [("decode",)]
    assert eng.retire_aot() == [("decode",)]
    aot0 = _counter("serving_program_calls_total", route="aot")
    assert eng.generate_batch(_prompts(), max_new_tokens=NEW) == live_tokens
    assert _counter("serving_program_calls_total", route="aot") == aot0
    load_serving_artifacts(eng, artifacts[0], strict=True)
    assert eng.close() == ([], []) and eng._aot_execs == {}


def test_a_call_of_another_shape_falls_back(pair, artifacts, live_tokens):
    """An engine that runs more rows than the decode program was compiled
    for (R <= 4) refuses that package when it loads; installed anyway,
    the first step of 5 rows warns, drops it and runs eagerly."""
    eng = LLMEngine(pair[1], **dict(ENGINE, max_running=6))
    with pytest.warns(UserWarning, match="dim R reaches 4"):
        loaded = load_serving_artifacts(eng, artifacts[0])
    assert loaded == [("prefill", 32)]
    eng._aot_execs[("decode",)] = aot.AOTProgram(
        os.path.join(artifacts[0], "programs", "decode.pt2"),
        artifacts[1]["programs"]["decode"]["signature"])
    fb0 = _counter("serving_aot_fallback_total")
    with pytest.warns(UserWarning, match="falling back to the eager"):
        out = eng.generate_batch(_prompts(), max_new_tokens=NEW)
    assert out == live_tokens
    assert _counter("serving_aot_fallback_total") - fb0 == 1
    assert ("decode",) not in eng._aot_execs
    assert eng.close() == ([], [])


def _damage(src, dst, kind):
    shutil.copytree(src, dst)
    if kind == "flipped_byte":
        f = os.path.join(dst, "programs", "decode.pt2")
        data = bytearray(open(f, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(f, "wb").write(bytes(data))
        return "checksum mismatch"
    man = os.path.join(dst, aot._MANIFEST)
    m = json.load(open(man))
    m["stamp"]["torch"] = "0.0.0"
    json.dump(m, open(man, "w"))
    return "torch version mismatch"


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("kind", ["flipped_byte", "edited_stamp"])
def test_damaged_artifacts_are_refused_and_counted(pair, artifacts,
                                                   tmp_path, kind, strict):
    dst = str(tmp_path / "copy")
    why = _damage(artifacts[0], dst, kind)
    eng = LLMEngine(pair[1], **ENGINE)
    before = _counter("serving_aot_refused_total")
    if strict:
        with pytest.raises(AOTIncompatible, match=why):
            load_serving_artifacts(eng, dst, strict=True)
        assert _counter("serving_aot_refused_total") == before
        return
    with pytest.warns(UserWarning, match=why):
        loaded = load_serving_artifacts(eng, dst)
    # a flipped byte refuses its program; a stamp refuses the inventory
    assert loaded == ([("prefill", 32)] if kind == "flipped_byte" else [])
    assert _counter("serving_aot_refused_total") - before == 1


def test_worker_warm_starts_from_the_artifacts(artifacts, tmp_path):
    """A worker built from `gpt_spec(load_aot=)` on the tiny config loads
    both programs, reports it in its ready event, and serves the eager
    engine's tokens from them (its weights are generator seed 0's)."""
    spec = sw.gpt_spec(config=CFG, seed=0, engine=ENGINE, device="cpu",
                       load_aot=artifacts[0])
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    eng = LLMEngine(model.eval(), **ENGINE)
    want = eng.generate_batch(_prompts(1), max_new_tokens=NEW)
    h = sw.ProcReplica(spec, "aot0", str(tmp_path / "hb.aot0"),
                       policy=tr.TransportPolicy(timeout=DEADLINE_S,
                                                 retries=0))
    try:
        assert h.wait_ready(timeout=DEADLINE_S)
        assert h.ready_info["aot_loaded"] == 2
        reqs = [h.add_request(p, max_new_tokens=NEW) for p in _prompts(1)]
        t0 = time.monotonic()
        while any(r.finish_reason is None for r in reqs):
            assert time.monotonic() - t0 < DEADLINE_S, "the worker stalled"
            h.step()
            time.sleep(0.002)
        assert [r.generated for r in reqs] == want
        snap = h.metrics_snapshot()
        calls = {rec["labels"].get("route"): rec["value"] for rec in snap
                 if rec["name"] == "serving_program_calls_total"}
        assert calls.get("aot", 0) > 0 and "live" not in calls
        assert h.close() == ([], [])
    finally:
        h.abort()


def test_router_warm_starts_a_respawned_replica(pair, artifacts,
                                                live_tokens):
    warmed = []

    def warm(engine):
        warmed.append(load_serving_artifacts(engine, artifacts[0],
                                             strict=True))

    before = _counter("router_respawn_warm_start_total")
    with chaos.scoped("serving.replica_kill@3#r0"):
        router = Router(lambda: LLMEngine(pair[1], **ENGINE), replicas=2,
                        respawn=True, warm_start=warm,
                        backoff=backoff.Backoff(base=0.001, factor=2.0,
                                                max_delay=0.01))
        reqs = [router.submit(p, max_new_tokens=NEW) for p in _prompts()]
        router.run(max_steps=100_000)
    assert [rr.emitted for rr in reqs] == live_tokens
    assert len(warmed) == 3 and all(len(w) == 2 for w in warmed)
    assert _counter("router_respawn_warm_start_total") - before == 1
    assert all(s.handle.engine._aot_execs for s in router._slots)
    router.close()


def test_router_warm_start_failure_warns_and_serves(pair, live_tokens):
    def broken(engine):
        raise OSError("artifact store offline")

    with pytest.warns(UserWarning, match="warm start failed"):
        router = Router(lambda: LLMEngine(pair[1], **ENGINE), replicas=1,
                        warm_start=broken)
    reqs = [router.submit(p, max_new_tokens=NEW) for p in _prompts()]
    router.run(max_steps=100_000)
    assert [rr.emitted for rr in reqs] == live_tokens
    router.close()


# ===================================================================
# save_inference(aot=True)
# ===================================================================
ERNIE = dict(vocab_size=80, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=32, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)
ERNIE_SHAPE = (3, 16)


@pytest.fixture(scope="module")
def ernie(tmp_path_factory):
    """A tiny ERNIE classifier from JAX seed 0 in both packages, the
    port's exported with its AOT package, and the JAX one without."""
    pt.seed(0)
    jm = jernie.ErnieForSequenceClassification(jernie.ErnieConfig(**ERNIE))
    tm = ternie.ErnieForSequenceClassification(ternie.ErnieConfig(**ERNIE),
                                               device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v)
                               for k, v in jm.state_dict().items()})
    jm.eval()
    tm.eval()
    path = str(tmp_path_factory.mktemp("ernie_aot"))
    save_inference(tm, path, [InputSpec(ERNIE_SHAPE, "int64", "input_ids")],
                   aot=True)
    jpath = str(tmp_path_factory.mktemp("ernie_jax"))
    jax_save_load.save_inference(
        jm, jpath, [jax_save_load.InputSpec(ERNIE_SHAPE, "int64")])
    ids = np.random.default_rng(0).integers(
        0, ERNIE["vocab_size"], ERNIE_SHAPE).astype(np.int64)
    return path, jpath, ids


def test_ernie_aot_loads_and_matches_the_program_and_jax(ernie):
    path, jpath, ids = ernie
    meta = json.load(open(os.path.join(path, save_load._META)))
    assert meta["aot"]["platform"] == "cpu"
    assert os.path.exists(os.path.join(path, save_load._AOT))
    layer = load_inference(path, strict_aot=True)
    assert layer.is_aot
    got = layer(ids)
    portable = load_inference(path, prefer_aot=False)
    assert not portable.is_aot
    want = portable(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    jlayer = jax_save_load.load_inference(jpath, prefer_aot=False)
    ref = np.asarray(jlayer(pt.to_tensor(ids)).numpy())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_ernie_aot_none_dim_raises(ernie, tmp_path):
    tm = ternie.ErnieForSequenceClassification(ternie.ErnieConfig(**ERNIE),
                                               device="cpu")
    with pytest.raises(ValueError, match="concrete input shapes"):
        save_inference(tm, str(tmp_path),
                       [InputSpec([None, 16], "int64")], aot=True)


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("kind", ["flipped_byte", "edited_stamp",
                                  "missing"])
def test_ernie_damaged_package_is_refused(ernie, tmp_path, kind, strict):
    path, _, ids = ernie
    dst = str(tmp_path / "copy")
    shutil.copytree(path, dst)
    f = os.path.join(dst, save_load._AOT)
    if kind == "flipped_byte":
        data = bytearray(open(f, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(f, "wb").write(bytes(data))
        why = "checksum mismatch"
    elif kind == "edited_stamp":
        man = os.path.join(dst, save_load._META)
        meta = json.load(open(man))
        meta["aot"]["device_kind"] = "TPU v5 lite"
        json.dump(meta, open(man, "w"))
        why = "device kind mismatch"
    else:
        os.remove(f)
        why = "no AOT artifact"
    before = _counter("aot_artifact_refused_total")
    if strict:
        with pytest.raises(AOTIncompatible, match=why):
            load_inference(dst, strict_aot=True)
        return
    with pytest.warns(UserWarning, match=why):
        layer = load_inference(dst)
    assert not layer.is_aot
    assert _counter("aot_artifact_refused_total") - before == 1
    want = load_inference(path, prefer_aot=False)(ids)
    assert torch.equal(layer(ids), want)


def test_ernie_call_of_another_dtype_falls_back(ernie):
    """int32 ids: the package (compiled for int64) rejects the call, the
    layer warns once and runs the exported program, which takes them."""
    path, _, ids = ernie
    layer = load_inference(path)
    with pytest.warns(UserWarning, match="falling back to the exported"):
        got = layer(ids.astype(np.int32))
    assert not layer.is_aot
    want = load_inference(path, prefer_aot=False)(ids)
    assert torch.equal(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        layer(ids)                                      # no second warning
