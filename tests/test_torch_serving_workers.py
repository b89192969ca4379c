"""The port's worker processes against the JAX package, on the CPU.

`paddle_tpu_torch.serving.worker` (ProcReplica and the worker loop) on
the JAX drills' tiny GPT (vocab 64, hidden 32, 2 layers, 4 heads):

* the default build path: a worker built from `gpt_spec` holds the
  weights a parent builds from the same seed, and its greedy, resumed
  and sampled streams equal the in-process engine's; refusals come back
  as the engine's exceptions; `metrics_snapshot` and `close` cross the
  wire and `close` reaps; a worker that finds no card exits instead of
  serving on the CPU;
* `tools/torch_chaos_check.py --router --proc` on the JAX package's
  weights (seed 0, loaded in every worker through the spec's builder
  hook): the streams of all three phases equal the JAX in-process
  router's, the kill phase's counters equal it, no orphan survives, and
  the wedged worker falls only to SIGKILL.

Tolerances: tokens and counters exact.  Every wait has its own deadline
(no pytest-timeout here) and every spawned worker is reaped by its
fixture.
"""
import os
import signal
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.resilience import backoff as jax_backoff
from paddle_tpu.resilience import chaos as jax_chaos
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import Router as JaxRouter
from paddle_tpu.serving import ShedRequest as JaxShed
from paddle_tpu.serving import worker as jax_sw
from paddle_tpu.text import GPTConfig as JaxGPTConfig
from paddle_tpu.text import GPTForCausalLM as JaxGPT
from paddle_tpu.text.generation import generate as jax_generate
from paddle_tpu_torch.serving import LLMEngine, WorkerDied
from paddle_tpu_torch.serving import transport as tr
from paddle_tpu_torch.serving import worker as sw
from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.weights import load_paddle_tpu_state
from tools import torch_chaos_check as tcc

DEADLINE_S = 120.0


@pytest.fixture(scope="module")
def pair():
    """The JAX drills' GPT (seed 0) and the port's GPT on its weights."""
    pt.seed(0)
    jm = JaxGPT(JaxGPTConfig(tensor_parallel=False, **tcc.TINY))
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(**tcc.TINY), device="cpu")
    load_paddle_tpu_state(tm, arrays)
    return jm, tm.eval(), arrays


@pytest.fixture(scope="module")
def jax_router():
    """The JAX in-process router drill (all three phases), driven by the
    same drill code through the JAX package's classes."""
    pt.seed(0)
    jm = JaxGPT(JaxGPTConfig(tensor_parallel=False, **tcc.TINY))
    kit = types.SimpleNamespace(LLMEngine=JaxEngine, Router=JaxRouter,
                                ShedRequest=JaxShed,
                                Backoff=jax_backoff.Backoff,
                                chaos=jax_chaos,
                                registry=jax_metrics.registry)

    def reference(prompts, n):
        # bucketed (prompts padded to 16): token-identical to the plain
        # loop in the JAX package, and one compile instead of one a length
        return [jax_generate(jm, pt.to_tensor(np.asarray([p], "int64")),
                             max_new_tokens=n, shape_buckets=[16])
                .numpy()[0, len(p):].tolist() for p in prompts]
    res = tcc.run_router(jm, reference, kit=kit)
    assert res["failures"] == []
    return res


def _drive(handle, *reqs, budget_s=DEADLINE_S):
    t0 = time.monotonic()
    while any(r.finish_reason is None for r in reqs):
        assert time.monotonic() - t0 < budget_s, "the worker stalled"
        handle.step()
        time.sleep(0.002)


@pytest.fixture(scope="module")
def seeded():
    """The port's tiny GPT from generator seed 0: what a default
    `gpt_spec(config=TINY, seed=0, device="cpu")` worker builds."""
    return tcc._tiny_model("cpu")


@pytest.fixture(scope="module")
def proc_replica(tmp_path_factory):
    spec = sw.gpt_spec(config=tcc.TINY, seed=0, engine=tcc.TINY_ENGINE,
                       device="cpu")
    hbp = str(tmp_path_factory.mktemp("hb") / "hb.w0")
    h = sw.ProcReplica(spec, "w0", hbp,
                       policy=tr.TransportPolicy(timeout=DEADLINE_S,
                                                 retries=0))
    try:
        assert h.wait_ready(timeout=DEADLINE_S)
        yield h
    finally:
        h.abort()                    # the close test already reaped it


def test_worker_streams_match_the_in_process_engine(seeded, proc_replica):
    """The default build path (no builder): a worker's greedy stream, a
    failover-style continuation and a sampled resume equal the port's
    in-process engine on the same seeded weights."""
    eng = LLMEngine(seeded, **tcc.TINY_ENGINE)
    prompt, sp = [7, 3, 9, 1, 5], [11, 4, 2, 8]
    kw = dict(max_new_tokens=8, do_sample=True, temperature=0.9, top_k=20,
              seed=42)
    local = eng.add_request(prompt, max_new_tokens=8)
    local_s = eng.add_request(sp, **kw)
    eng.run()
    toks = []
    rq = proc_replica.add_request(prompt, max_new_tokens=8,
                                  on_token=lambda r, t: toks.append(t))
    rq2 = proc_replica.add_request(prompt, max_new_tokens=8,
                                   resume_tokens=local.generated[:3])
    rq3 = proc_replica.add_request(sp, resume_tokens=local_s.generated[:4],
                                   **kw)
    _drive(proc_replica, rq, rq2, rq3)
    assert rq.generated == toks == local.generated
    assert rq.finish_reason == "length"
    assert rq2.generated == local.generated
    assert rq3.generated == local_s.generated
    eng.close()


def test_worker_refusals_come_back_as_engine_exceptions(proc_replica):
    with pytest.raises(ValueError, match="nothing left"):
        proc_replica.add_request([1, 2, 3], max_new_tokens=4,
                                 resume_tokens=[5, 6, 7, 8])
    with pytest.raises(ValueError, match="max_model_len"):
        proc_replica.add_request([1] * 60, max_new_tokens=10)


def test_worker_metrics_snapshot_rpc(proc_replica):
    snap = proc_replica.metrics_snapshot()
    tok = sum(rec.get("value", 0) for rec in snap
              if rec["name"] == "serving_tokens_generated_total")
    assert tok >= 8         # the parity streams ran in THIS worker


def test_worker_close_reports_leaks_and_reaps(proc_replica):
    pid = proc_replica.proc.pid
    assert proc_replica.close() == ([], [])
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)     # dead AND reaped


def test_worker_without_a_card_exits_instead_of_serving(tmp_path,
                                                        monkeypatch):
    """A spec that names no device means the card; a worker that finds
    none raises and exits non-zero; it never serves on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setattr(sw, "_build_kernels", lambda spec: None)
    spec = sw.gpt_spec(config=tcc.TINY, engine=tcc.TINY_ENGINE)
    h = sw.ProcReplica(spec, "nocard", str(tmp_path / "hb"),
                       policy=tr.TransportPolicy(timeout=DEADLINE_S,
                                                 retries=0))
    try:
        with pytest.raises(WorkerDied, match="exit:1"):
            h.wait_ready(timeout=DEADLINE_S)
    finally:
        h.abort()
    assert h.proc.returncode == 1


def test_left_out_options_raise_and_name_their_item():
    """Nothing of the spec is left out any more: `lazy=True` goes into
    the spec as the JAX package writes it and builds the model under
    LazyGuard (`test_torch_lazy.py` holds its weights to the eager
    build's), and `load_aot` is ported (a worker loading artifacts:
    `test_torch_aot.py`) and goes into the spec as the JAX one does."""
    spec = sw.gpt_spec(config=tcc.TINY, load_aot="/nowhere")
    assert spec["load_aot"] == jax_sw.gpt_spec(
        config=tcc.TINY, load_aot="/nowhere")["load_aot"]
    lazy = sw.gpt_spec(config=tcc.TINY, lazy=True)
    assert lazy["model"] == jax_sw.gpt_spec(config=tcc.TINY,
                                            lazy=True)["model"]
    model = sw.build_gpt({"model": {"config": tcc.TINY, "lazy": True},
                          "device": "cpu"})
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_describe_exit_matches_jax():
    for rc in (None, 0, 1, 143, -signal.SIGKILL, -signal.SIGSEGV,
               -signal.SIGTERM, -200):
        assert sw.describe_exit(rc) == jax_sw.describe_exit(rc)


@pytest.fixture(scope="module")
def proc_drill(pair, jax_router, tmp_path_factory):
    """The --router --proc drill on the JAX weights: every worker loads
    them through the builder hook; the streams must equal the JAX
    in-process router's."""
    _, tm, arrays = pair
    path = tmp_path_factory.mktemp("weights") / "gpt.npz"
    np.savez(path, **arrays)
    prompts = tcc.drill_prompts(11, tcc.ROUTER_LENS)
    spec = tcc.drill_spec(device="cpu", config=tcc.TINY,
                          engine=tcc.TINY_ENGINE, arrays=path,
                          step_delay_s=0.01)
    jax_streams = jax_router["kill"]["streams"]
    return tcc.run_router_proc(spec, prompts, jax_streams,
                               tcc.probe_digest(tm)), jax_streams


def test_proc_drill_is_green(proc_drill):
    res, _ = proc_drill
    assert res["failures"] == []
    assert res["spawns"] == 8       # 2 + 2 respawns, then 2 and 2


@pytest.mark.parametrize("phase", ["kill", "drop", "wedge"])
def test_proc_drill_streams_match_the_jax_router(proc_drill, phase):
    res, jax_streams = proc_drill
    assert res["phases"][phase]["streams"] == jax_streams


def test_proc_drill_kill_counts(proc_drill, jax_router):
    res, _ = proc_drill
    kill = res["phases"]["kill"]
    assert kill["sigkill_exits"] == 3
    c, j = kill["counts"], jax_router["kill"]["counts"]
    keys = ("evicted_crash", "router_respawns_total",
            "router_crash_loop_aborts_total")
    assert tuple(c[k] for k in keys) == tuple(j[k] for k in keys) == \
        (3, 2, 1)
    assert c["router_failover_dedup_total"] >= 1
    assert c["router_failover_token_mismatch_total"] == 0


def test_proc_drill_wedged_worker_needs_the_kill(proc_drill):
    res, _ = proc_drill
    wedge, drop = res["phases"]["wedge"], res["phases"]["drop"]
    assert wedge["counts"]["evicted_hang"] == 1
    assert wedge["counts"]["evicted_crash"] == 0
    assert wedge["sigkill_exits"] == 1       # TERM was not enough
    assert drop["frame_errors"] >= 1 and drop["counts"]["evicted_crash"] \
        == 1
