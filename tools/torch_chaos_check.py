#!/usr/bin/env python3
"""Chaos drills of the port's serving tier (paddle_tpu_torch.serving).

    python tools/torch_chaos_check.py --serving [--device cpu] [-v]
    python tools/torch_chaos_check.py --router [--device cpu] [-v]
    python tools/torch_chaos_check.py --router --proc [--device cpu] [-v]

Counterpart: the --serving, --router and --router --proc drills of
`tools/chaos_check.py`, on the same tiny GPT (vocab 64, hidden 32, 2
layers, 4 heads), the same prompts and the same chaos specs.  The model
is built on --device (default cuda; a run without a card fails) from a
generator seeded with 0; each drill prints one OK / FAILED line and exits
0 when green.

* --serving: a 7-block pool under 8 requests, 3 injected exhaustions
  (`serving.pool_exhausted`) and one poisoned request
  (`serving.request_poison`): preemption and resume keep every survivor
  token-identical to sequential `generate()`, the poisoned request fails
  alone ("error"), no block leaks.
* --router: an in-process 2-replica Router.  `serving.replica_kill`
  kills r0 three times mid-stream (failover re-prefill with the overlap
  dedup, two backoff respawns, then the crash-loop abandon); a burst
  against the survivor's queue watermark splits into structured
  refusals and completions; `serving.replica_hang` wedges r0 and the
  stale beat evicts it as a hang.  Streams byte-identical throughout.
* --router --proc: the same with worker processes (ProcReplica): three
  real SIGKILLs mid-stream, one `serving.transport_drop`, and one
  worker wedged by the `_wedge` hook (stops beating, ignores SIGTERM),
  which only the KILL escalation clears.  No orphan process after any
  phase.

The drill functions are the one copy of the drills: the tool,
`tests/test_torch_serving_tier.py` and `chip_smoke.py` (router_drill, at
GPT-3 1.3B width in float32 on the card) all call them.  Each returns a
dict whose "failures" list is empty when the drill is green.  `run_serving`
and `run_router` take a `kit` of the package they drive (`port_kit()`
by default), so the tests run the very same steps through the JAX
package beside the port.  `build_engine` is the worker-side builder the
proc drill and chip_smoke hand the workers (the spec's "builder" hook):
it builds the spec's GPT (optionally loading `spec["arrays"]`, an .npz of
the JAX package's state dict), warms the engine up, then zeroes the
kernel launch counters and the worker's metrics, and reports launch
counts, peak device memory, build and first-step seconds and a digest of
a probe forward's logits through `metrics_snapshot()`.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import signal
import sys
import time
import types

import numpy as np
import torch

if __name__ == "__main__":   # run as a script: the repo root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from paddle_tpu_torch import ops  # noqa: E402
from paddle_tpu_torch.serving import LLMEngine  # noqa: E402

# the JAX drills' tiny GPT (tools/chaos_check.py:876-880)
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)
SERVING_LENS = (9, 5, 12, 7, 4, 10, 6, 8)     # RandomState(7)
ROUTER_LENS = (9, 5, 12, 7, 4, 10)            # RandomState(11)
TINY_ENGINE = dict(num_blocks=24, block_size=4, max_running=8,
                   prefill_chunk=16)
BUILDER = "tools.torch_chaos_check:build_engine"
PROC_BUDGET_S = 480.0     # the JAX proc drill's wall-clock guard
PROBE_TOKENS = 8


def drill_prompts(seed, lens, vocab=64):
    """The drills' prompts: `np.random.RandomState(seed)`, one draw of
    randint(0, vocab) per length, as the JAX drills draw them."""
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, size=n).tolist() for n in lens]


def port_kit():
    """The pieces of the port a drill drives."""
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.resilience.backoff import Backoff
    from paddle_tpu_torch.serving import Router, ShedRequest
    return types.SimpleNamespace(LLMEngine=LLMEngine, Router=Router,
                                 ShedRequest=ShedRequest, Backoff=Backoff,
                                 chaos=chaos, registry=metrics.registry)


def port_reference(model):
    """reference(prompts, n): sequential greedy `generate()` of the port,
    one prompt at a time (the JAX drills' reference)."""
    from paddle_tpu_torch.text.generation import generate
    device = next(model.parameters()).device

    def reference(prompts, n):
        return [generate(model, torch.tensor([p], device=device),
                         max_new_tokens=n)[0, len(p):].tolist()
                for p in prompts]
    return reference


def _report(name, failures, ok_line, out):
    if failures:
        print(f"torch_chaos_check {name} FAILED:", file=out)
        for f in failures:
            print(f"  - {f}", file=out)
        return 1
    print(f"torch_chaos_check {name} OK: {ok_line}", file=out)
    return 0


# ================================================================ --serving
def run_serving(model, reference, kit=None):
    """The serving overload drill on `model` (the tiny GPT of `kit`'s
    package).  Returns {"failures", "streams", "finish", "poisoned",
    "counters", "leaks", "free_blocks"}."""
    kit = kit or port_kit()
    reg = kit.registry()
    prompts = drill_prompts(7, SERVING_LENS)
    new_tokens = 8
    refs = reference(prompts, new_tokens)
    names = {"preempted": "serving_requests_preempted_total",
             "exhausted": "serving_pool_exhausted_total",
             "failed": "serving_requests_failed_total"}
    base = {k: reg.counter(n).value for k, n in names.items()}
    # 7 blocks of 4 tokens for 8 requests of 2-5 blocks each: a real
    # overload; the spec adds 3 refusals mid-run and poisons the 3rd
    # request submitted
    with kit.chaos.scoped("serving.pool_exhausted@6*3;"
                          "serving.request_poison@3"):
        eng = kit.LLMEngine(model, num_blocks=7, block_size=4,
                            max_running=8, prefill_chunk=16)
        reqs = [eng.add_request(p, max_new_tokens=new_tokens)
                for p in prompts]
        eng.run(max_steps=10_000)
    counters = {k: reg.counter(n).value - base[k] for k, n in names.items()}
    failures = []
    poisoned = [i for i, r in enumerate(reqs) if r.poisoned]
    if poisoned != [2]:
        failures.append(f"expected exactly request #2 poisoned, got "
                        f"{poisoned}")
    for i, (req, ref) in enumerate(zip(reqs, refs)):
        if req.poisoned:
            if req.finish_reason != "error":
                failures.append(f"poisoned request {i} finished "
                                f"{req.finish_reason!r}, expected 'error'")
            continue
        if req.finish_reason not in ("eos", "length"):
            failures.append(f"request {i} ended {req.finish_reason!r}")
        if list(req.generated) != ref:
            failures.append(f"request {i} tokens diverged after "
                            f"{req.preemptions} preemption(s): "
                            f"{req.generated} vs sequential {ref}")
    if counters["preempted"] < 1:
        failures.append("overload never triggered a preemption")
    if counters["exhausted"] < 3:
        failures.append(f"injected pool exhaustion did not fire 3 times "
                        f"(saw {counters['exhausted']})")
    if counters["failed"] != 1:
        failures.append(f"expected exactly 1 failed (poisoned) request, "
                        f"counters saw {counters['failed']}")
    leaks = eng.pool.check_leaks()
    if leaks[0] or leaks[1]:
        failures.append(f"block pool leaked: refcount>0 {leaks[0]}, "
                        f"refcount<0 {leaks[1]}")
    if eng.pool.free_blocks != eng.pool.num_blocks:
        failures.append(f"free list short after the run: "
                        f"{eng.pool.free_blocks}/{eng.pool.num_blocks}")
    return {"failures": failures,
            "streams": [list(r.generated) for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "poisoned": poisoned, "counters": counters,
            "leaks": (list(leaks[0]), list(leaks[1])),
            "free_blocks": eng.pool.free_blocks}


# ================================================================= --router
ROUTER_COUNTERS = ("router_failover_requests_total",
                   "router_failover_dedup_total",
                   "router_failover_token_mismatch_total",
                   "router_respawns_total", "router_crash_loop_aborts_total")


def _counts(reg):
    """The router counters the drills read, evictions by cause."""
    out = {n: reg.counter(n).value for n in ROUTER_COUNTERS}
    for cause in ("crash", "hang"):
        out[f"evicted_{cause}"] = reg.counter(
            "router_replica_evicted_total", cause=cause).value
    return out


def _delta(reg, base):
    now = _counts(reg)
    return {k: now[k] - base[k] for k in now}


def _check_streams(tag, reqs, refs, failures):
    for i, (rr, ref) in enumerate(zip(reqs, refs)):
        if rr.state != "finished":
            failures.append(f"{tag}: request {i} ended "
                            f"{rr.state}/{rr.finish_reason!r}")
        elif rr.emitted != ref:
            failures.append(f"{tag}: request {i} stream diverged after "
                            f"{rr.failovers} failover(s): {rr.emitted} "
                            f"vs reference {ref}")


def _check_kill_counts(tag, d, failures):
    if d["router_failover_requests_total"] < 1:
        failures.append(f"{tag}: no request ever failed over")
    if d["router_failover_dedup_total"] < 1:
        failures.append(f"{tag}: failover dedup never fired (no stream "
                        f"was killed mid-token)")
    if d["router_failover_token_mismatch_total"]:
        failures.append(f"{tag}: "
                        f"{d['router_failover_token_mismatch_total']} "
                        f"failover overlap token(s) mismatched")
    got = (d["evicted_crash"], d["router_respawns_total"],
           d["router_crash_loop_aborts_total"])
    if got != (3, 2, 1):
        failures.append(f"{tag}: evictions/respawns/aborts = "
                        f"{'/'.join(map(str, got))}, want 3/2/1")


def _check_leaks(tag, leaks, failures):
    for name, (leaked, bad) in leaks.items():
        # strict == []: ProcReplica.close() reports (None, None) when the
        # worker could not answer, which is unknown, not clean
        if leaked != [] or bad != []:
            failures.append(f"{tag}: survivor {name} leak report "
                            f"{leaked!r}/{bad!r}, want []/[]")


def run_router(model, reference, kit=None):
    """The in-process router drill on `model` (three phases, see the
    module note).  Returns {"failures", "kill", "shed", "hang"}: each
    phase's "streams" and counter deltas ("counts"), the shed phase's
    refusals, the hang phase's eviction events."""
    kit = kit or port_kit()
    reg = kit.registry()
    prompts = drill_prompts(11, ROUTER_LENS)
    new_tokens = 16
    refs = reference(prompts, new_tokens)
    failures = []

    def factory():
        return kit.LLMEngine(model, shed_queue_depth=3, **TINY_ENGINE)

    # ---- phase 1: kill r0 three times -> failover + crash-loop abandon
    base = _counts(reg)
    with kit.chaos.scoped("serving.replica_kill@4#r0;"
                          "serving.replica_kill@6#r0;"
                          "serving.replica_kill@8#r0"):
        router = kit.Router(factory, replicas=2, heartbeat_timeout=5.0,
                            respawn=True,
                            backoff=kit.Backoff(base=0.001, factor=2.0,
                                                max_delay=0.01),
                            crash_loop_threshold=3, crash_loop_window=60.0)
        reqs = [router.submit(p, max_new_tokens=new_tokens)
                for p in prompts]
        router.run(max_steps=100_000)
    kill = _delta(reg, base)
    _check_streams("kill", reqs, refs, failures)
    _check_kill_counts("kill", kill, failures)
    states = {s.name: s.state for s in router._slots}
    if states.get("r0") != "abandoned":
        failures.append(f"kill: r0 is {states.get('r0')!r} after 3 "
                        f"crashes, want 'abandoned'")

    # ---- phase 2: a burst against the survivor's queue watermark
    base_shed = reg.counter("serving_requests_shed_total",
                            reason="queue_depth").value
    admitted, shed = [], []
    for i in range(10):
        try:
            admitted.append(router.submit(prompts[i % len(prompts)],
                                          max_new_tokens=4))
        except kit.ShedRequest as e:
            shed.append(e)
    router.run(max_steps=100_000)
    if not shed:
        failures.append("shed: the burst was never refused")
    for e in shed:
        if e.reason != "queue_depth" or "queue_depth" not in e.detail:
            failures.append(f"shed: refusal not structured: "
                            f"reason={e.reason!r} detail={e.detail}")
            break
    d_shed = reg.counter("serving_requests_shed_total",
                         reason="queue_depth").value - base_shed
    if d_shed != len(shed):
        failures.append(f"shed: counter saw {d_shed} refusals, the router "
                        f"raised {len(shed)}")
    for i, rr in enumerate(admitted):
        if rr.state != "finished":
            failures.append(f"shed: admitted request {i} ended "
                            f"{rr.state}/{rr.finish_reason!r}")
    _check_leaks("shed", router.close(), failures)

    # ---- phase 3: hang -> stale heartbeat -> evict within the timeout
    hb_timeout = 0.3
    base = _counts(reg)
    with kit.chaos.scoped("serving.replica_hang@3#r0"):
        router2 = kit.Router(factory, replicas=2,
                             heartbeat_timeout=hb_timeout, respawn=False)
        reqs2 = [router2.submit(p, max_new_tokens=new_tokens)
                 for p in prompts[:4]]
        router2.run(max_steps=1_000_000)
    hang = _delta(reg, base)
    evicts = [e for e in router2.events if e["event"] == "evict"]
    hangs = [e for e in evicts if e["cause"] == "hang"]
    if len(hangs) != 1 or len(evicts) != 1:
        failures.append(f"hang: evictions {[e['cause'] for e in evicts]}, "
                        f"want exactly one hang")
    elif hangs[0]["silent_for"] > hb_timeout + 1.0:
        failures.append(f"hang: evicted after {hangs[0]['silent_for']}s "
                        f"of silence, timeout {hb_timeout}s (+1s slack)")
    _check_streams("hang", reqs2, refs[:4], failures)
    _check_leaks("hang", router2.close(), failures)
    return {"failures": failures,
            "kill": {"streams": [rr.emitted for rr in reqs],
                     "failovers": [rr.failovers for rr in reqs],
                     "counts": kill, "states": states},
            "shed": {"admitted": len(admitted),
                     "refused": [(e.reason, dict(e.detail)) for e in shed],
                     "streams": [rr.emitted for rr in admitted]},
            "hang": {"streams": [rr.emitted for rr in reqs2],
                     "counts": hang,
                     "evictions": [e["cause"] for e in evicts],
                     "silent_for": [e["silent_for"] for e in hangs]}}


# ========================================================== worker builder
class ReportingEngine(LLMEngine):
    """An LLMEngine whose `metrics_snapshot()` also carries the worker
    process's kernel launch counters (`serving_kernel_launches{counter}`,
    as `ops.launch_counts()` names them) and peak device memory: the
    parent cannot read another process's counters, and the snapshot is
    the protocol's own way out."""

    def metrics_snapshot(self, prefix="serving_"):
        for name, n in ops.launch_counts().items():
            self._reg.gauge("serving_kernel_launches", counter=name).set(n)
        if self.device.type == "cuda":
            self._reg.gauge("serving_peak_memory_bytes").set(
                torch.cuda.max_memory_allocated(self.device))
        return super().metrics_snapshot(prefix)


def probe_digest(model):
    """sha256 of the float32 logits of one dense forward over a fixed
    probe (tokens 0, 7, 14, ... mod vocab): equal digests mean the two
    models' weights gave the same first logits bit for bit."""
    vocab = model.cfg.vocab_size
    device = next(model.parameters()).device
    ids = (torch.arange(PROBE_TOKENS, device=device) * 7 % vocab)[None]
    with torch.no_grad():
        logits = model(ids).float().cpu().numpy()
    return hashlib.sha256(logits.tobytes()).hexdigest()


def build_engine(spec):
    """Worker-side builder (``spec["builder"] = BUILDER``): the spec's
    GPT, with `spec["arrays"]` loaded when given, in a ReportingEngine,
    warmed up by one short request; then every launch counter and the
    worker's metrics start from zero, and the snapshot reports
    `serving_build_seconds`, `serving_first_step_seconds` (the warm-up:
    the fresh process's first engine steps) and
    `serving_probe_logits{sha256}`."""
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving.worker import build_gpt
    from paddle_tpu_torch.weights import load_paddle_tpu_state

    t0 = time.perf_counter()
    model = build_gpt(spec)
    if spec.get("arrays"):
        with np.load(spec["arrays"]) as arrays:
            load_paddle_tpu_state(model, dict(arrays))
    model.eval()
    digest = probe_digest(model)
    eng = ReportingEngine(model, **(spec.get("engine") or {}))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.generate_batch([[1, 2, 3, 4]], max_new_tokens=2)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
        torch.cuda.reset_peak_memory_stats(eng.device)
    first_s = time.perf_counter() - t0
    ops.add_launch_counts({k: -v for k, v in ops.launch_counts().items()})
    reg = metrics.registry()
    reg.reset()
    reg.gauge("serving_build_seconds").set(build_s)
    reg.gauge("serving_first_step_seconds").set(first_s)
    reg.gauge("serving_probe_logits", sha256=digest).set(1)
    return eng


def drill_spec(device=None, dtype="float32", engine=None, config=None,
               preset=None, overrides=None, seed=0, arrays=None,
               step_delay_s=0.0):
    """A `worker.gpt_spec` that builds through `build_engine`."""
    from paddle_tpu_torch.serving.worker import gpt_spec
    spec = gpt_spec(config=config, preset=preset, overrides=overrides,
                    seed=seed, engine=engine, step_delay_s=step_delay_s,
                    device=device, dtype=dtype)
    spec["builder"] = BUILDER
    if arrays is not None:
        spec["arrays"] = str(arrays)
    return spec


def worker_report(records):
    """What a ReportingEngine snapshot says: {"launches": {counter: n},
    "probe_sha256", every unlabelled counter and gauge by name, and every
    unlabelled histogram as {"count", "p50", "p99"}}."""
    out = {"launches": {}}
    for rec in records:
        name, labels = rec["name"], rec["labels"]
        if name == "serving_kernel_launches":
            out["launches"][labels["counter"]] = rec["value"]
        elif name == "serving_probe_logits":
            out["probe_sha256"] = labels["sha256"]
        elif labels:
            continue
        elif rec["type"] == "histogram":
            out[name] = {k: rec.get(k) for k in ("count", "p50", "p99")}
        else:
            out[name] = rec["value"]
    return out


def min_top2_margin(model, prompts, streams):
    """The smallest gap between the largest and the second largest logit
    over every generated position of `streams`, from one dense
    teacher-forced forward per prompt: how close a stream came to an
    argmax that rounding could flip."""
    device = next(model.parameters()).device
    worst = float("inf")
    for prompt, gen in zip(prompts, streams):
        ids = torch.tensor([prompt + gen[:-1]], device=device)
        with torch.no_grad():
            logits = model(ids)[0, len(prompt) - 1:].float()
        top = logits.topk(2, dim=-1).values
        worst = min(worst, float((top[:, 0] - top[:, 1]).min()))
    return worst


# ========================================================== --router --proc
def ready_times(router, timeout):
    """({replica: seconds from now until its worker reported ready},
    [replicas still not ready after `timeout`]), each healthy worker
    polled in turn."""
    t0 = time.monotonic()
    pending = {s.name: s.handle for s in router._slots
               if s.state == "healthy"}
    ready = {}
    while pending and time.monotonic() - t0 < timeout:
        for name, h in list(pending.items()):
            if h.wait_ready(timeout=0.02):
                ready[name] = time.monotonic() - t0
                del pending[name]
    return ready, sorted(pending)


def live_pids(pids):
    """The pids that are still alive or not yet reaped (a zombie answers
    signal 0): after close(), any of them is an orphan."""
    out = []
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        out.append(pid)
    return out


def run_router_proc(spec, prompts, refs, expect_digest,
                    spawn_grace_s=120.0):
    """The process-per-replica drill: worker processes built from `spec`
    (use `drill_spec`) serve `prompts`; every stream must equal `refs`
    (as many tokens each as `refs[0]` holds).

    1. kill: r0 is SIGKILLed mid-stream, respawned, killed twice more
       (the third death abandons it): evictions / respawns / aborts
       3 / 2 / 1, every death a SIGKILL exit, overlap dedup, no mismatch.
    2. drop: `serving.transport_drop@12#r0` tears a frame on r0's
       channel: a counted frame error and a crash eviction.
    3. wedge: r0 gets the `_wedge` command mid-stream: one hang eviction
       (the heartbeat timeout is 4x the slowest first step the workers
       reported in phase 1, at least 3 s), and the worker, which ignores
       SIGTERM, exits by SIGKILL.

    The kill and drop phases keep the JAX drill's heartbeat timeout
    (8 s); `spawn_grace_s` covers a worker's start.  Each phase ends with
    leak reports []/[] from the survivors and no live worker pid.
    `expect_digest` (a `probe_digest` of the parent's model) must equal
    every worker's.  Returns {"failures", "phases": {kill, drop, wedge},
    "spawn_to_ready_s", "spawns", "seconds"}: each phase's streams,
    counter deltas and the survivors' `worker_report`s."""
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.resilience.backoff import Backoff
    from paddle_tpu_torch.serving import Router
    from paddle_tpu_torch.serving import worker as sw
    from paddle_tpu_torch.serving.transport import TransportPolicy

    t_start = time.monotonic()
    new_tokens = len(refs[0])
    heartbeat_timeout = 8.0
    reg = metrics.registry()
    failures, handles, phases = [], [], {}
    reports = []           # every worker_report read, for the digests
    pol = TransportPolicy(timeout=60.0, retries=1, backoff_base=0.05)

    def factory(name, hb_path, respawning=False):
        h = sw.ProcReplica(spec, name, hb_path, policy=pol)
        handles.append(h)
        return h

    def exits(sig):
        return reg.counter("router_worker_exits_total", signal=sig).value

    def no_orphans(tag):
        for pid in live_pids([h.proc.pid for h in handles]):
            failures.append(f"{tag}: worker pid {pid} outlived close(): "
                            f"an orphan")

    def wait_all_ready(router, timeout=600.0):
        ready, pending = ready_times(router, timeout)
        if pending:
            failures.append(f"workers {pending} not ready after "
                            f"{timeout}s")
        return ready

    def survivors(router):
        snap = router.metrics_snapshot()
        out = {name: worker_report(recs) for name, recs in snap.items()}
        reports.extend(out.values())
        return out

    def drive(router, reqs, timeout, on_step=None):
        deadline = time.monotonic() + timeout
        while router.has_work and time.monotonic() < deadline:
            router.step()
            if on_step is not None:
                on_step()
        if router.has_work:
            failures.append(f"streams still live after {timeout}s")

    spawn_to_ready = {}
    try:
        # ---- phase 1: kill -9 x3 -> failover, respawn, abandon -------
        base = _counts(reg)
        base_kill9 = exits("SIGKILL")
        t0 = time.monotonic()
        router = Router(None, replicas=2,
                        heartbeat_timeout=heartbeat_timeout,
                        spawn_grace_s=spawn_grace_s, respawn=True,
                        backoff=Backoff(base=0.05, factor=2.0,
                                        max_delay=0.2),
                        crash_loop_threshold=3, crash_loop_window=600.0,
                        replica_factory=factory)
        spawn_s = time.monotonic() - t0
        spawn_to_ready = {k: v + spawn_s
                          for k, v in wait_all_ready(router).items()}
        first = survivors(router)
        reqs = [router.submit(p, max_new_tokens=new_tokens)
                for p in prompts]
        killed = set()          # pids SIGKILLed: one kill per worker

        def kill_r0():
            slot0 = router._slots[0]
            if len(killed) >= 3 or slot0.state != "healthy" \
                    or not slot0.handle.ready \
                    or slot0.handle.proc.pid in killed:
                return
            live0 = [rr for rr in router._requests
                     if rr.state == "live" and rr.slot is slot0]
            # the FIRST kill lands mid-stream; later ones take the
            # respawned worker as soon as it is up, streams or not
            # (pid-gated: a SIGKILL lands asynchronously)
            if killed or any(len(rr.emitted) >= 2 for rr in live0):
                os.kill(slot0.handle.proc.pid, signal.SIGKILL)
                killed.add(slot0.handle.proc.pid)

        deadline = time.monotonic() + 600.0
        while time.monotonic() < deadline:
            router.step()
            kill_r0()
            if not router.has_work and len(killed) >= 3 \
                    and router._slots[0].state in ("abandoned", "dead"):
                break
        d = _delta(reg, base)
        n_kill9 = exits("SIGKILL") - base_kill9
        _check_streams("kill", reqs, refs, failures)
        _check_kill_counts("kill", d, failures)
        if len(killed) != 3:
            failures.append(f"kill: delivered {len(killed)}/3 SIGKILLs")
        if n_kill9 != 3:
            failures.append(f"kill: router_worker_exits_total"
                            f"{{signal=SIGKILL}} +{n_kill9}, want +3")
        if router._slots[0].state != "abandoned":
            failures.append(f"kill: r0 is {router._slots[0].state!r}, "
                            f"want 'abandoned'")
        last = survivors(router)
        if not any("serving_tokens_generated_total" in r
                   for r in last.values()):
            failures.append("kill: the survivor's metrics_snapshot held "
                            "no serving counters")
        _check_leaks("kill", router.close(), failures)
        no_orphans("kill")
        phases["kill"] = {"seconds": time.monotonic() - t0,
                          "streams": [rr.emitted for rr in reqs],
                          "failovers": [rr.failovers for rr in reqs],
                          "counts": d, "sigkill_exits": n_kill9,
                          "first": first, "survivors": last}
        firsts = [r.get("serving_first_step_seconds", 0.0)
                  for r in first.values()]
        hang_timeout = max(3.0, 4.0 * max(firsts, default=0.0))

        # ---- phase 2: a frame dropped in transit -> evict + failover --
        t0 = time.monotonic()
        base = _counts(reg)
        base_fe = reg.counter("router_transport_frame_errors_total").value
        # the 12th frame on r0's parent side: past ready and the
        # add_request replies, inside the token stream
        with chaos.scoped("serving.transport_drop@12#r0"):
            router2 = Router(None, replicas=2,
                             heartbeat_timeout=heartbeat_timeout,
                             spawn_grace_s=spawn_grace_s, respawn=False,
                             replica_factory=factory)
            wait_all_ready(router2)
            reqs2 = [router2.submit(p, max_new_tokens=new_tokens)
                     for p in prompts]
            drive(router2, reqs2, 600.0)
        d2 = _delta(reg, base)
        n_fe = reg.counter("router_transport_frame_errors_total").value \
            - base_fe
        drops = [e for e in router2.events
                 if e["event"] == "evict" and e["cause"] == "crash"
                 and "transport_drop" in str(e.get("error"))]
        if n_fe < 1 or len(drops) != 1:
            failures.append(f"drop: frame errors +{n_fe}, transport-drop "
                            f"evictions {len(drops)}, want >= 1 and 1")
        _check_streams("drop", reqs2, refs, failures)
        last2 = survivors(router2)
        _check_leaks("drop", router2.close(), failures)
        no_orphans("drop")
        phases["drop"] = {"seconds": time.monotonic() - t0,
                          "streams": [rr.emitted for rr in reqs2],
                          "counts": d2, "frame_errors": n_fe,
                          "survivors": last2}

        # ---- phase 3: a wedged worker -> hang eviction -> KILL --------
        t0 = time.monotonic()
        base = _counts(reg)
        base_kill9 = exits("SIGKILL")
        router3 = Router(None, replicas=2, heartbeat_timeout=hang_timeout,
                         spawn_grace_s=spawn_grace_s, respawn=False,
                         replica_factory=factory)
        wait_all_ready(router3)
        reqs3 = [router3.submit(p, max_new_tokens=new_tokens)
                 for p in prompts]
        wedged = []

        def wedge_r0():
            slot0 = router3._slots[0]
            if wedged or slot0.state != "healthy":
                return
            if any(rr.state == "live" and rr.slot is slot0
                   and len(rr.emitted) >= 2 for rr in router3._requests):
                slot0.handle.ch.send({"cmd": "_wedge"})
                wedged.append(slot0.handle)

        drive(router3, reqs3, 600.0, on_step=wedge_r0)
        d3 = _delta(reg, base)
        evicts = [e for e in router3.events if e["event"] == "evict"]
        if not wedged:
            failures.append("wedge: no r0 stream was live to wedge")
        elif [e["cause"] for e in evicts] != ["hang"]:
            failures.append(f"wedge: evictions "
                            f"{[e['cause'] for e in evicts]}, want one "
                            f"hang")
        else:
            rc = wedged[0].proc.returncode
            if rc != -signal.SIGKILL:
                failures.append(f"wedge: the wedged worker exited "
                                f"{sw.describe_exit(rc)}, want SIGKILL "
                                f"(it ignores SIGTERM)")
            if evicts[0]["silent_for"] > hang_timeout + 2.0:
                failures.append(f"wedge: evicted after "
                                f"{evicts[0]['silent_for']}s of silence, "
                                f"timeout {hang_timeout}s (+2s slack)")
        _check_streams("wedge", reqs3, refs, failures)
        last3 = survivors(router3)
        _check_leaks("wedge", router3.close(), failures)
        no_orphans("wedge")
        phases["wedge"] = {
            "seconds": time.monotonic() - t0,
            "streams": [rr.emitted for rr in reqs3], "counts": d3,
            "hang_timeout_s": hang_timeout,
            "silent_for_s": [e["silent_for"] for e in evicts],
            "sigkill_exits": exits("SIGKILL") - base_kill9,
            "survivors": last3}
    finally:
        chaos.uninstall()
        # a failed drill must not leave workers behind either
        for h in handles:
            if h.proc.poll() is None:
                h.abort()

    if expect_digest is not None:
        bad = sorted({r.get("probe_sha256") for r in reports}
                     - {expect_digest})
        if bad:
            failures.append(f"worker probe logits {bad} differ from the "
                            f"parent's {expect_digest}: the weights are "
                            f"not the same bit for bit")
    elapsed = time.monotonic() - t_start
    if elapsed > PROC_BUDGET_S:
        failures.append(f"time budget: {elapsed:.0f}s > "
                        f"{PROC_BUDGET_S:.0f}s")
    return {"failures": failures, "phases": phases,
            "spawn_to_ready_s": spawn_to_ready, "spawns": len(handles),
            "seconds": elapsed}


# ==================================================================== CLI
def _tiny_model(device):
    from paddle_tpu_torch.text import GPTConfig, GPTForCausalLM
    return GPTForCausalLM(
        GPTConfig(**TINY), device=device,
        generator=torch.Generator(device=device).manual_seed(0)).eval()


def main(argv=None, out=None):
    out = out if out is not None else sys.stdout
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serving", action="store_true",
                    help="the serving overload drill")
    ap.add_argument("--router", action="store_true",
                    help="the in-process router drill")
    ap.add_argument("--proc", action="store_true",
                    help="with --router: the worker-process drill")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default cuda)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print each drill's result dict")
    args = ap.parse_args(argv)
    if not (args.serving or args.router):
        ap.error("pick --serving, --router or --router --proc")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("torch_chaos_check: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 1
    model = _tiny_model(args.device)
    reference = port_reference(model)
    if args.router and args.proc:
        prompts = drill_prompts(11, ROUTER_LENS)
        res = run_router_proc(
            drill_spec(device=args.device, config=TINY,
                       engine=TINY_ENGINE, step_delay_s=0.01),
            prompts, reference(prompts, 16), probe_digest(model))
        name, ok = "--router --proc", (
            f"{res['spawns']} worker processes in {res['seconds']:.0f}s; "
            f"r0 SIGKILLed 3x mid-stream (3/2/1 evict/respawn/abandon, "
            f"overlap dedup), a dropped frame evicted, a wedged worker "
            f"hang-evicted and KILLed; every stream byte-identical to "
            f"the reference, leak-free survivors, zero orphaned workers")
    elif args.router:
        res = run_router(model, reference)
        name, ok = "--router", (
            f"r0 killed 3x -> failover with overlap dedup, 2 respawns + "
            f"crash-loop abandon; burst shed {len(res['shed']['refused'])}"
            f" with structured reasons; hung replica evicted on its stale "
            f"beat; every stream byte-identical to the reference")
    else:
        res = run_serving(model, reference)
        name, ok = "--serving", (
            f"8 requests over a 7-block pool, "
            f"{res['counters']['preempted']} preemption(s) + 3 injected "
            f"exhaustions + 1 poisoned request; survivors token-identical "
            f"to sequential generate(), the poisoned one failed alone, "
            f"zero block leaks")
    if args.verbose:
        print(res, file=out)
    return _report(name, res["failures"], ok, out)


if __name__ == "__main__":
    sys.exit(main())
