"""Metrics export, the telemetry switch and the profiler of the port
against the JAX package's, on the CPU.

* Metrics: the same counters, gauges and histograms (labels with quotes,
  backslashes and newlines included) written into both packages'
  registries give the same `to_jsonl()` and `to_prometheus()` text;
  collectors run before every export and can be removed.
* `observability.enable()` installs the collectives' sink (a call adds
  to `comms_calls_total`, `comms_bytes_total`, the `comms_seconds`
  histogram and a "comms" span) and the mesh's axis-degree collector;
  `disable()` writes the collector's values once more and removes both.
* `make_scheduler` gives the reference's windows; a `Profiler` over the
  same step sequence with the same `RecordEvent`s captures the same
  windows and prints the same summary lines (the numbers aside), and
  keeps each window's `torch.profiler` profile and its Chrome trace.
* `program_stats` counts what the reference's XLA cost analysis counts
  for a matrix product, and the flash and paged operators through their
  registered FLOP formulas.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

import torch_cpu_threads

import paddle_tpu as pt
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import profiler as prof
from paddle_tpu_torch.distributed import collective, mesh
from paddle_tpu_torch.observability import metrics

torch_cpu_threads.limit()


def _fill(reg):
    reg.counter("steps_total").inc(3)
    reg.counter("tokens_total", phase="train").inc(1024)
    reg.counter("tokens_total", phase='we"ird\\lab\nel').inc(7)
    reg.gauge("queue_depth", worker="0").set(2.5)
    reg.gauge("queue_depth", worker="1").set(4)
    h = reg.histogram("step_seconds", op="fwd")
    for v in np.linspace(0.001, 0.2, 37):
        h.observe(float(v))
    reg.histogram("empty_seconds")
    reg.add_collector(lambda r: r.counter("collected_total")._set_total(9))


def test_exports_give_the_reference_text():
    ours, ref = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    _fill(ours)
    _fill(ref)
    assert ours.to_jsonl() == ref.to_jsonl()
    assert ours.to_prometheus() == ref.to_prometheus()
    text = ours.to_prometheus()
    assert 'step_seconds{op="fwd",quantile="0.99"}' in text
    assert "# TYPE step_seconds summary" in text
    assert "collected_total 9" in text
    recs = [json.loads(line) for line in ours.to_jsonl().splitlines()]
    assert {r["name"] for r in recs} >= {"collected_total", "step_seconds"}


def test_collectors_run_first_and_go_away():
    reg = metrics.MetricsRegistry()
    seen = []
    fn = reg.add_collector(lambda r: seen.append(1))
    assert reg.add_collector(fn) is fn            # added once
    reg.snapshot()
    reg.to_jsonl()
    assert seen == [1, 1]
    reg.remove_collector(fn)
    reg.collect()
    assert seen == [1, 1]


def test_enable_installs_the_comms_sink_and_mesh_collector():
    reg = metrics.MetricsRegistry()
    obs.trace.clear()
    mesh.build_mesh(dp=1)
    try:
        obs.enable(registry_=reg)
        assert collective._TELEMETRY is not None
        collective.all_reduce(torch.ones(4))
        snap = {(r["name"], tuple(sorted(r["labels"].items()))): r
                for r in reg.snapshot()}
        key = (("axis", "world"), ("op", "all_reduce"))
        assert snap[("comms_calls_total", key)]["value"] == 1
        assert snap[("comms_bytes_total", key)]["value"] == 16
        assert snap[("comms_seconds", (("op", "all_reduce"),))]["count"] \
            == 1
        assert snap[("mesh_axis_degree", (("axis", "dp"),))]["value"] == 1
        spans = [e for e in obs.trace.events() if e.get("cat") == "comms"]
        assert spans and spans[-1]["args"]["bytes"] == 16
    finally:
        obs.disable()
        mesh.clear_mesh()
    assert collective._TELEMETRY is None
    assert not reg._collectors
    collective.all_reduce(torch.ones(4))          # no sink: nothing new
    assert [r["value"] for r in reg.snapshot()
            if r["name"] == "comms_calls_total"] == [1]


@pytest.mark.parametrize("kw", [
    {}, {"closed": 1, "ready": 1, "record": 2},
    {"closed": 1, "ready": 0, "record": 2, "repeat": 3, "skip_first": 2},
    {"record": 0}])
def test_make_scheduler_windows_as_the_reference(kw):
    ours, ref = prof.make_scheduler(**kw), pt.profiler.make_scheduler(**kw)
    assert tuple(ours) == tuple(ref) and ours.windows == ref.windows


def test_make_scheduler_refuses_an_empty_cycle():
    for mk in (prof.make_scheduler, pt.profiler.make_scheduler):
        with pytest.raises(ValueError, match="positive"):
            mk(closed=0, ready=0, record=0, repeat=2)


def _drive(module, scheduler, log_dir, steps=6):
    p = module.Profiler(scheduler=scheduler, log_dir=str(log_dir))
    p.start()
    for i in range(steps):
        with module.RecordEvent("fwd"):
            with module.RecordEvent("inner"):
                pass
        if i % 2:
            with module.RecordEvent("opt"):
                pass
        p.step(num_samples=4)
    p.stop()
    return p


def _shape_of(summary):
    """The summary's lines with every number replaced by #."""
    return [re.sub(r"\d+(\.\d+)?", "#", line)
            for line in summary.splitlines()]


@pytest.mark.parametrize("sorted_by", ["count", "total"])
def test_profiler_windows_and_summary_as_the_reference(tmp_path, sorted_by):
    sched = prof.make_scheduler(closed=1, ready=0, record=2, repeat=2)
    ours = _drive(prof, sched, tmp_path / "ours")
    ref = _drive(pt.profiler, pt.profiler.make_scheduler(
        closed=1, ready=0, record=2, repeat=2), tmp_path / "ref")
    assert ours._windows_captured == ref._windows_captured == 2
    a = ours.summary(sorted_by=sorted_by).splitlines()
    b = ref.summary(sorted_by=sorted_by).splitlines()
    assert _shape_of("\n".join(a)) == _shape_of("\n".join(b))
    counts = lambda lines: [(ln.split()[0], ln.split()[1])  # noqa: E731
                            for ln in lines[2:]]
    if sorted_by == "count":
        assert counts(a) == counts(b) == [("inner", "6"), ("fwd", "6"),
                                          ("opt", "3")]
    assert a[0].startswith("steps=6 ") and "throughput=" in a[0]
    with pytest.raises(ValueError, match="sorted_by"):
        ours.summary(sorted_by="name")
    # each window writes its Chrome trace; the last window's profile is kept
    assert len(ours.trace_files) == 2
    assert all(os.path.exists(f) for f in ours.trace_files)
    names = {e.name for e in ours.torch_profile.events()}
    assert {"fwd", "inner"} <= names


def test_profiler_timer_only_and_profile_context(tmp_path):
    p = prof.Profiler(timer_only=True, log_dir=str(tmp_path / "t"))
    with p:
        p.step()
        p.step()
    assert p.torch_profile is None and not p.trace_files
    assert p.summary().startswith("steps=2 ")
    with prof.profile(log_dir=str(tmp_path / "p")) as q:
        torch.ones(3).sum()
        q.step()
    assert q.torch_profile is not None and len(q.trace_files) == 1
    prof.reset_events()
    assert not prof._event_stats


def test_program_stats_counts_products_and_the_port_operators():
    import jax.numpy as jnp
    a, b = np.ones((4, 8), np.float32), np.ones((8, 3), np.float32)
    want = pt.profiler.program_stats(lambda x, y: x @ y, jnp.asarray(a),
                                     jnp.asarray(b))["flops"]
    got = prof.program_stats(lambda x, y: x @ y, torch.from_numpy(a),
                             torch.from_numpy(b))
    assert got == {"flops": int(want)} == {"flops": 2 * 4 * 8 * 3}
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.paged_decode import paged_decode_op
    q = torch.randn(2, 16, 4, 8, requires_grad=True)

    def fwd_bwd(causal, window):
        o, _ = fa.flash_fwd_op(q, q, q, None, causal, 0.3, window)
        o.sum().backward()
    pairs = {(False, 0): 16 * 16, (True, 0): 16 * 17 // 2,
             (True, 4): 16 * 4 - 6}
    for (causal, window), n in pairs.items():
        assert fa.attended_pairs(16, 16, causal, window) == n
        assert prof.program_stats(fwd_bwd, causal, window)["flops"] == \
            3 * 4 * 2 * 4 * 8 * n
    qd, kp = torch.randn(3, 1, 4, 8), torch.randn(5, 4, 2, 8)
    tables = torch.zeros(3, 2, dtype=torch.int32)
    lens = torch.tensor([1, 3, 5])
    assert prof.program_stats(paged_decode_op, qd, kp, kp, tables, lens,
                              0.3)["flops"] == 4 * 4 * 8 * 9
