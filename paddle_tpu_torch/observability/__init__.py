"""Telemetry of the port (counterpart: `paddle_tpu/observability`).

The metrics registry (`metrics`: counters, gauges, histograms, the
JSON-lines and Prometheus exports) and the host trace buffer (`trace`:
Chrome-trace spans), with one switch: `enable()` turns on what costs
something when on (the loader's queue-depth gauge and batch-wait
histogram, `span` blocks, `profiler.RecordEvent`'s and
`profiler.Profiler`'s spans), installs the collectives' sink (each call
timed: `comms_calls_total`, `comms_bytes_total`, the `comms_seconds`
histogram and a "comms" span, as `paddle_tpu/observability/
__init__.py:96-131`) and the export-time collector of the mesh's axis
degrees (`mesh_axis_degree{axis}`), and can retarget the registry every
instrument writes to; `disable()` writes the collector's values once
more and removes it.  The serving tier's and the collectives' own
counters count whether it is on or not, as they did before the switch
was ported.  `hapi.callbacks.MetricsLogger`
drives it from `Model.fit`.  `compile_tracker` records what
`torch.compile` compiles for `jit.to_static` and the static `Executor`
(causes, wall time, graph breaks) whether telemetry is on or not.  The
JAX package's op-dispatch counters have no counterpart: the port calls
torch directly, so `dispatch_stats()` reports the hand kernels' launch
counts (the Pallas-override hits' counterpart) and no op or cast counts.
"""
from __future__ import annotations

from . import compile_tracker, metrics, trace
from .compile_tracker import RecompileWarning
from .metrics import MetricsRegistry, registry
from .trace import chrome_trace, export_chrome_trace, span

__all__ = ["MetricsRegistry", "RecompileWarning", "chrome_trace",
           "compile_tracker", "disable", "dispatch_stats", "enable",
           "enabled", "export_chrome_trace", "metrics", "registry", "reset",
           "span", "trace"]

_enabled = False


def enabled() -> bool:
    return _enabled


def _mesh_collector(reg):
    """The mesh's axis degrees as gauges, read at export time, so they
    appear whether the mesh was built before or after `enable()`."""
    from ..distributed import mesh as mesh_mod
    if not mesh_mod.has_mesh():
        return
    for ax in ("dp", "mp", "pp", "ep"):
        reg.gauge("mesh_axis_degree", axis=ax).set(mesh_mod.degree(ax))


class _CommsTelemetry:
    """The sink installed as `distributed.collective._TELEMETRY`."""

    __slots__ = ("_reg",)

    def __init__(self, reg):
        self._reg = reg

    def record(self, op, nbytes, axis, t0, dur_s):
        axis = str(axis)
        self._reg.counter("comms_calls_total", op=op, axis=axis).inc()
        self._reg.counter("comms_bytes_total", op=op, axis=axis).inc(nbytes)
        self._reg.histogram("comms_seconds", op=op).observe(dur_s)
        trace.add_complete(op, "comms", t0, dur_s,
                           args={"bytes": int(nbytes), "axis": axis})


def enable(registry_=None, warn_after=None):
    """Switch telemetry on; `registry_` retargets the active registry,
    `warn_after` the compile tracker's recompile-warning threshold."""
    global _enabled
    from ..distributed import collective as _collective
    if registry_ is not None:
        metrics.set_registry(registry_)
    reg = metrics.registry()
    reg.add_collector(_mesh_collector)
    _collective._TELEMETRY = _CommsTelemetry(reg)
    if warn_after is not None:
        compile_tracker.set_warn_after(warn_after)
    _enabled = True


def disable():
    """Switch telemetry off; recorded metrics and spans stay until
    `reset()`.  The collectors' values are written one last time and the
    collectors removed; a registry `enable(registry_=...)` installed is
    released back to the process default."""
    global _enabled
    from ..distributed import collective as _collective
    _collective._TELEMETRY = None
    reg = metrics.registry()
    _mesh_collector(reg)
    reg.remove_collector(_mesh_collector)
    metrics.set_registry(None)
    _enabled = False


def dispatch_stats():
    """{'ops': {}, 'amp_casts': {}, 'pallas_hits': {kernel: launches}}:
    the reference's keys; the hand kernels' nonzero launch counters stand
    for its Pallas-override hits."""
    from ..ops import launch_counts
    hits = {k: v for k, v in launch_counts().items()
            if v and k != "sdpa_plain"}
    return {"ops": {}, "amp_casts": {}, "pallas_hits": hits}


def reset():
    """Clear the active registry, the trace buffer and the compile
    tracker; the on / off state is kept."""
    metrics.registry().reset()
    trace.clear()
    compile_tracker.reset()
