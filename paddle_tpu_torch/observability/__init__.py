"""Telemetry of the port (counterpart: `paddle_tpu/observability`).

The metrics registry (`metrics`: counters, gauges, histograms) and the
host trace buffer (`trace`: Chrome-trace spans), with one switch:
`enable()` turns on what costs something when on (the loader's
queue-depth gauge and batch-wait histogram, `span` blocks), and can
retarget the registry every instrument writes to.  The serving tier's
and the collectives' counters count whether it is on or not, as they
did before the switch was ported.  `hapi.callbacks.MetricsLogger`
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


def enable(registry_=None, warn_after=None):
    """Switch telemetry on; `registry_` retargets the active registry,
    `warn_after` the compile tracker's recompile-warning threshold."""
    global _enabled
    if registry_ is not None:
        metrics.set_registry(registry_)
    if warn_after is not None:
        compile_tracker.set_warn_after(warn_after)
    _enabled = True


def disable():
    """Switch telemetry off; recorded metrics and spans stay until
    `reset()`.  A registry `enable(registry_=...)` installed is released
    back to the process default."""
    global _enabled
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
