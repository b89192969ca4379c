"""Telemetry of the port (counterpart: `paddle_tpu/observability`).

The metrics registry (`metrics`: counters, gauges, histograms) and the
host trace buffer (`trace`: Chrome-trace spans), with one switch:
`enable()` turns on what costs something when on (the loader's
queue-depth gauge and batch-wait histogram, `span` blocks), and can
retarget the registry every instrument writes to.  The serving tier's
and the collectives' counters count whether it is on or not, as they
did before the switch was ported.  `hapi.callbacks.MetricsLogger`
drives it from `Model.fit`.  The JAX package's compile tracker and
dispatch counters have no counterpart in an eager port.
"""
from __future__ import annotations

from . import metrics, trace
from .metrics import MetricsRegistry, registry
from .trace import chrome_trace, export_chrome_trace, span

__all__ = ["MetricsRegistry", "chrome_trace", "disable", "enable",
           "enabled", "export_chrome_trace", "metrics", "registry", "reset",
           "span", "trace"]

_enabled = False


def enabled() -> bool:
    return _enabled


def enable(registry_=None, warn_after=None):
    """Switch telemetry on; `registry_` retargets the active registry.
    `warn_after` (the reference's recompile-warning threshold) has
    nothing to configure in the eager port."""
    global _enabled
    if registry_ is not None:
        metrics.set_registry(registry_)
    _enabled = True


def disable():
    """Switch telemetry off; recorded metrics and spans stay until
    `reset()`.  A registry `enable(registry_=...)` installed is released
    back to the process default."""
    global _enabled
    metrics.set_registry(None)
    _enabled = False


def reset():
    """Clear the active registry and the trace buffer; the on / off state
    is kept."""
    metrics.registry().reset()
    trace.clear()
