"""Host-side trace_event buffer + Chrome-trace (chrome://tracing) export.

Counterpart: `paddle_tpu/observability/trace.py`, copied (the port
imports nothing of the JAX package).  It complements the device trace
`torch.profiler` takes: the device trace shows kernels, this one the
host story (`Model.fit`'s step spans from `hapi.callbacks.MetricsLogger`,
`span` blocks) on one `chrome://tracing` / Perfetto-loadable JSON
timeline.

Timestamps are microseconds since a process-local perf_counter epoch, so
spans from any thread land on one consistent timeline.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

_EPOCH = time.perf_counter()
_MAX_EVENTS = 200_000

_lock = threading.Lock()
_events = []
_dropped = 0
_tid_map = {}


def _ts(perf_t) -> float:
    return (perf_t - _EPOCH) * 1e6


def _tid() -> int:
    ident = threading.get_ident()
    tid = _tid_map.get(ident)
    if tid is None:
        with _lock:
            tid = _tid_map.setdefault(ident, len(_tid_map) + 1)
    return tid


def _append(ev):
    global _dropped
    with _lock:
        if len(_events) < _MAX_EVENTS:
            _events.append(ev)
        else:
            _dropped += 1


def add_complete(name, cat, t0_perf, dur_s, args=None):
    """One 'X' (complete) event: a [t0, t0+dur] span on this thread."""
    ev = {"name": str(name), "cat": cat, "ph": "X", "ts": _ts(t0_perf),
          "dur": max(0.0, dur_s) * 1e6, "pid": os.getpid(), "tid": _tid()}
    if args:
        ev["args"] = args
    _append(ev)


def add_instant(name, cat, args=None):
    ev = {"name": str(name), "cat": cat, "ph": "i", "s": "t",
          "ts": _ts(time.perf_counter()), "pid": os.getpid(),
          "tid": _tid()}
    if args:
        ev["args"] = args
    _append(ev)


@contextlib.contextmanager
def span(name, cat="host", args=None):
    """Record the enclosed block as a complete event (no-op while
    telemetry is disabled)."""
    from . import enabled
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_complete(name, cat, t0, time.perf_counter() - t0, args=args)


def events():
    with _lock:
        return list(_events)


def mark() -> int:
    """Current buffer position; pass to chrome_trace/export_chrome_trace
    as `since` to export only events recorded after this point (per-run
    traces from a long-lived process)."""
    with _lock:
        return len(_events)


def dropped() -> int:
    return _dropped


def clear():
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0


def chrome_trace(since=0) -> dict:
    """The trace_event JSON object (metadata names + buffered events from
    position `since` on — see mark())."""
    pid = os.getpid()
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": "paddle_tpu_torch host telemetry"}}]
    with _lock:
        meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                  "args": {"name": f"host-thread-{tid}"}}
                 for tid in sorted(_tid_map.values())]
        evs = _events[since:]
    return {"traceEvents": meta + evs, "displayTimeUnit": "ms"}


def export_chrome_trace(path, since=0) -> str:
    """Write the merged timeline to `path`; returns the path."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace(since), f)
    return path
