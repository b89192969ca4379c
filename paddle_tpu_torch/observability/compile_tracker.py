"""Compile tracking for the port's compiled entry points (counterpart:
`paddle_tpu/observability/compile_tracker.py`).

`jit.to_static` and the static `Executor` report an abstract call
signature per invocation (shapes, dtypes and the Python values that
specialise the program).  A signature never seen for that function means
`torch.compile` is about to trace and compile.  The caller passes the
token `on_call` returns to `finish` with what Dynamo did during the call:
how many graphs its backend compiled and how many graph breaks it met.
A compile that no new signature explains (Dynamo's guards failed on
something else: a global, a module attribute, the training flag of a
sublayer) is recorded by `on_recompile` with the cause "guard failure".
The tracker diagnoses why a recompile happened (shape, dtype, new static
argument) and, after `warn_after` distinct compilations of the same
function, raises a `RecompileWarning` naming the cause.

`aot_profile` (the split of `jax.jit`'s lowering and compile time) has no
counterpart: `torch.compile` compiles inside the first call.
"""
from __future__ import annotations

import threading
import time
import warnings
import weakref


class RecompileWarning(UserWarning):
    """A compiled function keeps recompiling (shape/dtype/static-arg
    churn)."""


def _ref(owner):
    """A weak reference to `owner` where it takes one, else a strong one."""
    try:
        return weakref.ref(owner)
    except TypeError:
        return lambda: owner


class CompileEvent:
    __slots__ = ("label", "cause", "wall_s", "ts", "index", "graphs",
                 "graph_breaks", "_owner")

    def __init__(self, label, cause, wall_s, ts, index, graphs=1,
                 graph_breaks=0, owner=None):
        self.label = label          # function identity, e.g. to_static(Net)
        self.cause = cause          # "first compile" / "shape change" / ...
        self.wall_s = wall_s        # trace + compile + first-run wall time
        self.ts = ts                # perf_counter at call start
        self.index = index          # 1-based compile count for this label
        self.graphs = graphs        # graphs the backend compiled
        self.graph_breaks = graph_breaks    # Dynamo's graph breaks
        self._owner = _ref(owner)

    @property
    def owner(self):
        """What compiled (the `owner` given to on_call), or None once it
        is collected."""
        return self._owner()

    def __repr__(self):
        return (f"CompileEvent({self.label!r}, cause={self.cause!r}, "
                f"wall_s={self.wall_s:.3f}, n={self.index}, "
                f"graphs={self.graphs}, breaks={self.graph_breaks})")


class _FnRecord:
    """Per-(owner, label) state: hash-set membership for the hot path,
    plus the last full signature for cause diagnosis."""

    __slots__ = ("hashes", "last", "count", "warned_causes")

    def __init__(self):
        self.hashes = set()
        self.last = None
        self.count = 0
        self.warned_causes = set()


_lock = threading.Lock()
_seen: dict = {}      # (owner id, label) -> _FnRecord
_events: list = []
_warn_after = 5


def _drop_key(key):
    with _lock:
        _seen.pop(key, None)


def set_warn_after(n):
    global _warn_after
    _warn_after = int(n)


def signature_of(arrays, static=()):
    """Abstract signature: ((shape, dtype) per tensor, static part).
    `static` is repr'd: the Python values that specialise the program
    (training flags, bool / str / None arguments)."""
    leaves = []
    for a in arrays:
        d = getattr(a, "dtype", None)
        leaves.append((tuple(getattr(a, "shape", ())),
                       d if d is not None else type(a).__name__))
    return (tuple(leaves), tuple(repr(s) for s in static))


def diagnose(prev, new):
    """Explain what changed between the previous and the new signature."""
    if prev is None:
        return "first compile"
    p_arr, p_st = prev
    n_arr, n_st = new
    if p_st != n_st:
        return "new static arg"
    if len(p_arr) != len(n_arr):
        return "arity change"
    shape_changed = any(ps != ns for (ps, _), (ns, _) in zip(p_arr, n_arr))
    dtype_changed = any(pd != nd for (_, pd), (_, nd) in zip(p_arr, n_arr))
    if shape_changed and dtype_changed:
        return "shape+dtype change"
    if shape_changed:
        return "shape change"
    if dtype_changed:
        return "dtype change"
    return "recompile (unknown cause)"


class _Token:
    __slots__ = ("label", "cause", "index", "t0", "key", "sig_hash",
                 "prev_last", "owner")

    def __init__(self, label, cause, index, t0, key, sig_hash, prev_last,
                 owner):
        self.label = label
        self.cause = cause
        self.index = index
        self.t0 = t0
        self.key = key
        self.sig_hash = sig_hash
        self.prev_last = prev_last
        self.owner = owner


def _record(owner, label):
    key = (id(owner), label)
    rec = _seen.get(key)
    if rec is None:
        rec = _seen[key] = _FnRecord()
        if owner is not None:
            try:
                weakref.finalize(owner, _drop_key, key)
            except TypeError:
                pass   # not weakrefable: stays until reset()
    return key, rec


def _count(rec, label, cause):
    """Count one compile on `rec`; warn once per cause past the limit.
    Called under the lock; returns (index, warn)."""
    rec.count += 1
    warn = rec.count > _warn_after and cause not in rec.warned_causes
    if warn:
        rec.warned_causes.add(cause)
    return rec.count, warn


def _warn(label, index, cause):
    warnings.warn(
        f"{label} compiled {index} times (latest cause: {cause}); "
        f"recompilation dominates step time — stabilize input "
        f"shapes/dtypes (pad/bucket batches) or hoist the changing "
        f"python argument out of the compiled call",
        RecompileWarning, stacklevel=4)


def on_call(label, sig, owner=None):
    """Report an invocation.  Returns a token when this signature is new
    for (`owner`, `label`) (pass it to finish() after the call, or
    abort() if the call raises); returns None for a signature seen
    before.  `owner` distinguishes instances sharing a label; the key is
    its id, dropped when the owner is collected."""
    h = hash(sig)
    with _lock:
        key, rec = _record(owner, label)
        if h in rec.hashes:
            return None
        cause = diagnose(rec.last, sig)
        rec.hashes.add(h)
        prev_last, rec.last = rec.last, sig
        index, warn = _count(rec, label, cause)
    if warn:
        _warn(label, index, cause)
    return _Token(label, cause, index, time.perf_counter(), key, h,
                  prev_last, owner)


def abort(token):
    """Roll back on_call after the compiled call raised: the signature
    must not count as seen (a retry after fixing the inputs would
    otherwise never be recorded)."""
    with _lock:
        rec = _seen.get(token.key)
        if rec is not None and token.sig_hash in rec.hashes:
            rec.hashes.discard(token.sig_hash)
            rec.count -= 1
            rec.last = token.prev_last


def _emit(ev):
    from . import metrics, trace
    with _lock:
        _events.append(ev)
    reg = metrics.registry()
    reg.counter("jit_compiles_total", fn=ev.label).inc()
    reg.counter("jit_recompiles_total", fn=ev.label, cause=ev.cause).inc()
    reg.histogram("jit_compile_seconds", fn=ev.label).observe(ev.wall_s)
    if ev.graph_breaks:
        reg.counter("jit_graph_breaks_total", fn=ev.label).inc(
            ev.graph_breaks)
    trace.add_complete(f"compile:{ev.label}", "compile", ev.ts, ev.wall_s,
                       args={"cause": ev.cause, "n": ev.index,
                             "graphs": ev.graphs,
                             "graph_breaks": ev.graph_breaks})
    return ev


def finish(token, cache_hit=False, graphs=1, graph_breaks=0):
    """Close a compile event opened by on_call; records metrics and a
    trace span.  `cache_hit=True` (a new signature that compiled nothing:
    Dynamo's guards took a graph it already had) keeps no event and does
    not count as a compile."""
    if cache_hit:
        with _lock:
            rec = _seen.get(token.key)
            if rec is not None:
                rec.count -= 1
        return None
    wall = time.perf_counter() - token.t0
    return _emit(CompileEvent(token.label, token.cause, wall, token.t0,
                              token.index, graphs, graph_breaks,
                              token.owner))


def on_recompile(label, t0, graphs, graph_breaks=0, owner=None):
    """Record a compile that no new signature explains ("guard failure":
    Dynamo recompiled for a global or an attribute it guards on)."""
    with _lock:
        _, rec = _record(owner, label)
        index, warn = _count(rec, label, "guard failure")
    if warn:
        _warn(label, index, "guard failure")
    return _emit(CompileEvent(label, "guard failure",
                              time.perf_counter() - t0, t0, index, graphs,
                              graph_breaks, owner))


def events(label=None):
    with _lock:
        evs = list(_events)
    return [e for e in evs if e.label == label] if label else evs


def compile_count(label):
    """Total distinct compilations recorded for `label`, across owners."""
    with _lock:
        return sum(rec.count for (_, lb), rec in _seen.items()
                   if lb == label)


def graph_breaks(label=None):
    """Graph breaks Dynamo met in the recorded compiles (of `label`)."""
    return sum(e.graph_breaks for e in events(label))


def reset():
    with _lock:
        _seen.clear()
        _events.clear()
