"""Persistent compile cache of the port (counterpart:
`paddle_tpu/jit/compile_cache.py`).

Every restart (a supervisor's backoff, a heartbeat kill, a new serving
replica) would pay `torch.compile` from scratch: Dynamo's trace, then
AOTAutograd and Inductor, whose code generation and kernel compiles take
most of the time.  This module turns the second half into a disk read:
the first process to compile a `jit.to_static` program publishes what
Inductor and AOTAutograd produced for it into an on-disk store, and a
later process (a restarted worker, another rank under
`distributed.launch`, a serving replica) loads it back before its own
compile, so that Inductor's FX-graph cache and AOTAutograd's cache hit.

The carrier is torch's own: `torch.compiler.save_cache_artifacts()` on a
miss, recorded around that one compile only (a fresh artifact list a
compile, so an entry holds the artifacts of its own compile), and
`torch.compiler.load_cache_artifacts()` before the compile of a hit,
which pre-fills Inductor's and AOTAutograd's local caches.  The artifacts
are the compiled forward and backward graphs (on the card with their
Triton kernels' binaries) and the autotuning results recorded during the
compile; the reference serializes an XLA executable instead.  A training
step compiles its backward with its forward here (AOTAutograd's
`force_non_lazy_backward_lowering`), so one entry carries both graphs:
the counterpart of the reference's cached `TrainStep`.  Dynamo's trace is
not carried: a warm process traces again, and the graph it hands over
must hash as the cold one did.

Keying mirrors the reference: function identity (label + source hashes of
the user code), the abstract call signature (shape, dtype and
requires-grad per tensor, and the pytree structure), static arguments,
the mesh, and the environment (`env_fingerprint`: torch and CUDA
versions, the device's name, capability and count, a hash of the port's
kernel sources and the package version, since a cached graph calls the
`paddle_tpu_torch::` operators by name).  The key only decides where to
look: what Inductor and AOTAutograd load is keyed again by their own
hashes of the graph, so a stale entry costs a compile (counted, then
republished), never a wrong program.

Robustness-first storage contract (as the reference):

  * writes are crash-safe: the payload lands in a same-directory temp
    file and is published with one atomic ``os.replace``;
  * every entry carries a sha256 checksum under the header `_MAGIC`; a
    corrupt or truncated entry moves to ``quarantine/`` and reads as a
    miss (silent recompile), never a crash;
  * sharing is lock-free: concurrent writers race benignly (last
    publisher wins), with no lock files to go stale after a kill -9;
  * the store is size-budgeted (``PADDLE_TPU_CACHE_MAX_BYTES``):
    oldest-first GC after each put, never collecting the entry just
    published;
  * an unwritable or full directory, or a torch without the artifact
    API, degrades to memory only with ONE `CacheUnavailableWarning`.

A graph Inductor will not cache (dy2static's `torch.cond` and
`while_loop` are higher-order operators its FX-graph cache bypasses) is
a counted miss with that reason ("uncacheable"), and nothing is
published for it.

Fault sites (`resilience/chaos.py`): ``cache.corrupt`` flips bytes in the
just-published entry, ``cache.race`` publishes a competing write first,
``cache.evict_inflight`` collects the entry right after publish.
``tools/torch_chaos_check.py --cold-start`` restarts a trainer on the
store and asserts 0 Inductor compiles and continuing losses, then
quarantines a damaged entry.

The reference's donated twin (`PADDLE_TPU_CACHE_DONATED`, `plain_jit`)
has no counterpart: torch has no buffer donation, so what the compiling
process runs is what it publishes.

Env knobs: ``PADDLE_TPU_CACHE_DIR`` (unset = disabled),
``PADDLE_TPU_CACHE_MAX_BYTES`` (default 2 GiB).
"""
from __future__ import annotations

import contextlib
import hashlib
import inspect
import json
import os
import platform
import threading
import time
import warnings
from pathlib import Path

import torch
from torch.utils import _pytree as pytree

_ENV_DIR = "PADDLE_TPU_CACHE_DIR"
_ENV_MAX = "PADDLE_TPU_CACHE_MAX_BYTES"
_MAGIC = b"PTCC0001"
_SUFFIX = ".ccx"
_DEFAULT_MAX_BYTES = 2 << 30
_CSRC = Path(__file__).resolve().parent.parent / "csrc"


class CacheUnavailableWarning(UserWarning):
    """The persistent cache degraded to in-memory-only (unwritable/full
    directory, or this torch cannot save compile artifacts)."""


def _reg():
    from ..observability import metrics
    return metrics.registry()


def _carrier():
    """(save, load) of torch's compile artifacts, or None when this torch
    has no such API."""
    save = getattr(torch.compiler, "save_cache_artifacts", None)
    load = getattr(torch.compiler, "load_cache_artifacts", None)
    if save is None or load is None:
        return None
    return save, load


# ===================================================================
# fingerprints: what makes two compilations "the same program"
# ===================================================================
_ENV_FP = {}    # device -> fingerprint (fixed for the process)


def _kernel_sources_digest():
    h = hashlib.sha256()
    for p in sorted(_CSRC.glob("*")):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def env_fingerprint(device=None):
    """What a compiled graph on `device` (default: the current device,
    which raises without a card unless the CPU is named) depends on: the
    torch and CUDA versions, the platform, the device's name, compute
    capability and count, a digest of the kernel sources under `csrc/`
    and the package version.  A dict, computed once a device."""
    from .. import __version__
    from ..device import resolve_device
    device = resolve_device(device)
    key = str(device)
    fp = _ENV_FP.get(key)
    if fp is not None:
        return fp
    if device.type == "cuda":
        cap = torch.cuda.get_device_capability(device)
        plat, kind = "gpu", torch.cuda.get_device_name(device)
        n, capability = torch.cuda.device_count(), f"{cap[0]}.{cap[1]}"
    else:
        plat, kind, n, capability = device.type, platform.machine(), 1, \
            None
    fp = _ENV_FP[key] = {
        "platform": plat, "device_kind": kind, "n_devices": n,
        "capability": capability, "torch": torch.__version__,
        "cuda": torch.version.cuda, "kernels": _kernel_sources_digest(),
        "package": __version__}
    return fp


def mesh_fingerprint():
    """The installed mesh's axis degrees ('' when none): a graph compiled
    for one topology (its collectives' groups) is keyed to it."""
    from ..distributed import mesh as mesh_mod
    if not mesh_mod.has_mesh():
        return ""
    return repr(tuple(sorted(mesh_mod._state["degrees"].items())))


def fingerprint_callables(*objs):
    """Best-effort identity hash of the user code shaping a program:
    source text when retrievable, else the qualified name."""
    h = hashlib.sha256()
    for o in objs:
        if o is None:
            h.update(b"<none>")
            continue
        if isinstance(o, str):
            h.update(o.encode())
            continue
        target = o
        if isinstance(o, type):
            target = getattr(o, "forward", None) or o
        try:
            h.update(inspect.getsource(target).encode())
        except (OSError, TypeError):
            h.update(repr(getattr(o, "__qualname__",
                                  getattr(o, "__name__", o))).encode())
    return h.hexdigest()


def _simple(v):
    return isinstance(v, (bool, int, float, str, type(None)))


# mutable RUNTIME state, not configuration: it advances during training
# (and lands restored from a checkpoint), so a warm restart would never
# key back to the entry the cold run published
_FP_SKIP = {"_step_count", "_state", "_jitted", "last_epoch",
            "_last_lr", "training"}


def config_fingerprint(*objs):
    """repr of the simple-valued instance state of `objs`: the
    hyperparameters a traced program bakes in as constants (a model
    config's dropout rates, an optimizer's betas).  Object-valued
    attributes contribute their type and their own simple attributes,
    one level deep; tensors and callables are skipped (shapes are keyed
    by `abstract_signature`, code by `fingerprint_callables`)."""
    def flat(o, depth):
        if o is None:
            return "<none>"
        if _simple(o):
            return repr(o)
        d = getattr(o, "__dict__", None)
        if not isinstance(d, dict) or depth <= 0:
            return type(o).__name__
        items = []
        for k in sorted(d):
            v = d[k]
            if k in _FP_SKIP:
                continue
            if _simple(v):
                items.append(f"{k}={v!r}")
            elif isinstance(v, (tuple, list)) and all(_simple(x)
                                                      for x in v):
                items.append(f"{k}={list(v)!r}")
            elif isinstance(v, dict):   # strategy config dicts
                simple = sorted(((dk, dv) for dk, dv in v.items()
                                 if _simple(dv)), key=lambda i: str(i[0]))
                body = ",".join(f"{dk!r}:{dv!r}" for dk, dv in simple)
                items.append(f"{k}={{{body}}}")
            elif getattr(v, "__dict__", None) is not None \
                    and not callable(v) and not isinstance(v, torch.Tensor):
                items.append(f"{k}={flat(v, depth - 1)}")
        return f"{type(o).__name__}({','.join(items)})"
    return "|".join(flat(o, 2) for o in objs)


def abstract_signature(args):
    """(one entry a leaf, the tree structure) of an argument tuple: a
    tensor's shape, dtype and requires-grad, another leaf's type and,
    for a simple value, its repr."""
    leaves, spec = pytree.tree_flatten(args)
    sig = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            sig.append((tuple(leaf.shape), str(leaf.dtype),
                        bool(leaf.requires_grad)))
        else:
            sig.append((type(leaf).__name__,
                        repr(leaf) if _simple(leaf) else ""))
    return tuple(sig), repr(spec)


# ===================================================================
# the on-disk store
# ===================================================================
class CompileCache:
    """Content-addressed artifact store under one directory.

    Entry format (single file ``<digest>.ccx``):
        magic(8) | header_len(8, big-endian) | header json | payload
    The header records the payload sha256/length plus human-readable key
    metadata; validation failure of any part quarantines the entry.
    """

    _QUARANTINE_KEEP = 16

    def __init__(self, cache_dir, max_bytes=None):
        self.dir = os.path.abspath(cache_dir) if cache_dir else None
        self.max_bytes = (_DEFAULT_MAX_BYTES if max_bytes is None
                          else int(max_bytes))
        self._mem = {}           # digest -> payload (fallback store)
        self._disk_ok = self.dir is not None
        self._warned = False
        self._lock = threading.Lock()

    def _path(self, digest):
        return os.path.join(self.dir, digest + _SUFFIX)

    def _degrade(self, why):
        """Switch to in-memory-only, warning exactly once."""
        self._disk_ok = False
        with self._lock:
            if self._warned:
                return
            self._warned = True
        warnings.warn(
            f"persistent compile cache degraded to in-memory-only: {why} "
            f"(dir={self.dir!r}); restarts of this process will recompile "
            f"from scratch", CacheUnavailableWarning, stacklevel=4)
        _reg().counter("compile_cache_degraded_total").inc()

    def _quarantine(self, path, why):
        """Move a damaged entry out of the lookup namespace (atomic, so a
        concurrent reader sees the old entry or a miss)."""
        qdir = os.path.join(self.dir, "quarantine")
        try:
            os.makedirs(qdir, exist_ok=True)
            dst = os.path.join(
                qdir, f"{os.path.basename(path)}.{os.getpid()}."
                      f"{int(time.time() * 1e3)}")
            os.replace(path, dst)
        except FileNotFoundError:
            return  # another process quarantined/evicted it first
        except OSError:
            try:
                os.unlink(path)
            except OSError:
                pass
        else:
            self._prune_quarantine(qdir)
        _reg().counter("compile_cache_quarantined_total").inc()
        warnings.warn(
            f"quarantined corrupt compile-cache entry "
            f"{os.path.basename(path)} ({why}); recompiling",
            CacheUnavailableWarning, stacklevel=5)

    @staticmethod
    def _prune_quarantine(qdir):
        """Keep only the newest few quarantined files (post-mortem
        evidence, outside the size budget)."""
        aged = []
        try:
            names = os.listdir(qdir)
        except OSError:
            return
        for n in names:
            try:
                aged.append((os.path.getmtime(os.path.join(qdir, n)), n))
            except OSError:
                continue
        aged.sort()
        for _, n in aged[:-CompileCache._QUARANTINE_KEEP]:
            try:
                os.unlink(os.path.join(qdir, n))
            except OSError:
                continue

    def get(self, digest):
        """Payload bytes for `digest`, or None (miss).  Any validation
        failure quarantines the entry and reports a miss."""
        if not self._disk_ok:
            return self._mem.get(digest)
        path = self._path(digest)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        except OSError as e:
            self._degrade(f"read failed: {e}")
            return self._mem.get(digest)
        try:
            if raw[:8] != _MAGIC:
                raise ValueError("bad magic")
            hlen = int.from_bytes(raw[8:16], "big")
            header = json.loads(raw[16:16 + hlen])
            payload = raw[16 + hlen:]
            if len(payload) != header["payload_len"]:
                raise ValueError(
                    f"torn payload ({len(payload)} of "
                    f"{header['payload_len']} bytes)")
            if hashlib.sha256(payload).hexdigest() != header["sha256"]:
                raise ValueError("checksum mismatch")
        except (ValueError, KeyError, IndexError, TypeError,
                UnicodeDecodeError) as e:
            self._quarantine(path, str(e))
            return None
        _reg().counter("compile_cache_read_bytes_total").inc(len(raw))
        return payload

    def put(self, digest, payload, meta=None):
        """Publish `payload` under `digest` (crash-safe, lock-free)."""
        from ..resilience import chaos as _chaos
        if not self._disk_ok:
            self._mem[digest] = payload
            return
        header = dict(meta or {})
        header.update(sha256=hashlib.sha256(payload).hexdigest(),
                      payload_len=len(payload), created=time.time())
        hjson = json.dumps(header, sort_keys=True).encode()
        blob = _MAGIC + len(hjson).to_bytes(8, "big") + hjson + payload
        path = self._path(digest)
        # chaos: a competing worker publishes first; ours must replace it
        # atomically (publication is all-or-nothing either way)
        if _chaos._PLAN is not None and _chaos.fire("cache.race"):
            self._write_atomic(path, blob)
        try:
            self._write_atomic(path, blob)
        except OSError as e:
            self._degrade(f"write failed: {e}")
            self._mem[digest] = payload
            return
        _reg().counter("compile_cache_puts_total").inc()
        _reg().counter("compile_cache_written_bytes_total").inc(len(blob))
        if _chaos._PLAN is not None and _chaos.fire("cache.corrupt"):
            self._flip_bytes(path)
        if _chaos._PLAN is not None and _chaos.fire("cache.evict_inflight"):
            # GC raced the publish and collected the fresh entry: the
            # next reader must see a clean miss, not a torn file
            try:
                os.unlink(path)
            except OSError:
                pass
            _reg().counter("compile_cache_evictions_total").inc()
        else:
            self.gc(protect=digest)

    def _write_atomic(self, path, blob):
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    @staticmethod
    def _flip_bytes(path):
        """The cache.corrupt fault: damage the published payload so a
        later get() must quarantine it."""
        try:
            with open(path, "r+b") as f:
                f.seek(-16, os.SEEK_END)
                f.write(b"\xff" * 8)
        except OSError:
            pass

    def entries(self):
        """[(path, mtime, size)] of live entries, oldest first."""
        try:
            names = os.listdir(self.dir)
        except (OSError, TypeError):
            return []
        out = []
        for n in names:
            if not n.endswith(_SUFFIX):
                continue
            p = os.path.join(self.dir, n)
            try:
                st = os.stat(p)
            except OSError:
                continue  # lost a race to GC/quarantine in another proc
            out.append((p, st.st_mtime, st.st_size))
        out.sort(key=lambda t: t[1])
        return out

    def total_bytes(self):
        return sum(s for _, _, s in self.entries())

    def gc(self, protect=None):
        """Evict oldest entries until the store fits the byte budget;
        `protect` (a digest) is never collected."""
        ents = self.entries()
        total = sum(s for _, _, s in ents)
        _reg().gauge("compile_cache_bytes").set(total)
        if total <= self.max_bytes:
            return 0
        keep = self._path(protect) if protect else None
        evicted = 0
        for path, _, size in ents:
            if total <= self.max_bytes:
                break
            if path == keep:
                continue
            try:
                os.unlink(path)
            except OSError:
                continue  # a concurrent evictor got it
            total -= size
            evicted += 1
        if evicted:
            _reg().counter("compile_cache_evictions_total").inc(evicted)
            _reg().gauge("compile_cache_bytes").set(max(total, 0))
        return evicted


# ===================================================================
# process-level switch
# ===================================================================
_CACHE = None
_CONFIGURED = False
_LOCK = threading.Lock()


def configure(cache_dir=None, max_bytes=None):
    """Install the process cache (None disables).  Overrides the env
    knobs; returns the active CompileCache or None."""
    global _CACHE, _CONFIGURED
    with _LOCK:
        if cache_dir is None:
            _CACHE = None
        else:
            try:
                os.makedirs(cache_dir, exist_ok=True)
                probe_ok = os.access(cache_dir, os.W_OK)
            except OSError:
                probe_ok = False
            _CACHE = CompileCache(cache_dir, max_bytes=max_bytes)
            if not probe_ok:
                _CACHE._degrade("directory is not writable")
            elif _carrier() is None:
                _CACHE._degrade("this torch cannot save compile artifacts "
                                "(torch.compiler.save_cache_artifacts)")
        _CONFIGURED = True
    return _CACHE


def cache():
    """The active CompileCache (configured from PADDLE_TPU_CACHE_DIR on
    first use), or None when the cache is disabled."""
    if not _CONFIGURED:
        d = os.environ.get(_ENV_DIR)
        mb = os.environ.get(_ENV_MAX)
        configure(d if d else None, max_bytes=int(mb) if mb else None)
    return _CACHE


def enabled():
    return cache() is not None


def reset():
    """Drop the process cache state (tests); env is re-read on next use."""
    global _CACHE, _CONFIGURED
    with _LOCK:
        _CACHE = None
        _CONFIGURED = False


# ===================================================================
# per-entry frontend
# ===================================================================
_ACTIVE = threading.local()   # the _Record of the compile on this thread


def note_graph(gm):
    """Called with each graph Dynamo hands the backend: records why
    Inductor will not cache it (a higher-order operator it cannot cache,
    as `torch._inductor.codecache` checks) on the compile being
    recorded."""
    rec = getattr(_ACTIVE, "rec", None)
    if rec is None:
        return
    for mod in gm.modules():
        if not isinstance(mod, torch.fx.GraphModule):
            continue
        for node in mod.graph.nodes:
            t = node.target
            if isinstance(t, torch._ops.HigherOrderOperator) and \
                    not t.cacheable():
                rec.reasons.add(
                    f"Can't cache HigherOrderOperator: {t.name()}")


def _counts():
    from torch._dynamo.utils import counters
    ind, aot = counters["inductor"], counters["aot_autograd"]
    return {"fx_miss": ind["fxgraph_cache_miss"],
            "fx_hit": ind["fxgraph_cache_hit"],
            "fx_bypass": ind["fxgraph_cache_bypass"],
            "aot_miss": aot["autograd_cache_miss"],
            "aot_hit": aot["autograd_cache_hit"],
            "aot_bypass": aot["autograd_cache_bypass"]}


class _Record:
    __slots__ = ("reasons", "before")

    def __init__(self):
        self.reasons = set()
        self.before = _counts()

    def delta_now(self):
        """The cache counters' change since the record began."""
        now = _counts()
        return {k: now[k] - self.before[k] for k in now}


@contextlib.contextmanager
def _recording():
    """A fresh list of compile artifacts for the block (torch records
    every artifact a compile writes or reads into one process-wide list),
    with the backward compiled beside the forward; yields the _Record,
    whose `delta` holds the block's cache counters afterwards."""
    from torch.compiler._cache import CacheArtifactManager
    fresh = getattr(CacheArtifactManager, "with_fresh_cache", None)
    if fresh is None:
        CacheArtifactManager.clear()
        fresh = contextlib.nullcontext
    rec = _Record()
    prev, _ACTIVE.rec = getattr(_ACTIVE, "rec", None), rec
    try:
        with fresh(), torch._functorch.config.patch(
                force_non_lazy_backward_lowering=True):
            yield rec
    finally:
        _ACTIVE.rec = prev


class FunctionCache:
    """Frontend one compiled entry point holds: per-signature digesting
    and the load-or-compile flow around the call that compiles.

    `fingerprint` is a tuple of callables/strings identifying the user
    code this entry compiles (a Layer class, a function); hashed once.
    """

    def __init__(self, label, fingerprint=()):
        self.label = label
        self._fp = fingerprint_callables(*fingerprint)

    def digest(self, args, static=(), device=None):
        sig, tree = abstract_signature(args)
        h = hashlib.sha256()
        for part in (self.label, self._fp, repr(sig), tree,
                     repr(tuple(repr(s) for s in static)),
                     repr(sorted(env_fingerprint(device).items())),
                     mesh_fingerprint()):
            h.update(part.encode())
            h.update(b"\x00")
        return h.hexdigest()

    def run(self, call, args, static=(), device=None):
        """call() (the first call of a new signature, which compiles),
        resolved through the store.  Returns (call's result, outcome):
        'hit' (the store's entry served: Inductor compiled nothing),
        'miss' (compiled now and published), 'uncacheable' (Inductor
        bypassed its cache for a graph: compiled, nothing published) or
        'bypass' (no store)."""
        c = cache()
        if c is None:
            return call(), "bypass"
        digest = self.digest(args, static, device)
        blob = c.get(digest)
        loaded = False
        if blob is not None:
            t0 = time.perf_counter()
            from .. import ops  # noqa: F401  (the graphs' operators)
            try:
                _carrier()[1](blob)
            except Exception as e:
                # passed the checksum but will not load (a format change
                # of torch's artifacts): quarantine and recompile
                if c._disk_ok:
                    c._quarantine(c._path(digest), f"load: {e}")
                else:
                    c._mem.pop(digest, None)
            else:
                loaded = True
                dt = time.perf_counter() - t0
                _reg().histogram("compile_cache_load_seconds",
                                 fn=self.label).observe(dt)
                self._trace("cache-load", t0, dt)
        t0 = time.perf_counter()
        with _recording() as rec:
            out = call()
            d = rec.delta_now()
            compiled = d["fx_miss"] + d["aot_miss"]
            bypassed = d["fx_bypass"] + d["aot_bypass"]
            saved = None
            if not bypassed and (compiled or not loaded):
                saved = _carrier()[0]()
        compile_s = time.perf_counter() - t0
        if loaded and not compiled and not bypassed:
            _reg().counter("compile_cache_hits_total", fn=self.label).inc()
            _reg().counter("compile_cache_hit_graphs_total",
                           fn=self.label).inc(d["fx_hit"])
            return out, "hit"
        if loaded:
            _reg().counter("compile_cache_stale_total", fn=self.label).inc()
        _reg().counter("compile_cache_misses_total", fn=self.label).inc()
        if bypassed:
            reason = "; ".join(sorted(rec.reasons)) or \
                "Inductor bypassed its FX-graph cache"
            _reg().counter("compile_cache_uncacheable_total",
                           fn=self.label, reason=reason).inc()
            return out, "uncacheable"
        if saved is None:
            # the compile recorded no artifact (nothing to publish)
            _reg().counter("compile_cache_errors_total",
                           fn=self.label).inc()
            return out, "miss"
        payload, info = saved
        t1 = time.perf_counter()
        c.put(digest, payload, meta={
            "label": self.label, "torch": torch.__version__,
            "graphs": len(info.artifacts.get("inductor", ())),
            "compile_s": compile_s, "mesh": mesh_fingerprint()})
        _reg().histogram("compile_cache_compile_seconds",
                         fn=self.label).observe(compile_s)
        _reg().histogram("compile_cache_publish_seconds",
                         fn=self.label).observe(time.perf_counter() - t1)
        self._trace("cache-miss-compile", t0, compile_s)
        return out, "miss"

    def _trace(self, what, t0, dur):
        from .. import observability as _obs
        if _obs.enabled():
            _obs.trace.add_complete(f"{what}:{self.label}", "compile",
                                    t0, dur)


def stats():
    """Hit/miss/quarantine/eviction totals summed over labels: the
    cold-start drill's assertion surface.  `hit_graphs` counts the
    compiled graphs the hits served (a training step's forward and
    backward are two)."""
    out = {"hits": 0, "hit_graphs": 0, "misses": 0, "stale": 0,
           "uncacheable": 0, "quarantined": 0, "evictions": 0,
           "errors": 0, "puts": 0, "degraded": 0}
    name_map = {"compile_cache_hits_total": "hits",
                "compile_cache_hit_graphs_total": "hit_graphs",
                "compile_cache_misses_total": "misses",
                "compile_cache_stale_total": "stale",
                "compile_cache_uncacheable_total": "uncacheable",
                "compile_cache_quarantined_total": "quarantined",
                "compile_cache_evictions_total": "evictions",
                "compile_cache_errors_total": "errors",
                "compile_cache_puts_total": "puts",
                "compile_cache_degraded_total": "degraded"}
    for rec in _reg().snapshot():
        k = name_map.get(rec["name"])
        if k is not None:
            out[k] += rec.get("value", 0)
    return out
