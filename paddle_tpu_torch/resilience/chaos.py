"""Deterministic fault injection at named sites.

Counterpart: `paddle_tpu/resilience/chaos.py`, whose plan grammar,
plans, site hooks and fault primitives are copied here (the port
imports nothing of the JAX package).  A fault fires at a named site
(`chaos.fire("step.nonfinite")`) when the installed `ChaosPlan`
schedules it; a plan is installed in code or from `PADDLE_TPU_CHAOS`.

Spec grammar (``;``-separated entries)::

    entry   := site [ '@' N ] [ '#' tag ] [ '*' R ] [ '~' P ]
    '@' N   := fire on the Nth hit of the site (1-based, default 1)
    '#' tag := only count hits carrying this tag
    '*' R   := keep firing for R consecutive hits ('inf' = forever)
    '~' P   := instead of '@', fire each hit with probability P drawn
               from the plan's seeded RNG

The sites the port has:

    step.nonfinite              poison the train step's batch (or, for a
                                batch of integers only, its loss)
    ckpt.crash_after_meta_stage crash save_state: meta staged, arrays old
    ckpt.crash_after_arrays     crash save_state: arrays committed, meta
                                not published
    save.sigterm                SIGTERM this process mid-save_state
    serving.pool_exhausted      the serving block pool refuses an
                                allocation (the scheduler's preemption
                                path must fire)
    serving.request_poison      a serving request's logits turn NaN: the
                                engine fails THAT request ("error") and
                                frees its blocks, the batch goes on
    serving.replica_kill        a router replica's step raises (the
                                in-process stand-in for a dead worker):
                                crash eviction and failover
    serving.replica_hang        a router replica stops stepping and
                                beating: the stale beat is a hang
                                eviction, not a crash
    serving.transport_drop      a frame on a worker's socket is dropped
                                in transit: the receiver rejects the
                                stream (FrameError) and the router
                                evicts the worker as a crash

    collective.fail_once        a collective raises before its attempt
                                (the policy's retry path)
    collective.timeout          a collective hits its deadline
                                (CollectiveTimeout, then the retry path)
    collective.hang             a collective stalls past the policy's
                                deadline: the watchdog abandons the
                                attempt and retries

    loader.worker_kill          a DataLoader worker process exits hard
                                (no error message) at a batch of its
                                slice: the pool respawns it
    loader.worker_hang          a DataLoader worker wedges at a batch:
                                the loader's timeout respawns it
    loader.batch_corrupt        a worker's batch payload is mangled: the
                                pool skips that batch with a warning

The loader sites fire from the PARENT's plan when a worker is spawned
(`take_loader_directives`, tag = the worker slot, @N = the batch of that
worker's slice).  Still to come with the modules that hold them:
`compile.fail_once`, the compile-cache sites (`cache.*`) and
`restart.mesh_change`.  With no plan installed every site costs one
`is None` test.
"""
from __future__ import annotations

import os
import random

import torch

_PLAN = None  # None: chaos disabled (the fast path)


class ChaosInterrupt(BaseException):
    """A simulated crash.  A BaseException, so that recovery code that
    catches `Exception` cannot swallow the injected crash itself."""


class _Entry:
    __slots__ = ("site", "at", "tag", "repeat", "prob", "fired")

    def __init__(self, site, at=1, tag=None, repeat=1, prob=None):
        self.site = site
        self.at = at
        self.tag = tag
        self.repeat = repeat
        self.prob = prob
        self.fired = 0

    def __repr__(self):
        s = self.site
        s += f"~{self.prob}" if self.prob is not None else f"@{self.at}"
        if self.tag is not None:
            s += f"#{self.tag}"
        if self.repeat != 1:
            s += f"*{self.repeat}"
        return s


def _parse_entry(text):
    # suffix order is free: site@N#tag*R and site#tag@N*R are the same
    site = text.split("@")[0].split("#")[0].split("*")[0].split("~")[0]
    vals = {"@": 1, "#": None, "*": 1, "~": None}
    for sep, conv in (("@", int), ("#", str),
                      ("*", lambda r: float("inf") if r == "inf"
                       else int(r)), ("~", float)):
        if sep in text:
            raw = text.split(sep, 1)[1]
            for other in "@#*~":
                if other != sep:
                    raw = raw.split(other)[0]
            vals[sep] = conv(raw)
    return _Entry(site.strip(), at=vals["@"], tag=vals["#"],
                  repeat=vals["*"], prob=vals["~"])


class ChaosPlan:
    """Parsed spec entries, a seeded RNG and per-site hit counters;
    `should_fire(site, tag)` counts the hit and says whether a fault
    triggers on it."""

    def __init__(self, spec="", seed=0):
        self.spec = spec
        self.seed = int(seed)
        self.entries = [_parse_entry(e) for e in spec.split(";")
                        if e.strip()]
        self._rng = random.Random(self.seed)
        self._hits = {}    # (site, tag | None) -> count
        self.log = []      # (site, tag, hit number) of every fired fault

    def should_fire(self, site, tag=None):
        tag = None if tag is None else str(tag)
        n_tag = self._hits[(site, tag)] = self._hits.get((site, tag), 0) + 1
        n_any = None
        if tag is not None:
            n_any = self._hits[(site, None)] = \
                self._hits.get((site, None), 0) + 1
        fire = False
        for e in self.entries:
            if e.site != site or e.fired >= e.repeat:
                continue
            if e.tag is not None and e.tag != tag:
                continue
            n = n_tag if e.tag is not None or n_any is None else n_any
            hit = (self._rng.random() < e.prob if e.prob is not None
                   else n >= e.at)
            if hit:
                e.fired += 1
                fire = True
        if fire:
            self.log.append((site, tag, n_tag))
        return fire

    def __repr__(self):
        return f"ChaosPlan({self.spec!r}, seed={self.seed})"


def install(plan):
    """Install a plan (a ChaosPlan or a spec string); returns it."""
    global _PLAN
    if isinstance(plan, str):
        plan = ChaosPlan(plan)
    _PLAN = plan
    return plan


def uninstall():
    global _PLAN
    _PLAN = None


def active():
    return _PLAN


def plan_from_env():
    """Install the plan of PADDLE_TPU_CHAOS (seeded by
    PADDLE_TPU_CHAOS_SEED); returns it, or None when the variable is
    unset."""
    spec = os.environ.get("PADDLE_TPU_CHAOS")
    if not spec:
        return None
    return install(ChaosPlan(
        spec, seed=int(os.environ.get("PADDLE_TPU_CHAOS_SEED", "0"))))


class scoped:
    """``with chaos.scoped("step.nonfinite@2") as plan: ...``: installed
    for the block, uninstalled after it, also after the injected crash."""

    def __init__(self, plan, seed=0):
        self._plan = plan if isinstance(plan, ChaosPlan) \
            else ChaosPlan(plan, seed=seed)

    def __enter__(self):
        install(self._plan)
        return self._plan

    def __exit__(self, *exc):
        uninstall()
        return False


def fire(site, tag=None):
    """True when the installed plan schedules a fault on this hit; the
    caller carries the fault out."""
    p = _PLAN
    if p is None:
        return False
    return p.should_fire(site, tag)


def crash(site, tag=None):
    """Raise ChaosInterrupt when the plan schedules a crash here."""
    if _PLAN is not None and _PLAN.should_fire(site, tag):
        raise ChaosInterrupt(site)


_LOADER_SITES = {"loader.worker_kill": "kill_at",
                 "loader.worker_hang": "hang_at",
                 "loader.batch_corrupt": "corrupt_at"}


def take_loader_directives(worker_id):
    """Consume this worker slot's pending ``loader.*`` faults and return
    them as positional directives ``{kill_at, hang_at, corrupt_at,
    corrupt_p}`` (1-based batch ordinals within the worker's slice).

    The parent resolves them when it spawns the worker, so its counters
    outlive the worker: a respawned worker does not suffer again the
    fault its predecessor carried out.  A probabilistic corrupt entry
    (``~p``) is not consumed: every spawn draws from the child's seeded
    RNG."""
    d = {"kill_at": None, "hang_at": None, "corrupt_at": None,
         "corrupt_p": None}
    p = _PLAN
    if p is None:
        return d
    for e in p.entries:
        key = _LOADER_SITES.get(e.site)
        if key is None or e.fired >= e.repeat:
            continue
        if e.tag is not None and e.tag != str(worker_id):
            continue
        if e.site == "loader.batch_corrupt" and e.prob is not None:
            d["corrupt_p"] = e.prob
            continue
        e.fired += 1
        p.log.append((e.site, str(worker_id), e.at))
        d[key] = e.at
    return d


def poison_batch(batch_arrays):
    """The `step.nonfinite` fault: (`batch_arrays` with its first floating
    tensor multiplied by NaN, True), so loss and gradients go nonfinite.

    A batch of integers only comes back unchanged with False, and the
    caller multiplies the LOSS by NaN instead (`poison_loss`).  This is
    where the port leaves the JAX package, which sets the first array to
    the int32 maximum: an index that large into an embedding reads NaN
    in JAX, but raises an IndexError in PyTorch on the CPU and trips a
    device-side assert on CUDA, which leaves the CUDA context unusable
    for the rest of the process."""
    out, done = [], False
    for a in batch_arrays:
        if not done and isinstance(a, torch.Tensor) and \
                a.is_floating_point():
            out.append(a * float("nan"))
            done = True
        else:
            out.append(a)
    return tuple(out), done


def poison_loss(loss):
    """loss * NaN: a nonfinite loss whose backward gives NaN gradients
    everywhere (NaN times a zero local gradient is NaN)."""
    return loss * float("nan")


def corrupt_checkpoint(path, mode="truncate_arrays"):
    """Damage a `framework.checkpoint` directory on disk.  Modes:
    ``truncate_arrays`` (cut arrays.pt in half), ``corrupt_meta``
    (meta.json overwritten with garbage), ``truncate_meta`` (meta.json
    cut mid-JSON), ``delete_meta``, ``delete_arrays``.  Returns path."""
    arrays = os.path.join(path, "arrays.pt")
    meta = os.path.join(path, "meta.json")
    if mode == "truncate_arrays":
        if not os.path.exists(arrays):
            raise FileNotFoundError(f"no arrays file at {arrays}")
        with open(arrays, "r+b") as f:
            f.truncate(max(os.path.getsize(arrays) // 2, 1))
    elif mode == "corrupt_meta":
        with open(meta, "w") as f:
            f.write("\x00garbage{{{")
    elif mode == "truncate_meta":
        with open(meta) as f:
            data = f.read()
        with open(meta, "w") as f:
            f.write(data[:max(len(data) // 2, 1)])
    elif mode == "delete_meta":
        os.unlink(meta)
    elif mode == "delete_arrays":
        os.unlink(arrays)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return path
