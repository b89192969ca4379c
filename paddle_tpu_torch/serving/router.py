"""Multi-replica serving router: the survival tier in front of N
:class:`~paddle_tpu_torch.serving.LLMEngine` replicas.

Counterpart: `paddle_tpu/serving/router.py`, ported; metric names are
the JAX package's, in the port's registry.  The router keeps streams
alive when a replica dies mid-token, hangs, or the offered load exceeds
capacity.  Four jobs:

* **Admission**: least-loaded placement from each engine's queue-depth /
  running / free-block gauges, with session affinity (an LRU-capped
  session -> replica map) for multi-turn traffic.
* **Health**: each replica beats a heartbeat file from its *scheduler
  loop* (not a daemon thread: a wedged engine must look wedged), and the
  router watches it with :class:`~paddle_tpu_torch.distributed.launch.
  heartbeat.BeatWatch` on its own monotonic clock.  A **stale beat is a
  hang**, a raise from the replica (or its process's exit) a **crash**;
  both evict, with the cause recorded separately.
* **Failover**: an evicted replica's in-flight requests re-prefill on a
  survivor with their already-emitted tokens as ``resume_tokens``.  The
  last ``failover_overlap`` emitted tokens are generated again on the
  survivor and deduplicated here, a live check that the resumed stream
  is the same stream (a mismatch fails the request loudly instead of
  forking the text).  Failover resubmissions are shed-exempt.
* **Recovery**: evicted slots respawn through `resilience.backoff.
  Backoff`, and `CrashLoopDetector` abandons a slot that keeps dying.

Overload degrades at two levels: each engine sheds at its watermarks
(`ShedRequest`), and the router sheds when every healthy replica
refuses.

The router drives replicas through one interface, :class:`ReplicaHandle`,
with two implementations and no transport-specific branch here:
:class:`EngineReplica` (in-process: an engine, a heartbeat file and the
chaos sites) and `serving.worker.ProcReplica` (a worker process behind
the framed socket transport; pass ``replica_factory=``, and
``spawn_grace_s`` for its start-up).

``warm_start(engine)`` is called on the engine of every in-process
replica the router spawns, before it serves: it loads AOT serving
artifacts (`serving.aot.load_serving_artifacts`), so a respawned replica
serves from the packages too.  It is best effort: a failure warns and
the replica serves eagerly; each respawn it warmed counts
``router_respawn_warm_start_total``.

Chaos sites: ``serving.replica_kill`` (the replica's step raises, as a
dead process would), ``serving.replica_hang`` (the replica stops
stepping and beating) and, in the transport, ``serving.transport_drop``.
`tools/torch_chaos_check.py --router` is the in-process drill,
``--router --proc`` kills real worker processes with SIGKILL.
"""
from __future__ import annotations

import collections
import os
import shutil
import tempfile
import time
import warnings

from ..distributed.launch import heartbeat as hb
from ..observability import metrics as _metrics
from ..resilience import chaos
from ..resilience.backoff import Backoff, CrashLoopDetector
from .engine import ShedRequest

# replica-slot states
HEALTHY = "healthy"
DEAD = "dead"             # evicted, no respawn pending
RESPAWNING = "respawning"  # evicted, respawn scheduled (backoff)
ABANDONED = "abandoned"    # crash-looping: restarts cannot help


class ReplicaGone(RuntimeError):
    """A replica died WHILE the router was talking to it (its process
    exited, its transport tore or timed out).  Raised by ReplicaHandle
    methods; the router turns it into the same crash eviction a raise
    from ``step()`` produces, then retries placement on survivors."""


class ReplicaHandle:
    """The uniform contract the Router drives a replica through.  Two
    implementations: :class:`EngineReplica` (in-process, the default)
    and ``serving.worker.ProcReplica`` (a spawned worker process over
    the framed socket transport).  The router holds no
    transport-specific branches — every abnormal condition surfaces as
    either a raise from ``step()``/``add_request()`` (→ crash eviction
    / re-placement, :class:`ReplicaGone` included) or a stale
    heartbeat file (→ hang eviction)."""

    name = "?"

    def step(self):
        """One driver iteration.  Returns the engine step summary dict
        (or None when idle); a raise means the replica crashed."""
        raise NotImplementedError

    def add_request(self, prompt_ids, **kw):
        """Queue one request; returns a request handle whose
        ``generated`` list (seeded with any resume tokens, so its
        length is the absolute stream position) and ``finish_reason``
        the router reads.  Raises ShedRequest / ValueError /
        PoolExhausted like the engine, or ReplicaGone when the replica
        died mid-call."""
        raise NotImplementedError

    def cancel(self, req):
        """Best-effort abort of a queued/running request."""
        raise NotImplementedError

    def load(self):
        """Load score tuple from the engine's own gauges:
        (queue_depth, running, -free_blocks) — lower is less loaded."""
        raise NotImplementedError

    def beat(self):
        """Arm the heartbeat file (spawn-time).  Replicas that beat
        from their own loop (worker processes) leave this a no-op and
        rely on the spawn grace window instead."""

    def wait_ready(self, timeout=None):
        """Block until the replica can accept work (True), or the
        timeout expires (False).  In-process replicas are born ready;
        a worker process becomes ready once it has imported and built
        its engine; until then
        ``add_request`` sheds with reason ``replica_warming``."""
        return True

    def metrics_snapshot(self):
        """This replica's serving_* metrics records (the engine
        snapshot API; an RPC for worker replicas)."""
        return []

    def drain(self, ttl_s=None):
        """Engine-level graceful drain; returns its summary dict."""
        return {}

    def abort(self):
        """Evicted (crash or hang): tear the replica down NOW — for a
        worker process, TERM→KILL escalation plus reap, so no orphan
        survives the router.  Must never raise."""

    def close(self):
        """Graceful release; returns the engine's ``check_leaks()``
        tuple (or (None, None) when the replica could not report)."""
        return None


class EngineReplica(ReplicaHandle):
    """One in-process replica: an engine plus the liveness contract —
    beat the heartbeat file every *scheduler-loop* iteration.  The
    chaos sites live here because this is the process boundary a real
    deployment would kill or wedge."""

    def __init__(self, name, engine, hb_path):
        self.name = name
        self.engine = engine
        self.heartbeat = hb.Heartbeat(hb_path)
        self.hung = False
        self.hung_t = None

    def step(self):
        """One driver-loop iteration: beat, then advance the engine.
        Returns the engine's step summary (None when idle/hung)."""
        if not self.hung and chaos.fire("serving.replica_hang",
                                        tag=self.name):
            self.hung = True
            self.hung_t = time.monotonic()
        if self.hung:
            # wedged: no progress AND no beat — exactly the silence the
            # router's BeatWatch turns into a hang eviction
            return None
        if chaos.fire("serving.replica_kill", tag=self.name):
            raise chaos.ChaosInterrupt(
                f"serving.replica_kill#{self.name}")
        self.heartbeat.beat()
        if self.engine.has_work:
            return self.engine.step()
        return None

    # ------------------------------------------- ReplicaHandle interface
    def beat(self):
        self.heartbeat.beat()

    def add_request(self, prompt_ids, **kw):
        return self.engine.add_request(prompt_ids, **kw)

    def cancel(self, req):
        self.engine.cancel(req)

    def load(self):
        eng = self.engine
        return (eng.scheduler.queue_depth, len(eng.scheduler.running),
                -eng.pool.free_blocks)

    def metrics_snapshot(self):
        return self.engine.metrics_snapshot()

    def drain(self, ttl_s=None):
        return self.engine.drain(ttl_s=ttl_s)

    def close(self):
        return self.engine.close()


class _ReplicaSlot:
    """Router-side bookkeeping for one replica position: the live
    handle, its beat watch, and the restart policy state."""

    def __init__(self, name, hb_path, crash_loop):
        self.name = name
        self.hb_path = hb_path
        self.handle = None
        self.watch = None
        self.state = DEAD
        self.respawns = 0         # completed respawns (backoff attempt)
        self.respawn_at = 0.0
        self.crash_loop = crash_loop


class RoutedRequest:
    """The client-facing handle: the router's source of truth for what
    the client has actually been streamed (`emitted`), which survives
    replica death and is what failover resumes from."""

    _next_id = 0

    def __init__(self, prompt_ids, max_new_tokens, session_id=None,
                 on_token=None, on_finish=None, queue_deadline_s=None,
                 ttl_s=None, **params):
        self.id = RoutedRequest._next_id
        RoutedRequest._next_id += 1
        self.prompt = [int(t) for t in prompt_ids]
        self.max_new_tokens = int(max_new_tokens)
        self.session_id = session_id
        self.on_token = on_token
        self.on_finish = on_finish
        self.queue_deadline_s = queue_deadline_s
        self.ttl_s = ttl_s
        self.params = params        # eos/sampling kwargs, passed through

        self.emitted = []           # tokens DELIVERED to the client
        self.slot = None
        self.engine_req = None
        self.failovers = 0
        self.state = "live"         # live | finished | failed | expired
        self.finish_reason = None
        self.replica_names = []     # every replica that served this req
        self.unplaced_since = None  # waiting at the router for a replica
        self.arrival_t = time.monotonic()
        self.first_token_t = None
        self.last_token_t = None

    def __repr__(self):
        return (f"RoutedRequest(id={self.id}, state={self.state}, "
                f"emitted={len(self.emitted)}, "
                f"failovers={self.failovers})")


class Router:
    """Front process over N engine replicas: least-loaded admission,
    session affinity, heartbeat health, failover re-prefill, backoff
    respawn with crash-loop abort, and two-level load shedding."""

    def __init__(self, engine_factory, replicas=2, heartbeat_timeout=5.0,
                 heartbeat_dir=None, respawn=True, backoff=None,
                 crash_loop_threshold=3, crash_loop_window=60.0,
                 failover_overlap=1, warm_start=None,
                 replica_factory=None, spawn_grace_s=None):
        self._factory = engine_factory
        # replica_factory(name, hb_path, respawning=) -> ReplicaHandle
        # replaces the default in-process EngineReplica build: how a
        # process-per-replica tier installs serving.worker.ProcReplica
        # (engine_factory and warm_start are then unused and may be None;
        # a worker warm-starts from its spec's load_aot)
        self._replica_factory = replica_factory
        # grace window for a replica's FIRST heartbeat after (re)spawn:
        # a worker process importing + compiling must not be evicted as
        # hung before it ever had a chance to beat (None = the plain
        # heartbeat timeout, the in-process behavior)
        self.spawn_grace_s = (None if spawn_grace_s is None
                              else float(spawn_grace_s))
        self.heartbeat_timeout = float(heartbeat_timeout)
        self._own_hb_dir = heartbeat_dir is None
        self.hb_dir = heartbeat_dir or tempfile.mkdtemp(
            prefix="pt_router_hb_")
        os.makedirs(self.hb_dir, exist_ok=True)
        self.respawn = bool(respawn)
        self.backoff = backoff if backoff is not None else \
            Backoff(base=0.5, factor=2.0, max_delay=30.0)
        # overlap>0 re-generates the stream tail on the survivor so the
        # router can PROVE the resumed stream matches before new tokens
        # flow; 0 trusts the resume invariant blindly
        self.failover_overlap = max(0, int(failover_overlap))
        self._warm_start = warm_start
        self._slots = [
            _ReplicaSlot(f"r{i}",
                         os.path.join(self.hb_dir, f"hb.r{i}"),
                         CrashLoopDetector(threshold=crash_loop_threshold,
                                           window=crash_loop_window))
            for i in range(int(replicas))]
        self._requests = []         # live RoutedRequests
        self._unplaced = []         # orphans waiting for a survivor
        # session -> slot, LRU-bounded: a tier that runs for months over
        # millions of sessions must not grow a dict forever; losing the
        # oldest mapping only costs one re-placement, not correctness
        self._affinity = collections.OrderedDict()
        self._affinity_cap = 10_000
        self._draining = False
        self._closed = False
        self.events = []            # (drills) evict/respawn/abandon log
        self._reg = _metrics.registry()
        for slot in self._slots:
            self._spawn(slot)
        self._update_gauges()

    # ------------------------------------------------------------ replicas
    def _spawn(self, slot, respawning=False):
        if self._replica_factory is not None:
            slot.handle = self._replica_factory(slot.name, slot.hb_path,
                                                respawning=respawning)
        else:
            engine = self._factory()
            if self._warm_start is not None:
                try:
                    self._warm_start(engine)
                    if respawning:
                        self._reg.counter(
                            "router_respawn_warm_start_total").inc()
                except Exception as e:   # warm start is best-effort
                    warnings.warn(f"router replica {slot.name} warm "
                                  f"start failed ({e}); serving eagerly",
                                  UserWarning)
            slot.handle = EngineReplica(slot.name, engine, slot.hb_path)
            slot.handle.beat()     # live file before any staleness
        slot.watch = hb.BeatWatch(slot.hb_path, self.heartbeat_timeout,
                                  grace=self.spawn_grace_s)
        slot.state = HEALTHY
        if respawning:
            slot.respawns += 1
            self._reg.counter("router_respawns_total").inc()
            self.events.append({"event": "respawn", "replica": slot.name,
                                "attempt": slot.respawns,
                                "t": time.monotonic()})

    def _evict(self, slot, cause, error=None):
        """Remove a dead/hung replica, schedule (or abandon) its
        respawn, and fail its in-flight work over to survivors."""
        now = time.monotonic()
        self._reg.counter("router_replica_evicted_total",
                          cause=cause).inc()
        self.events.append({
            "event": "evict", "replica": slot.name, "cause": cause,
            "t": now, "error": None if error is None else repr(error),
            "silent_for": slot.watch.silent_for if slot.watch else None})
        orphans = [rr for rr in self._requests
                   if rr.state == "live" and rr.slot is slot]
        # the dead replica's pool dies with it (in a real deployment the
        # process is gone) — leak accounting applies to SURVIVORS.
        # abort() makes "gone" true: a worker process is TERM→KILLed and
        # reaped here, so neither a crash NOR a hang eviction can leave
        # an orphan process behind (in-process replicas no-op)
        if slot.handle is not None:
            try:
                slot.handle.abort()
            except Exception:        # the contract says "never raises";
                pass                 # a broken handle must not block evict
        slot.handle = None
        slot.watch = None
        if slot.crash_loop.record_failure():
            slot.state = ABANDONED
            self._reg.counter("router_crash_loop_aborts_total").inc()
            self.events.append({"event": "abandon", "replica": slot.name,
                                "failures": slot.crash_loop.recent_failures,
                                "t": now})
        elif self.respawn:
            slot.state = RESPAWNING
            slot.respawn_at = now + self.backoff.delay(slot.respawns)
        else:
            slot.state = DEAD
        for rr in orphans:
            rr.slot = None
            rr.engine_req = None
            rr.failovers += 1
            self._reg.counter("router_failover_requests_total").inc()
            if not self._place(rr):
                rr.unplaced_since = now
                self._unplaced.append(rr)

    def _process_respawns(self, now):
        for slot in self._slots:
            if slot.state == RESPAWNING and now >= slot.respawn_at:
                self._spawn(slot, respawning=True)

    def _healthy(self):
        return [s for s in self._slots if s.state == HEALTHY]

    @staticmethod
    def _load(slot):
        """Load score from the same numbers the engine's gauges export:
        queue depth first, then in-flight requests, pool headroom as the
        tie-break (more free blocks = less loaded).  Worker replicas
        report the gauges they last shipped over the transport."""
        return slot.handle.load()

    # ------------------------------------------------------------ requests
    def submit(self, prompt_ids, max_new_tokens=20, session_id=None,
               on_token=None, on_finish=None, queue_deadline_s=None,
               ttl_s=None, **params):
        """Route one request.  Returns the RoutedRequest handle, or
        raises :class:`ShedRequest` when the router (or every healthy
        replica) refuses — a structured refusal, nothing allocated."""
        if self._closed:
            raise RuntimeError("router is closed")
        now = time.monotonic()
        self._process_respawns(now)
        if self._draining:
            self._reg.counter("router_requests_shed_total",
                              reason="draining").inc()
            raise ShedRequest("draining")
        rr = RoutedRequest(prompt_ids, max_new_tokens,
                           session_id=session_id, on_token=on_token,
                           on_finish=on_finish,
                           queue_deadline_s=queue_deadline_s, ttl_s=ttl_s,
                           **params)
        if not self._healthy():
            self._reg.counter("router_requests_shed_total",
                              reason="no_healthy_replica").inc()
            raise ShedRequest("no_healthy_replica",
                              replicas={s.name: s.state
                                        for s in self._slots})
        placed, last_shed = self._try_place(rr)
        if not placed:
            reason = last_shed.reason if last_shed is not None \
                else "no_healthy_replica"
            self._reg.counter("router_requests_shed_total",
                              reason=reason).inc()
            detail = dict(last_shed.detail) if last_shed is not None else {}
            detail["replicas_tried"] = len(self._healthy())
            raise ShedRequest(reason, **detail)
        self._requests.append(rr)
        return rr

    def _try_place(self, rr):
        """Least-loaded placement with affinity-first ordering; returns
        (placed, last ShedRequest or None)."""
        slots = self._healthy()
        aff = self._affinity.get(rr.session_id) \
            if rr.session_id is not None else None
        order = []
        if aff is not None and aff.state == HEALTHY:
            order.append(aff)
        order += sorted((s for s in slots if s is not aff),
                        key=self._load)
        resume = rr.emitted[:len(rr.emitted)
                            - min(self.failover_overlap,
                                  len(rr.emitted))] if rr.failovers \
            else []
        last_shed = None
        for slot in order:
            try:
                ereq = slot.handle.add_request(
                    rr.prompt, max_new_tokens=rr.max_new_tokens,
                    on_token=self._tap_token(rr),
                    on_finish=self._tap_finish(rr),
                    # an EMPTY list still means "resumed" (overlap trim
                    # can consume the whole emitted prefix) — only a
                    # first placement passes None
                    resume_tokens=resume if rr.failovers else None,
                    arrival_t=rr.arrival_t,
                    queue_deadline_s=rr.queue_deadline_s,
                    ttl_s=rr.ttl_s,
                    shed_exempt=rr.failovers > 0,
                    **rr.params)
            except ShedRequest as e:
                last_shed = e
                continue
            except ReplicaGone as e:
                # the replica died under the placement call (worker
                # process gone / transport torn): same crash eviction a
                # step() raise produces, then keep trying survivors
                if slot.state == HEALTHY:
                    self._evict(slot, "crash", error=e)
                continue
            rr.slot = slot
            rr.engine_req = ereq
            rr.replica_names.append(slot.name)
            if rr.session_id is not None:
                if slot is aff:
                    self._reg.counter("router_affinity_hits_total").inc()
                self._affinity[rr.session_id] = slot
                self._affinity.move_to_end(rr.session_id)
                while len(self._affinity) > self._affinity_cap:
                    self._affinity.popitem(last=False)
            self._reg.counter("router_requests_routed_total",
                              replica=slot.name).inc()
            return True, None
        return False, last_shed

    def _place(self, rr):
        placed, _ = self._try_place(rr)
        return placed

    # ---------------------------------------------------------- streaming
    def _tap_token(self, rr):
        def tap(ereq, tok):
            if rr.state != "live" or ereq is not rr.engine_req:
                return              # stale stream from a replaced req
            # the engine request's `generated` already includes the
            # seeded resume tokens, so its length IS the absolute
            # stream position (+1) of this token
            pos = len(ereq.generated) - 1
            now = time.monotonic()
            if pos < len(rr.emitted):
                # failover overlap: the survivor re-generated a token
                # the client already has.  Dedup it — and require it to
                # MATCH, or the "identical stream" invariant is broken
                # and the request must fail loudly, not fork silently.
                if tok != rr.emitted[pos]:
                    self._reg.counter(
                        "router_failover_token_mismatch_total").inc()
                    self._settle(rr, "failed", "failover-mismatch")
                    rr.slot.handle.cancel(ereq)
                else:
                    self._reg.counter("router_failover_dedup_total").inc()
                return
            rr.emitted.append(tok)
            if rr.first_token_t is None:
                rr.first_token_t = now
                self._reg.histogram("router_ttft_seconds").observe(
                    now - rr.arrival_t)
            else:
                self._reg.histogram("router_tpot_seconds").observe(
                    now - rr.last_token_t)
            rr.last_token_t = now
            self._client_call(rr, rr.on_token, rr, tok)
        return tap

    def _client_call(self, rr, fn, *args):
        """Run a CLIENT callback in isolation: an exception here (a
        closed stream, a client bug) must fail THAT request, never
        propagate into engine.step where the router would misread it as
        a replica crash and start evicting healthy replicas."""
        if fn is None:
            return
        try:
            fn(*args)
        except Exception as e:
            self._reg.counter("router_client_callback_errors_total").inc()
            warnings.warn(f"router client callback for request {rr.id} "
                          f"raised {e!r}; failing the request",
                          UserWarning)
            if rr.state == "live":
                # settle like every other failure path — on_finish still
                # fires (guarded inside _settle: a broken on_finish is
                # contained), then reclaim the engine-side capacity
                self._settle(rr, "failed", "client_error")
                if rr.engine_req is not None and rr.slot is not None \
                        and rr.slot.state == HEALTHY:
                    rr.slot.handle.cancel(rr.engine_req)

    def _tap_finish(self, rr):
        def tap(ereq):
            if rr.state != "live" or ereq is not rr.engine_req:
                return
            reason = ereq.finish_reason
            if reason == "cancelled":
                return              # router-initiated; already settled
            if reason in ("eos", "length"):
                self._settle(rr, "finished", reason)
            elif reason == "error":
                self._settle(rr, "failed", reason)
            else:                   # expired-queue / expired-ttl / drained
                self._settle(rr, "expired", reason)
        return tap

    def _settle(self, rr, state, reason):
        rr.state = state
        rr.finish_reason = reason
        self._reg.counter("router_requests_completed_total",
                          outcome=state).inc()
        if rr.on_finish is not None:
            try:
                rr.on_finish(rr)
            except Exception as e:   # already settled: count + contain
                self._reg.counter(
                    "router_client_callback_errors_total").inc()
                warnings.warn(f"router on_finish for request {rr.id} "
                              f"raised {e!r}", UserWarning)

    # ---------------------------------------------------------------- step
    @property
    def has_work(self):
        return any(rr.state == "live" for rr in self._requests)

    def step(self):
        """One router iteration: respawns due → drive every healthy
        replica (a raise = crash eviction) → heartbeat staleness (hang
        eviction) → retry unplaced orphans → gauges."""
        now = time.monotonic()
        self._process_respawns(now)
        progressed = False
        for slot in self._slots:
            if slot.state != HEALTHY:
                continue
            try:
                summary = slot.handle.step()
            except (chaos.ChaosInterrupt, Exception) as e:  # noqa: B014
                self._evict(slot, "crash", error=e)
                continue
            if summary and (summary.get("decoded")
                            or summary.get("admitted")
                            or summary.get("prefilled")):
                progressed = True
        for slot in self._slots:
            if slot.state == HEALTHY and slot.watch.stale():
                self._evict(slot, "hang")
        self._retry_unplaced(now)
        self._requests = [r for r in self._requests if r.state == "live"]
        self._update_gauges()
        if not progressed and self.has_work:
            time.sleep(0.0005)   # idle spin: let beats/clocks advance

    def _retry_unplaced(self, now):
        still = []
        can_recover = bool(self._healthy()) or any(
            s.state == RESPAWNING for s in self._slots)
        for rr in self._unplaced:
            if rr.state != "live":
                continue
            if rr.ttl_s is not None and now - rr.arrival_t > rr.ttl_s:
                self._settle(rr, "expired", "expired-ttl")
            elif (rr.queue_deadline_s is not None
                  and rr.unplaced_since is not None
                  and now - rr.unplaced_since > rr.queue_deadline_s):
                # waiting at the router for a respawn IS queue wait —
                # the client's queue-deadline bound applies here exactly
                # as it would inside an engine's waiting deque
                self._settle(rr, "expired", "expired-queue")
            elif self._healthy() and self._place(rr):
                pass
            elif not can_recover:
                # nothing left to place on and nothing coming back:
                # fail fast instead of spinning forever
                self._reg.counter("router_requests_shed_total",
                                  reason="no_healthy_replica").inc()
                self._settle(rr, "failed", "no_healthy_replica")
            else:
                still.append(rr)
        self._unplaced = still

    def _update_gauges(self):
        self._reg.gauge("router_replicas_healthy").set(
            len(self._healthy()))
        self._reg.gauge("router_unplaced_requests").set(
            len(self._unplaced))

    def run(self, max_steps=None):
        """Drive step() until every routed request settles."""
        n = 0
        while self.has_work and (max_steps is None or n < max_steps):
            self.step()
            n += 1
        return n

    def wait_ready(self, timeout=None):
        """Block until every healthy replica reports ready (True), or
        the shared `timeout` expires (False).  In-process replicas are
        born ready; worker processes become ready after import and
        engine build; drivers that submit a whole trace up front
        call this first so nothing sheds as ``replica_warming``."""
        deadline = None if timeout is None else \
            time.monotonic() + float(timeout)
        ok = True
        for slot in self._healthy():
            left = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            try:
                ok = bool(slot.handle.wait_ready(timeout=left)) and ok
            except ReplicaGone as e:
                # died while warming (startup crash): the same
                # eviction + backoff-respawn path as any other death
                self._evict(slot, "crash", error=e)
                ok = False
        return ok

    def metrics_snapshot(self):
        """{replica_name: serving_* metrics records} from every live
        replica — the engine snapshot API fanned out over the handles
        (an RPC for worker replicas, whose counters live in their own
        process registries; in-process replicas share THIS process's
        registry, so only merge these for process-per-replica tiers)."""
        out = {}
        for slot in self._slots:
            if slot.handle is None:
                continue
            try:
                out[slot.name] = slot.handle.metrics_snapshot()
            except Exception:        # a dying replica: skip, step() will
                continue             # see the exit code next iteration
        return out

    # ----------------------------------------------------- drain / close
    def drain(self, ttl_s=None):
        """Graceful shutdown: stop admitting (submit sheds with reason
        ``draining``), keep stepping until live requests settle — past
        ``ttl_s``, cancel what remains (reason ``drained``)."""
        self._draining = True
        deadline = None if ttl_s is None else time.monotonic() + ttl_s
        n = 0
        while self.has_work:
            if deadline is not None and time.monotonic() > deadline:
                for rr in [r for r in self._requests
                           if r.state == "live"]:
                    if rr.engine_req is not None and rr.slot is not None \
                            and rr.slot.state == HEALTHY:
                        rr.slot.handle.cancel(rr.engine_req)
                    self._settle(rr, "expired", "drained")
                break
            self.step()
            n += 1
        return {"steps": n}

    def close(self):
        """Release every replica (their engines' pools must come back
        leak-free) and the heartbeat dir.  Returns {replica_name:
        check_leaks()} for the still-live replicas."""
        self._draining = True
        self.respawn = False
        leaks = {}
        for slot in self._slots:
            if slot.handle is not None:
                leaks[slot.name] = slot.handle.close()
                slot.handle = None
            slot.state = DEAD
        if self._own_hb_dir:
            shutil.rmtree(self.hb_dir, ignore_errors=True)
        self._closed = True
        self._update_gauges()
        return leaks
