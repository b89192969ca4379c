"""Request lifecycle + continuous-batching scheduler.

Counterpart: `paddle_tpu/serving/scheduler.py`, copied in behaviour:

* **Admission** is FCFS from the waiting deque: a request is admitted
  when a decode slot is open and the pool can hand it blocks for its
  whole current prefix plus the first decode token.  Preempted requests
  rejoin the FRONT of the queue.
* **Preemption** is LIFO: when a running request needs one more block
  and the pool is dry, the YOUNGEST other running request is evicted
  (its blocks freed now, its prefix re-prefilled on readmission).
* **Aging**: a request preempted or head-of-line blocked
  ``promote_after`` times in all is PROMOTED — immune to preemption by
  non-promoted requests (promoted requesters may still evict each
  other, so the pool never deadlocks).
* **Deadlines**: ``queue_deadline_s`` bounds one continuous wait in the
  queue (re-armed on preemption), ``ttl_s`` the whole lifetime from
  arrival; expiry is a clean finish with reason ``expired-queue`` /
  ``expired-ttl``.
"""
from __future__ import annotations

import collections
import time

from ..observability import metrics as _metrics

WAITING = "waiting"
RUNNING = "running"
PREEMPTED = "preempted"
FINISHED = "finished"
FAILED = "failed"
EXPIRED = "expired"


class Request:
    """One generation request moving through the engine."""

    _next_id = 0

    def __init__(self, prompt_ids, max_new_tokens=20, eos_token_id=None,
                 do_sample=False, temperature=1.0, top_k=None, top_p=None,
                 seed=0, on_token=None, on_finish=None, resume_tokens=None,
                 arrival_t=None, queue_deadline_s=None, ttl_s=None):
        self.id = Request._next_id
        Request._next_id += 1
        self.prompt = [int(t) for t in prompt_ids]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.seed = int(seed)
        self.on_token = on_token
        self.on_finish = on_finish

        self.state = WAITING
        # `resume_tokens` seeds `generated` with tokens a prior replica
        # already produced: re-prefill streams prompt + generated and
        # decode continues at the next position
        self.generated = [int(t) for t in (resume_tokens or [])]
        self.resumed = resume_tokens is not None
        self.block_table = []       # pool block ids, position-ordered
        self.ctx = 0                # tokens whose K/V live in the pool
        self.finish_reason = None
        self.preemptions = 0
        self.admit_skips = 0        # head-of-line blocked admit passes
        self.promoted = False       # aging: immune to victim selection
        self.poisoned = False       # chaos serving.request_poison

        self.arrival_t = (time.monotonic() if arrival_t is None
                          else float(arrival_t))
        self.queued_t = time.monotonic()   # start of the CURRENT wait
        self.queue_deadline_s = (None if queue_deadline_s is None
                                 else float(queue_deadline_s))
        self.ttl_s = None if ttl_s is None else float(ttl_s)
        self.first_token_t = None
        self.last_token_t = None

    # `feed` = every token the model must consume: the prompt plus all
    # generated tokens.  Invariant: `ctx` tokens have K/V in the pool and
    # feed[ctx] is the next input.  Prefill streams feed[0:feed_len-1]
    # into the pool in chunks; the decode step consumes feed[ctx], writes
    # its K/V and samples the next token — one decode path does all
    # sampling, for fresh and for preempted-then-resumed requests alike.
    @property
    def feed_len(self):
        return len(self.prompt) + len(self.generated)

    @property
    def decode_ready(self):
        return self.state == RUNNING and self.ctx == self.feed_len - 1

    @property
    def needs_prefill(self):
        return self.state == RUNNING and self.ctx < self.feed_len - 1

    def feed_tokens(self):
        return self.prompt + self.generated

    def expiry(self, now):
        """``"ttl"`` / ``"queue"`` when a deadline has passed, else None."""
        if self.ttl_s is not None and now - self.arrival_t > self.ttl_s:
            return "ttl"
        if (self.queue_deadline_s is not None
                and self.state in (WAITING, PREEMPTED)
                and now - self.queued_t > self.queue_deadline_s):
            return "queue"
        return None

    def __repr__(self):
        return (f"Request(id={self.id}, state={self.state}, "
                f"prompt={len(self.prompt)}, gen={len(self.generated)}, "
                f"ctx={self.ctx})")


class Scheduler:
    """Admission / eviction / preemption against the block pool."""

    def __init__(self, pool, max_running=8, promote_after=4):
        self.pool = pool
        self.max_running = int(max_running)
        # skips (preemptions + head-blocked admit passes) before a
        # request is promoted out of the victim pool; 0/None disables
        self.promote_after = int(promote_after or 0)
        self.waiting = collections.deque()
        self.running = []           # admission-ordered (oldest first)

    @property
    def queue_depth(self):
        return len(self.waiting)

    def submit(self, req):
        req.state = WAITING
        req.queued_t = time.monotonic()
        self.waiting.append(req)

    def admit(self):
        """Move waiting requests into the running set while slots and
        blocks last.  Returns the newly admitted requests."""
        admitted = []
        while self.waiting and len(self.running) < self.max_running:
            req = self.waiting[0]
            # blocks for the whole prefix plus one decode token, so
            # admission can't strand a request mid-prefill
            blocks = self.pool.allocate(self.pool.blocks_for(req.feed_len + 1))
            if blocks is None:
                req.admit_skips += 1
                self._maybe_promote(req)
                break
            self.waiting.popleft()
            req.block_table = blocks
            req.ctx = 0
            req.state = RUNNING
            self.running.append(req)
            admitted.append(req)
        return admitted

    def grow(self, req):
        """Ensure `req` has a block for its next token; preempts the
        youngest OTHER running request when the pool is dry.  Returns
        False when no space could be made (req retries next step)."""
        need_blocks = self.pool.blocks_for(req.feed_len)
        while len(req.block_table) < need_blocks:
            got = self.pool.allocate(1)
            if got is not None:
                req.block_table.extend(got)
                continue
            victim = self._pick_victim(exclude=req,
                                       allow_promoted=req.promoted)
            if victim is None:
                return False
            self.preempt(victim)
        return True

    def _pick_victim(self, exclude, allow_promoted=False):
        """Youngest running request that isn't `exclude` and isn't
        promoted; a promoted requester may fall back to a promoted
        victim (youngest first)."""
        for cand in reversed(self.running):
            if cand is not exclude and not cand.promoted:
                return cand
        if allow_promoted:
            for cand in reversed(self.running):
                if cand is not exclude:
                    return cand
        return None

    def _maybe_promote(self, req):
        if (self.promote_after and not req.promoted
                and req.preemptions + req.admit_skips
                >= self.promote_after):
            req.promoted = True
            _metrics.registry().counter(
                "serving_starvation_promotions_total").inc()

    def preempt(self, req):
        """Evict: free every block now, requeue at the FRONT; the prefix
        (prompt + generated so far) re-prefills on readmission."""
        _metrics.registry().counter("serving_requests_preempted_total").inc()
        self.pool.free(req.block_table)
        req.block_table = []
        req.ctx = 0
        req.preemptions += 1
        req.state = PREEMPTED
        req.queued_t = time.monotonic()   # re-arm the queue-wait clock
        self._maybe_promote(req)
        self.running.remove(req)
        self.waiting.appendleft(req)

    def finish(self, req, reason):
        if req.block_table:
            self.pool.free(req.block_table)
            req.block_table = []
        if reason in ("eos", "length"):
            req.state = FINISHED
        elif reason in ("error", "cancelled"):
            req.state = FAILED
        else:                       # expired-queue / expired-ttl / drained
            req.state = EXPIRED
        req.finish_reason = reason
        if req in self.running:
            self.running.remove(req)
        try:
            self.waiting.remove(req)
        except ValueError:
            pass
