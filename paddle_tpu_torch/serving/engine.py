"""LLMEngine — continuous (in-flight) batching over the paged KV pool.

Counterpart: `paddle_tpu/serving/engine.py`.  `step()` is one scheduler
iteration: admit -> bounded prefill chunking -> one batched decode step
-> sample / stream / finish.  Long prompts chunk across many steps while
every decode-ready request still advances one token per step.

What differs from the JAX engine, and why the tokens do not:

* Nothing is compiled, so a prefill chunk runs at its exact length (no
  bucket padding) and a decode step carries only the live rows (no dead
  slots); each step's block table is cut to the columns its rows use.
  For a dense model padding and dead slots only ever added masked,
  dropped work.  A GPT-MoE routes every token of a call together, and
  its eval capacity, ceil(2 * top_k * n / E), counts the call's n
  tokens: where E > 2 * top_k a choice can drop because of the other
  tokens of its step, and the JAX engine's pad tokens take capacity
  too.  There the two engines' tokens can differ, and neither stream is
  independent of its batch (ROADMAP.md C); at E <= 2 * top_k nothing
  drops and the tokens agree.
* The pool is updated in place; no pool arrays are handed back.
* Decode steps on CUDA run the hand-written paged decode kernel;
  prefill chunks run the plain gather path, as the JAX engine sends
  them to XLA (`ops.paged_attention`).  Prefill skips the LM head.
* The program inventory is the JAX engine's (`program_keys`: the decode
  program and one prefill program per bucket of the ladder up to
  `prefill_chunk`'s), and `serving.aot` compiles it ahead of time into
  AOTInductor packages (`program_structs` gives each program's builder,
  example inputs and dynamic dims).  A program takes the model's weights
  and the pool as inputs, never as constants, and writes the pool in
  place.  With packages loaded (`_aot_execs`): a prefill chunk runs its
  bucket's program, padded to the bucket, its pad positions dropped by
  the write's `limit`; a decode step runs the decode program, whose rows
  and table columns are dynamic dims (a step passes its live rows and
  cut table, as the eager step does, so there are no dead slots to
  drop).  A call whose inputs the package was not compiled for warns,
  drops the package and runs eagerly (`serving_aot_fallback_total`);
  `retire_aot` drops packages on purpose.  The eager path and a program
  run one function (`_decode_fn`, `_prefill_fn`).
* The chaos sites `serving.request_poison` (here) and
  `serving.pool_exhausted` (`BlockPool.allocate`) are the JAX engine's.

It serves GPT and the LLaMA family (LLaMA, Qwen2; GQA through the paged
kernel).  As the JAX engine does, it refuses a sliding-window model
(Mistral) with NotImplementedError: the pool keeps the full context.

Greedy sampling is argmax; sampled mode filters through
`text.generation.filter_logits` and draws from
`np.random.default_rng([seed, position])`, so a request's draws do not
depend on the batch it rides in (its logits do for a GPT-MoE whose
choices can drop, above).  Telemetry (TTFT, TPOT, queue wait,
decode step time, pool and queue gauges) goes to the port's metrics
registry.
"""
from __future__ import annotations

import functools
import time
import warnings

import numpy as np
import torch

from ..jit.aoti import AOTShapeMismatch, FunctionalProgram, module_weights
from ..observability import metrics as _metrics
from ..resilience import chaos
from ..text.generation import BucketPolicy, filter_logits
from .block_pool import BlockPool, PoolExhausted
from .scheduler import RUNNING, Request, Scheduler


class ShedRequest(RuntimeError):
    """Admission-control refusal.  `reason` names the watermark that
    tripped (``queue_depth`` / ``free_blocks`` / ``draining``); `detail`
    carries the gauge values at refusal time."""

    def __init__(self, reason, **detail):
        self.reason = reason
        self.detail = detail
        extras = ", ".join(f"{k}={v}" for k, v in detail.items())
        super().__init__(f"request shed ({reason}"
                         + (f": {extras}" if extras else "") + ")")


class LLMEngine:
    def __init__(self, model, num_blocks=64, block_size=16, max_running=8,
                 prefill_chunk=64, buckets=None, max_model_len=None,
                 dtype=None, shed_queue_depth=None, shed_free_blocks=None,
                 promote_after=4):
        if getattr(model.cfg, "sliding_window", None):
            raise NotImplementedError(
                "sliding_window models cannot serve from the paged pool "
                "yet (the pool keeps the full context)")
        self.model = model
        model.eval()
        self.pool = BlockPool.for_model(model, num_blocks,
                                        block_size=block_size, dtype=dtype)
        self.device = self.pool.k[0].device
        self.scheduler = Scheduler(self.pool, max_running=max_running,
                                   promote_after=promote_after)
        # admission-control watermarks (None = never shed)
        self.shed_queue_depth = (None if shed_queue_depth is None
                                 else int(shed_queue_depth))
        self.shed_free_blocks = (None if shed_free_blocks is None
                                 else int(shed_free_blocks))
        self._draining = False
        self._closed = False
        self.prefill_chunk = int(prefill_chunk)
        self.policy = buckets if isinstance(buckets, BucketPolicy) \
            else BucketPolicy(buckets=buckets)
        max_pos = getattr(model.cfg, "max_position_embeddings", None)
        self.max_model_len = int(max_model_len or max_pos
                                 or num_blocks * block_size)
        if max_pos is not None:
            self.max_model_len = min(self.max_model_len, int(max_pos))
        self.table_cols = self.pool.blocks_for(self.max_model_len)
        self._weight_names, self._weights = module_weights(model)
        self._aot_execs = {}    # key -> loaded AOTProgram
        self._finished = []
        self._reg = _metrics.registry()

    # ------------------------------------------------------------- requests
    def add_request(self, prompt_ids, max_new_tokens=20, eos_token_id=None,
                    do_sample=False, temperature=1.0, top_k=None,
                    top_p=None, seed=0, on_token=None, on_finish=None,
                    resume_tokens=None, arrival_t=None,
                    queue_deadline_s=None, ttl_s=None, shed_exempt=False):
        """Queue a request; returns the Request handle (its `generated`
        list fills in as `step()` runs; `on_token(req, tok)` streams).

        `resume_tokens` seeds already-generated tokens (a failover
        resume: prompt + resume re-prefill and decoding continues at the
        next position).  `shed_exempt` bypasses the admission watermarks.

        Raises :class:`ShedRequest` when a watermark trips (nothing was
        allocated), ValueError / PoolExhausted for requests that could
        never be served."""
        if self._closed:
            raise RuntimeError("engine is closed")
        prompt = np.asarray(prompt_ids).reshape(-1).astype(np.int64)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        total = len(prompt) + int(max_new_tokens)
        if total > self.max_model_len:
            raise ValueError(
                f"request needs {total} positions but the replica serves "
                f"max_model_len={self.max_model_len}")
        if self.pool.blocks_for(total) > self.pool.num_blocks:
            raise PoolExhausted(
                f"request needs {self.pool.blocks_for(total)} blocks; "
                f"pool has {self.pool.num_blocks} total")
        if resume_tokens and len(resume_tokens) >= int(max_new_tokens):
            raise ValueError(
                f"resume_tokens already holds {len(resume_tokens)} of "
                f"max_new_tokens={max_new_tokens} — nothing left to "
                f"generate")
        if not shed_exempt:
            self._check_shed()
        req = Request(prompt, max_new_tokens=max_new_tokens,
                      eos_token_id=eos_token_id, do_sample=do_sample,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed, on_token=on_token, on_finish=on_finish,
                      resume_tokens=resume_tokens, arrival_t=arrival_t,
                      queue_deadline_s=queue_deadline_s, ttl_s=ttl_s)
        if chaos.fire("serving.request_poison", tag=req.id):
            req.poisoned = True
        self.scheduler.submit(req)
        self._reg.counter("serving_requests_submitted_total").inc()
        return req

    def _check_shed(self):
        """Refuse with a reason BEFORE any allocation when a watermark is
        crossed, so overload costs the client one exception instead of an
        unbounded queue wait."""
        sched = self.scheduler
        if self._draining:
            self._shed("draining", queue_depth=sched.queue_depth)
        if (self.shed_queue_depth is not None
                and sched.queue_depth >= self.shed_queue_depth):
            self._shed("queue_depth", queue_depth=sched.queue_depth,
                       watermark=self.shed_queue_depth)
        # low free blocks sheds only when a backlog already exists
        if (self.shed_free_blocks is not None and sched.queue_depth > 0
                and self.pool.free_blocks < self.shed_free_blocks):
            self._shed("free_blocks", free_blocks=self.pool.free_blocks,
                       watermark=self.shed_free_blocks,
                       queue_depth=sched.queue_depth)

    def _shed(self, reason, **detail):
        self._reg.counter("serving_requests_shed_total",
                          reason=reason).inc()
        raise ShedRequest(reason, **detail)

    @property
    def has_work(self):
        return bool(self.scheduler.waiting or self.scheduler.running)

    def metrics_snapshot(self, prefix="serving_"):
        """The registry records whose name starts with `prefix` (a str or
        a tuple of strs); JSON-serializable."""
        if isinstance(prefix, str):
            prefix = (prefix,)
        return [rec for rec in self._reg.snapshot()
                if rec["name"].startswith(tuple(prefix))]

    def run(self, max_steps=None):
        """Drive step() until the queues drain (or max_steps)."""
        n = 0
        while self.has_work and (max_steps is None or n < max_steps):
            self.step()
            n += 1
        return n

    def generate_batch(self, prompts, max_new_tokens=20, **kw):
        """Submit every prompt, drain, return the generated token lists in
        submission order."""
        reqs = [self.add_request(p, max_new_tokens=max_new_tokens, **kw)
                for p in prompts]
        self.run()
        return [list(r.generated) for r in reqs]

    # ----------------------------------------------------------------- step
    def step(self):
        """One continuous-batching iteration.  Returns a summary dict."""
        sched = self.scheduler
        now = time.monotonic()
        self._expire(now)
        admitted = sched.admit()
        for req in admitted:
            self._reg.counter("serving_requests_admitted_total").inc()
            self._reg.histogram("serving_queue_wait_seconds").observe(
                now - req.arrival_t)

        # ---- prefill lane: a bounded token budget per step
        budget = self.prefill_chunk
        prefilled = 0
        for req in list(sched.running):
            if budget <= 0:
                break
            if not req.needs_prefill:
                continue
            n = min(budget, req.feed_len - 1 - req.ctx)
            self._prefill(req, n)
            budget -= n
            prefilled += n

        # ---- decode lane: every decode-ready request advances one token
        ready = []
        for req in [r for r in sched.running if r.decode_ready]:
            if req.state != RUNNING:
                continue            # a victim of an earlier grow()
            if sched.grow(req):
                ready.append(req)
        ready = [r for r in ready if r.state == RUNNING]
        if ready:
            self._decode(ready)

        self._reg.gauge("serving_queue_depth").set(sched.queue_depth)
        self._reg.gauge("serving_running_requests").set(len(sched.running))
        self._reg.gauge("serving_free_blocks").set(self.pool.free_blocks)
        return {"admitted": len(admitted), "decoded": len(ready),
                "prefilled": prefilled,
                "running": len(sched.running),
                "waiting": sched.queue_depth}

    def _expire(self, now):
        """Queue-wait and TTL expiry are clean finishes: blocks freed,
        `on_finish` fired with the reason."""
        sched = self.scheduler
        for req in list(sched.waiting) + list(sched.running):
            why = req.expiry(now)
            if why is not None:
                self._finish(req, f"expired-{why}")

    # ------------------------------------------------------ drain / close
    def cancel(self, req, reason="cancelled"):
        """Abort a queued or running request: frees its blocks, fires
        `on_finish` with the given reason.  No-op once finished."""
        if req.finish_reason is None:
            self._finish(req, reason)

    def drain(self, ttl_s=None, max_steps=None):
        """Graceful shutdown, phase 1: stop admitting (`add_request` sheds
        with reason ``draining``), expire every queued request, then step
        until running work finishes — or, past ``ttl_s`` seconds, expire
        what remains.  Returns a summary dict."""
        self._draining = True
        already = sum(1 for r in self._finished
                      if r.finish_reason == "drained")
        for req in list(self.scheduler.waiting):
            self._finish(req, "drained")
        deadline = None if ttl_s is None else time.monotonic() + ttl_s
        n = 0
        while self.scheduler.running and \
                (max_steps is None or n < max_steps):
            if deadline is not None and time.monotonic() > deadline:
                for req in list(self.scheduler.running):
                    self._finish(req, "drained")
                break
            self.step()
            n += 1
        return {"steps": n,
                "drained": sum(1 for r in self._finished
                               if r.finish_reason == "drained")
                - already}

    def close(self):
        """Graceful shutdown, phase 2: expire any work still live, then
        release the pool's tensors.  Returns `pool.check_leaks()`."""
        for req in (list(self.scheduler.running)
                    + list(self.scheduler.waiting)):
            self._finish(req, "drained")
        leaks = self.pool.check_leaks()
        self.pool.k = []
        self.pool.v = []
        self._aot_execs.clear()
        self._closed = True
        self._draining = True
        return leaks

    # ------------------------------------------------------------ programs
    def retire_aot(self, key=None):
        """Drop loaded AOT programs (all, or one key): later calls run
        eagerly.  Returns the retired keys."""
        keys = [key] if key is not None else list(self._aot_execs)
        for k in keys:
            self._aot_execs.pop(k, None)
        return keys

    def _run_program(self, key, fn, *args):
        """`fn(model, *args)` (the eager path), or the loaded package of
        `key` on (weights, *args).  A call the package was not compiled
        for warns, drops the package and runs eagerly."""
        prog = self._aot_execs.get(key)
        if prog is not None:
            try:
                out = prog(self._weights, *args)
                self._reg.counter("serving_program_calls_total",
                                  route="aot").inc()
                return out
            except AOTShapeMismatch as e:
                warnings.warn(
                    f"serving AOT program {key} rejected this call ({e}); "
                    f"falling back to the eager path", UserWarning,
                    stacklevel=2)
                del self._aot_execs[key]
                self._reg.counter("serving_aot_fallback_total").inc()
        self._reg.counter("serving_program_calls_total", route="live").inc()
        with torch.no_grad():
            return fn(self.model, *args)

    def program_keys(self, prompt_lens=()):
        """The program inventory a replica needs: the decode program plus
        one prefill program per ladder bucket up to the chunk's bucket
        (the whole sub-ladder: the prefill lane splits one token budget
        across the admitted requests, so every smaller chunk occurs), and
        the buckets of `prompt_lens`' first chunks (the JAX engine's
        `program_keys`)."""
        cap = self.policy.bucket(self.prefill_chunk)
        buckets, n = set(), 1
        while True:
            b = self.policy.bucket(n)
            buckets.add(b)
            if b >= cap:
                break
            n = b + 1
        for n in prompt_lens:
            buckets.add(self.policy.bucket(
                min(max(int(n) - 1, 1), self.prefill_chunk)))
        return [("decode",)] + sorted(("prefill", b) for b in buckets)

    def program_structs(self, key):
        """(builder, example inputs, dynamic dims) of one program for
        `jit.aoti.compile_packages`: `builder()` gives the
        `FunctionalProgram`, whose inputs are the weights and then the
        example inputs.  The decode program takes R live rows and tables
        of M columns (dynamic: R <= max_running, M <= table_cols); a
        prefill program one row of its bucket's tokens, a table of M
        columns and the write limit."""
        ks, vs = list(self.pool.k), list(self.pool.v)
        dev, i32 = self.device, torch.int32
        M = self._dim("M", self.table_cols)
        fixed = [None] * len(ks)
        if key[0] == "decode":
            R = self._dim("R", self.scheduler.max_running)
            r, m = self._example(R), self._example(M)
            args = (self._weights, ks, vs,
                    torch.zeros(r, m, dtype=i32, device=dev),
                    torch.zeros(r, dtype=i32, device=dev),
                    torch.zeros(r, 1, dtype=torch.long, device=dev))
            dynamic = ([None] * len(self._weights), fixed, fixed,
                       _dims({0: R, 1: M}), _dims({0: R}), _dims({0: R}))
            return (functools.partial(FunctionalProgram, self.model,
                                      _decode_fn, self._weight_names),
                    args, dynamic)
        if key[0] == "prefill":
            m = self._example(M)
            args = (self._weights, ks, vs,
                    torch.zeros(1, m, dtype=i32, device=dev),
                    torch.zeros(1, dtype=i32, device=dev),
                    torch.zeros(1, int(key[1]), dtype=torch.long,
                                device=dev),
                    torch.ones(1, dtype=i32, device=dev))
            dynamic = ([None] * len(self._weights), fixed, fixed,
                       _dims({1: M}), None, None, None)
            return (functools.partial(FunctionalProgram, self.model,
                                      _prefill_fn, self._weight_names),
                    args, dynamic)
        raise KeyError(f"unknown serving program key {key!r}")

    @staticmethod
    def _dim(name, hi):
        """A dynamic dim of bounds [1, hi]; None (static) when hi is 1."""
        return None if hi <= 1 else (name, 1, int(hi))

    @staticmethod
    def _example(dim):
        """An example size for a dim: 2 for a dynamic one (export
        specializes sizes 0 and 1), else 1."""
        return 1 if dim is None else 2

    # ------------------------------------------------------------ forward
    def _inputs(self, tables, pos):
        return (torch.from_numpy(tables).to(self.device),
                torch.from_numpy(pos).to(self.device))

    def _tables(self, reqs, n_tokens):
        """[len(reqs), M] int32 block tables cut to the columns that hold
        each row's first n_tokens[i] positions (padded with block 0)."""
        cols = [self.pool.blocks_for(n) for n in n_tokens]
        tables = np.zeros((len(reqs), max(cols)), np.int32)
        for i, (req, c) in enumerate(zip(reqs, cols)):
            tables[i, :c] = req.block_table[:c]
        return tables

    def _prefill(self, req, n):
        """Write chunk n of the request's feed into the pool: eagerly at
        its exact length, or through its bucket's program, padded, with
        the pad positions dropped by the write limit."""
        chunk = req.feed_tokens()[req.ctx:req.ctx + n]
        bucket = self.policy.bucket(n)
        key = ("prefill", bucket)
        table, pos = self._inputs(self._tables([req], [req.ctx + n]),
                                  np.asarray([req.ctx], np.int32))
        if key in self._aot_execs:
            ids = np.zeros((1, bucket), np.int64)
            ids[0, :n] = chunk
            tokens = torch.from_numpy(ids).to(self.device)
            limit = torch.tensor([req.ctx + n], dtype=torch.int32,
                                 device=self.device)
        else:
            tokens = torch.tensor([chunk], dtype=torch.long,
                                  device=self.device)
            limit = None
        self._run_program(key, _prefill_fn, self.pool.k, self.pool.v,
                          table, pos, tokens, limit)
        req.ctx += n
        self._reg.counter("serving_prefill_tokens_total").inc(n)

    def _decode(self, ready):
        t0 = time.monotonic()
        pos = np.asarray([req.ctx for req in ready], np.int32)
        tokens = torch.tensor([[req.feed_tokens()[req.ctx]] for req in ready],
                              dtype=torch.long, device=self.device)
        table, pos_t = self._inputs(self._tables(ready, pos + 1), pos)
        logits = self._run_program(("decode",), _decode_fn, self.pool.k,
                                   self.pool.v, table, pos_t, tokens)
        rows = logits.cpu().numpy()
        now = time.monotonic()
        self._reg.counter("serving_decode_steps_total").inc()
        self._reg.histogram("serving_decode_batch").observe(len(ready))
        self._reg.histogram("serving_decode_step_seconds").observe(now - t0)
        for i, req in enumerate(ready):
            req.ctx += 1
            self._emit(req, rows[i], now)

    def _emit(self, req, logits_row, now):
        if req.poisoned:
            # chaos serving.request_poison: this request's logits are
            # ruined; the guard below fails IT, not the batch
            logits_row = np.full_like(logits_row, np.nan)
        if not np.isfinite(logits_row).all():
            # non-finite logits fail THIS request, not the batch
            self._finish(req, "error")
            return
        tok = _sample_row(req, logits_row)
        req.generated.append(tok)
        if req.first_token_t is None:
            req.first_token_t = now
            if not req.resumed:
                self._reg.histogram("serving_ttft_seconds").observe(
                    now - req.arrival_t)
        elif req.last_token_t is not None:
            self._reg.histogram("serving_tpot_seconds").observe(
                now - req.last_token_t)
        req.last_token_t = now
        self._reg.counter("serving_tokens_generated_total").inc()
        if req.on_token is not None:
            req.on_token(req, tok)
            if req.finish_reason is not None:
                return    # the callback cancelled/finished the request
        if req.eos_token_id is not None and tok == req.eos_token_id:
            self._finish(req, "eos")
        elif len(req.generated) >= req.max_new_tokens:
            self._finish(req, "length")

    def _finish(self, req, reason):
        if req.finish_reason is not None:
            return        # already settled: finishing is idempotent
        self.scheduler.finish(req, reason)
        self._finished.append(req)
        if reason in ("eos", "length"):
            self._reg.counter("serving_requests_finished_total").inc()
        elif reason == "drained":
            self._reg.counter("serving_requests_expired_total",
                              where="drain").inc()
        elif reason.startswith("expired-"):
            self._reg.counter("serving_requests_expired_total",
                              where=reason[len("expired-"):]).inc()
        else:
            self._reg.counter("serving_requests_failed_total").inc()
        if req.on_finish is not None:
            req.on_finish(req)


def _dims(d):
    """{dim: (name, lo, hi)} without the static dims (None entries)."""
    d = {i: v for i, v in d.items() if v is not None}
    return d or None


def _caches(ks, vs, table, pos, limit=None):
    caches = [{"k": k, "v": v, "table": table, "pos": pos}
              for k, v in zip(ks, vs)]
    if limit is not None:
        for c in caches:
            c["limit"] = limit
    return caches


def _decode_fn(model, ks, vs, table, pos, tokens):
    """One decode step: tokens [R, 1] at positions pos [R] through block
    tables [R, M]; writes the pool in place and returns the float32
    logits [R, vocab] of the step."""
    logits = model(tokens, caches=_caches(ks, vs, table, pos))
    return logits[:, -1, :].float()


def _prefill_fn(model, ks, vs, table, pos, tokens, limit=None):
    """One prefill chunk: tokens [1, s] at positions pos .. pos + s - 1
    written into the pool, the LM head skipped.  With `limit` (a padded
    chunk) positions at or past it write nothing, and the position ids of
    a GPT are clamped to its table (pad positions only; the JAX gather
    clamps them the same way).  Returns the 0-d count of written
    positions with `limit` (the program's one output), else None."""
    caches = _caches(ks, vs, table, pos, limit)
    if hasattr(model, "gpt"):
        pids = None
        if limit is not None:
            pids = (pos.long()[:, None] + torch.arange(
                tokens.shape[1], device=tokens.device)[None, :]).clamp(
                max=model.cfg.max_position_embeddings - 1)
        model.gpt(tokens, position_ids=pids, caches=caches)
    else:
        model.llama(tokens, caches=caches)
    return None if limit is None else (limit - pos).sum()


def _sample_row(req, logits_row):
    """Host-side sampling from one float32 logits row.  Greedy is argmax;
    sampled mode filters through `filter_logits` and draws from a numpy
    Generator seeded per (request seed, POSITION), so the draw does not
    depend on batch composition and survives a resume."""
    if not req.do_sample:
        return int(np.argmax(logits_row))
    filtered = filter_logits(torch.from_numpy(logits_row)[None, :],
                             req.temperature, req.top_k, req.top_p)[0]
    p = torch.softmax(filtered, dim=-1).double().numpy()
    p = p / p.sum()      # exact renormalization for rng.choice
    rng = np.random.default_rng([req.seed, len(req.generated)])
    return int(rng.choice(len(p), p=p))
