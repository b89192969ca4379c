"""KV-cache updates and the decode loops over preallocated caches.

Counterpart: `paddle_tpu/text/decode.py`.  A preallocated cache is
{"k": [b, max_len, Hkv, D], "v": ..., "pos": int tensor}, its sequence
slot written at `pos` (`ops.dyn_update_seq`, in place) and its attention
masked to `col <= pos + row`: static shapes throughout.

* `jit_generate` — in the JAX package prefill and the whole token loop
  are one XLA program.  Here the prefill runs eagerly, then the
  single-token decode step over the preallocated caches is captured once
  as a `torch.cuda.CUDAGraph` and replayed for each token.  The step's
  input token, its `pos`, the output ids and the finished flags live in
  static device buffers: the graph itself writes the next token and
  advances `pos`, so a step makes no host round trip.  With an eos the
  host reads the finished flags once a step, to stop early as the JAX
  `while_loop`'s cond does.  On the CPU the same static step runs
  without capture.  A capture that fails raises; nothing falls back to
  the uncaptured step.  Built programs (caches, buffers, graph) are kept
  per model in an LRU of 8 keyed as the JAX `cache_key` is.
* `jit_beam_search` and `speculative_generate` run their steps eagerly
  over the preallocated caches (the JAX package compiles each loop into
  one program); their steps are not captured.

Sampling draws from an explicit `torch.Generator` (None: the device's
default generator); a captured step registers the generator with its
graph, so every replay draws anew.  JAX's threefry and torch's Philox
streams never match: sampled tokens differ from the JAX package's, and
only greedy decoding is token-identical.
"""
from __future__ import annotations

import contextlib

import torch

from .. import ops
from ..ops import paged_write
from .generation import _gumbel_argmax, _sample_next, filter_logits


def _lru_compiled(store, key, build, cap=8):
    """Pop-reinsert LRU over a dict of built programs."""
    fn = store.pop(key, None)
    if fn is None:
        fn = build()
    store[key] = fn
    while len(store) > cap:
        store.pop(next(iter(store)))
    return fn


def _update_prealloc_cache(cache, k, v, s, window=None):
    """Write k/v [b, s, Hkv, D] at cache["pos"] IN PLACE and return the
    full buffers and a bool attention mask (True keeps).  `pos` is a 0-d
    tensor (one offset, mask [1, 1, s, L]) or a [b] tensor (per-row
    offsets, mask [b, 1, s, L]).  With `window` (sliding-window
    attention) a row at absolute position r attends slots in
    (r - window, r] instead of [0, r]."""
    pos = cache["pos"]
    ops.dyn_update_seq(cache["k"], k, pos)
    ops.dyn_update_seq(cache["v"], v, pos)
    K, V = cache["k"], cache["v"]
    L = K.shape[1]
    cols = torch.arange(L, device=K.device)
    ar = torch.arange(s, device=K.device)
    if pos.dim() == 0:
        rows = (pos.long() + ar)[:, None]                      # [s, 1]
        mask = cols[None, :] <= rows
        if window:
            mask = mask & (cols[None, :] > rows - window)
        mask = mask.reshape(1, 1, s, L)
    else:
        rows = (pos.long()[:, None] + ar[None, :])[:, :, None]  # [b, s, 1]
        mask = rows >= cols
        if window:
            mask = mask & (rows - window < cols)
        mask = mask[:, None]                                   # [b, 1, s, L]
    return K, V, mask


def _update_paged_cache(cache, k, v):
    """Serving path: write k/v [b, s, Hkv, D] into the block-paged pool at
    each row's context offset, IN PLACE, and return (k_pool, v_pool) for
    the paged attention op.  The cache dict is the pool view the engine
    assembled for this step: {"k"/"v": [N, bs, Hkv, D] pool tensors,
    "table": [b, M] int32 block ids, "pos": [b] context offsets, and
    optionally "limit": [b] write ceilings (positions at or past it are
    dropped)}.  Write THEN attend: the chunk's own keys are visible to
    its queries, as in the JAX package."""
    limit = cache.get("limit")
    paged_write(cache["k"], k, cache["table"], cache["pos"], limit)
    paged_write(cache["v"], v, cache["table"], cache["pos"], limit)
    return cache["k"], cache["v"]


def _truncate_at_eos(out, prompt_len, eos_token_id):
    """Match the eager loop's early-exit shape: truncate after the LAST
    row finishes (positions past a row's eos are eos-padded).  Reads the
    first eos position of each row back to the host."""
    gen = out[:, prompt_len:]
    hit = gen == eos_token_id
    first = torch.where(hit.any(1), hit.int().argmax(1),
                        torch.full_like(hit[:, 0], gen.shape[1] - 1,
                                        dtype=torch.long))
    return out[:, :prompt_len + int(first.max()) + 1]


@contextlib.contextmanager
def _eval_mode(*models):
    """Temporarily switch models to eval; restore train flags on exit."""
    states = [m.training for m in models]
    for m in models:
        m.eval()
    try:
        yield
    finally:
        for m, was in zip(models, states):
            if was:
                m.train()


def _param(model):
    return next(iter(model.parameters()))


def _prealloc(model, batch, max_length, pos):
    """The model's preallocated caches, every layer sharing the one `pos`
    tensor."""
    caches = model.new_caches(batch, dtype=_param(model).dtype,
                              max_length=max_length)
    for c in caches:
        c["pos"] = pos
    return caches


class _StaticDecode:
    """One `jit_generate` program: the preallocated caches, the static
    buffers of the decode step and, when `capture`, that step captured as
    a CUDA graph at its first call (the first call runs it eagerly on a
    side stream, which loads every kernel and library handle, then
    captures it).  `counts` holds the kernel launches one replay makes;
    each replay adds them to the launch counters."""

    def __init__(self, model, batch, prompt_len, total, pick, eos,
                 generator, capture):
        dev = _param(model).device
        self.model = model
        self.prompt_len, self.total = prompt_len, total
        self.pick, self.eos = pick, eos
        self.generator, self.capture = generator, capture
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.caches = _prealloc(model, batch, total, self.pos)
        self.tok = torch.zeros(batch, 1, dtype=torch.long, device=dev)
        self.buf = torch.zeros(batch, total, dtype=torch.long, device=dev)
        self.fin = torch.zeros(batch, dtype=torch.bool, device=dev)
        self.graph = None
        self.counts = None
        self.fingerprint = _fingerprint(model, generator, capture)

    def prefill(self, ids):
        """The eager prefill at pos 0: the caches hold the prompt, `buf`
        the prompt and its first new token (the rest eos or 0), `pos` the
        prompt length."""
        P = self.prompt_len
        self.pos.zero_()
        logits = self.model(ids, caches=self.caches)
        nxt = self.pick(logits[:, -1, :].float())
        self.buf.fill_(self.eos if self.eos is not None else 0)
        self.buf[:, :P] = ids
        self.buf[:, P] = nxt
        if self.eos is not None:
            torch.eq(nxt, self.eos, out=self.fin)
        self.tok.copy_(nxt[:, None])
        self.pos.fill_(P)

    def _step(self):
        """One token: forward `tok` at `pos`, pick, eos-fill finished
        rows, write the token at column pos + 1, advance `pos`.  Reads
        nothing back to the host."""
        logits = self.model(self.tok, caches=self.caches)
        nxt = self.pick(logits[:, -1, :].float())
        if self.eos is not None:
            nxt = torch.where(self.fin, self.eos, nxt)
            self.fin |= nxt == self.eos
        self.buf.index_copy_(1, (self.pos.long() + 1).reshape(1),
                             nxt[:, None])
        self.tok.copy_(nxt[:, None])
        self.pos += 1

    def step(self):
        if not self.capture:
            self._step()
        elif self.graph is None:
            self._capture()
        else:
            self.graph.replay()
            ops.add_launch_counts(self.counts)

    def _capture(self):
        dev = self.buf.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step()            # this token, eagerly: the warm-up
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = ops.launch_counts()
        with torch.cuda.graph(graph):
            self._step()
        after = ops.launch_counts()
        self.counts = {n: after[n] - before[n] for n in after}
        ops.add_launch_counts(self.counts, times=-1)   # capture launches
        self.graph = graph                              # nothing

    def run(self, ids):
        """Prefill, then one step per remaining token until the buffer is
        full or (with an eos) every row has finished.  Returns a copy of
        the [b, total] ids."""
        self.prefill(ids)
        for _ in range(self.total - self.prompt_len - 1):
            if self.eos is not None and bool(self.fin.all()):
                break
            self.step()
        return self.buf.clone()


def _fingerprint(model, generator, capture):
    """What a built program is tied to besides its key: the storage of
    the parameters and buffers (a captured graph reads them by address;
    a weight-only layer's codes are a buffer), the `merged` flag of every
    layer that has one (a LoRA layer's captured step replays its adapter
    product unless it was merged at capture, and merge() changes the
    weights in place, not their address), the generator its graph
    registered, and whether it captures."""
    return (tuple(p.data_ptr() for p in model.parameters()),
            tuple(b.data_ptr() for b in model.buffers()),
            tuple(m.merged for m in model.modules() if hasattr(m, "merged")),
            id(generator), bool(capture))


def jit_generate(model, input_ids, max_new_tokens=20, do_sample=False,
                 temperature=1.0, top_k=None, top_p=None, eos_token_id=None,
                 generator=None, *, _capture=None):
    """Greedy or sampled decoding over preallocated caches, the decode
    step captured as a CUDA graph on the card (see the module note).
    Returns [b, prompt + max_new_tokens] long ids on the model's device;
    positions after a row's eos hold eos, and with `eos_token_id` the
    output is cut after the last row's eos, as the eager loop stops.
    `_capture=False` runs the static step uncaptured on the card too
    (card tests and A/B timing only); capture needs a CUDA device."""
    b, prompt_len = input_ids.shape
    total = prompt_len + max_new_tokens
    dev = _param(model).device
    capture = dev.type == "cuda" if _capture is None else bool(_capture)
    with _eval_mode(model), torch.no_grad():
        cache_key = (prompt_len, max_new_tokens, bool(do_sample),
                     float(temperature), top_k, top_p, eos_token_id, b)
        store = model.__dict__.setdefault("_jit_decode_cache", {})
        old = store.get(cache_key)
        if old is not None and \
                old.fingerprint != _fingerprint(model, generator, capture):
            del store[cache_key]

        def pick(logits):
            return _sample_next(logits, temperature, top_k, top_p,
                                greedy=not do_sample, generator=generator)

        def build():
            return _StaticDecode(model, b, prompt_len, total, pick,
                                 eos_token_id, generator, capture)

        prog = _lru_compiled(store, cache_key, build)
        out = prog.run(input_ids.to(dev).long())
        if eos_token_id is not None:
            out = _truncate_at_eos(out, prompt_len, eos_token_id)
        return out


def _reorder_caches(caches, gather):
    """Gather every cache's rows by `gather` [rows], in place."""
    for c in caches:
        c["k"].copy_(c["k"].index_select(0, gather))
        c["v"].copy_(c["v"].index_select(0, gather))


def _beam_top(beam_scores, logp, b, beam):
    """The beam step's top-k over [b, beam * V] candidate scores ->
    (new scores [b * beam], tokens [b * beam], source rows [b * beam])."""
    V = logp.shape[-1]
    scores = (beam_scores[:, None] + logp).reshape(b, beam * V)
    best, top = torch.topk(scores, beam, dim=-1)
    src = top // V
    tok = (top % V).reshape(-1)
    rows = (torch.arange(b, device=logp.device)[:, None] * beam
            + src).reshape(-1)
    return best.reshape(-1), tok, rows


def jit_beam_search(model, input_ids, beam_size=4, max_new_tokens=20,
                    length_penalty=1.0, eos_token_id=None):
    """Beam search over preallocated caches, token-compatible with the
    eager `generation.beam_search`: beams ride the batch axis ([b *
    beam]), every step is one batched forward, and each beam reorder
    gathers the cache rows in place.  The steps run eagerly here (the
    JAX package compiles the loop into one program); they are not
    captured.

    Returns [b, prompt + max_new_tokens]; with `eos_token_id` the
    positions after a winning beam finishes hold eos (the frozen-beam
    continuation), where the eager loop would have stopped early."""
    beam = int(beam_size)
    b, prompt_len = input_ids.shape
    bb = b * beam
    total = prompt_len + max_new_tokens
    dev = _param(model).device
    with _eval_mode(model), torch.no_grad():
        pos = torch.zeros((), dtype=torch.int32, device=dev)
        caches = _prealloc(model, bb, total, pos)
        ids = input_ids.to(dev).long().repeat_interleave(beam, dim=0)
        logits = model(ids, caches=caches)
        logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
        # step 0: all beams identical — only beam 0 competes
        init = torch.tensor([0.0] + [-1e9] * (beam - 1),
                            device=dev).repeat(b)
        beam_scores, tok, g = _beam_top(init, logp, b, beam)
        buf = torch.full((bb, total),
                         eos_token_id if eos_token_id is not None else 0,
                         dtype=torch.long, device=dev)
        buf[:, :prompt_len] = ids
        buf = buf[g]
        buf[:, prompt_len] = tok
        _reorder_caches(caches, g)
        finished = torch.zeros(bb, dtype=torch.bool, device=dev)
        if eos_token_id is not None:
            finished = buf[:, prompt_len] == eos_token_id
            # finished beams only extend with eos, score kept
            frozen = torch.full((logp.shape[-1],), float("-inf"),
                                device=dev)
            frozen[eos_token_id] = 0.0
        gen_lens = torch.ones(bb, device=dev)
        for i in range(prompt_len + 1, total):
            if eos_token_id is not None and bool(finished.all()):
                break
            pos.fill_(i - 1)
            logits = model(buf[:, i - 1:i], caches=caches)
            logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
            if eos_token_id is not None:
                logp = torch.where(finished[:, None], frozen[None, :], logp)
            beam_scores, tok, g = _beam_top(beam_scores, logp, b, beam)
            buf = buf[g]
            buf[:, i] = tok
            _reorder_caches(caches, g)
            gen_lens = gen_lens[g] + (~finished[g]).float()
            finished = finished[g]
            if eos_token_id is not None:
                finished = finished | (tok == eos_token_id)
        final = beam_scores / ((5.0 + gen_lens) / 6.0) ** length_penalty
        best = torch.argmax(final.reshape(b, beam), dim=1)
        return buf[torch.arange(b, device=dev) * beam + best]


def speculative_generate(model, draft_model, input_ids, max_new_tokens=20,
                         num_speculative_tokens=4, do_sample=False,
                         temperature=1.0, top_k=None, top_p=None,
                         eos_token_id=None, generator=None):
    """Speculative decoding, batched (Leviathan et al. 2023), as the JAX
    package's.  Each round the draft runs k + 1 steps (the last one's
    proposal is unused, but its cache write stores d_k's k/v), then ONE
    (k + 1)-token target forward verifies [cur, d1..dk] under the
    per-row [b, 1, k + 1, L] mask, and each row commits its accepted
    prefix plus one correction or bonus token:

    * greedy: exact-match acceptance against the target's argmax — the
      output equals `jit_generate(model, ..., do_sample=False)` in exact
      arithmetic;
    * sampling: draft token x is accepted with probability
      min(1, p(x) / q(x)) (p, q the filtered target and draft
      distributions); on rejection the replacement is drawn from
      norm(max(p - q, 0)), on full acceptance the bonus from p.

    Every row keeps its own `pos`, acceptance length and finished flag;
    stale cache entries past a row's `pos` are masked and later
    overwritten.  The loop and the draft steps run eagerly; the host
    reads the finished flags once a round."""
    k = int(num_speculative_tokens)
    if k < 1:
        raise ValueError("num_speculative_tokens must be >= 1")
    b, prompt_len = input_ids.shape
    total = prompt_len + max_new_tokens
    width = total + k + 1
    dev = _param(model).device

    def probs(logits):
        """The filtered distribution the direct sampler draws from."""
        return torch.softmax(filter_logits(logits.float(), temperature,
                                           top_k, top_p), dim=-1)

    def pick(logits):
        return _sample_next(logits.float(), temperature, top_k, top_p,
                            greedy=not do_sample, generator=generator)

    def at(caches, pos):
        for c in caches:
            c["pos"] = pos
        return caches

    with _eval_mode(model, draft_model), torch.no_grad():
        zeros_b = torch.zeros(b, dtype=torch.long, device=dev)
        cache_t = _prealloc(model, b, width, zeros_b)
        cache_d = _prealloc(draft_model, b, width, zeros_b)
        ids = input_ids.to(dev).long()
        t_lg = model(ids, caches=cache_t)
        draft_model(ids, caches=cache_d)
        cur = pick(t_lg[:, -1, :])                               # [b]
        buf = torch.full((b, width),
                         eos_token_id if eos_token_id is not None else 0,
                         dtype=torch.long, device=dev)
        buf[:, :prompt_len] = ids
        buf[:, prompt_len] = cur
        n = torch.ones(b, dtype=torch.long, device=dev)
        pos = torch.full((b,), prompt_len, dtype=torch.long, device=dev)
        fin = torch.zeros(b, dtype=torch.bool, device=dev)
        if eos_token_id is not None:
            fin = cur == eos_token_id
        fin = fin | (n >= max_new_tokens)
        idx = torch.arange(k + 1, device=dev)[None, :]           # [1, k+1]
        while not bool(fin.all()):
            tok, props, qs = cur, [], []
            for j in range(k + 1):
                lg = draft_model(tok[:, None],
                                 caches=at(cache_d, pos + j))[:, -1, :]
                tok = pick(lg)
                props.append(tok)
                if do_sample:
                    qs.append(probs(lg))
            props = torch.stack(props[:k], dim=1)                # [b, k]
            # logits[:, j] choose the token at each row's pos + j + 1
            verify = torch.cat([cur[:, None], props], dim=1)
            t_lg = model(verify, caches=at(cache_t, pos))
            if do_sample:
                ps = probs(t_lg)                                 # [b, k+1, V]
                qs = torch.stack(qs[:k], dim=1)                  # [b, k, V]
                p_tok = ps[:, :k].gather(-1, props[..., None])[..., 0]
                q_tok = qs.gather(-1, props[..., None])[..., 0]
                u = torch.rand((b, k), generator=generator, device=dev)
                acc = (u * q_tok < p_tok).long()
                m = acc.cumprod(dim=1).sum(dim=1)
                # a replacement draw at every position: the residual
                # norm(max(p - q, 0)) for 0..k-1, the bonus p at k; only
                # the draw at index m is committed
                res = (ps[:, :k] - qs).clamp(min=0.0)
                rs = res.sum(dim=-1, keepdim=True)
                # p == q leaves the residual empty; rejection there has
                # probability 0, so guard the 0/0 with p itself
                res = torch.where(rs > 0, res / rs, ps[:, :k])
                cand = torch.cat([res, ps[:, k:]], dim=1)
                repl = _gumbel_argmax(torch.log(cand + 1e-30), generator)
                props_pad = torch.cat([props, repl[:, -1:]], dim=1)
                tok_out = torch.where(idx < m[:, None], props_pad, repl)
            else:
                greedy = torch.argmax(t_lg.float(), dim=-1)      # [b, k+1]
                acc = (props == greedy[:, :k]).long()
                m = acc.cumprod(dim=1).sum(dim=1)
                tok_out = greedy                # valid through index m
            cur_next = tok_out.gather(1, m[:, None])[:, 0]
            emit = m + 1                                         # 1..k+1
            new_fin = fin
            if eos_token_id is not None:
                hit = (tok_out == eos_token_id) & (idx <= m[:, None])
                any_hit = hit.any(dim=1)
                e = hit.long().argmax(dim=1)
                emit = torch.where(any_hit, torch.minimum(emit, e + 1), emit)
                # eos-pad the committed window past the first eos
                tok_out = torch.where(any_hit[:, None] & (idx > e[:, None]),
                                      eos_token_id, tok_out)
                new_fin = fin | any_hit
            emit = torch.where(fin, 0, emit)
            start = (prompt_len + n).clamp(0, width - (k + 1))
            upd = buf.scatter(1, start[:, None] + idx, tok_out)
            buf = torch.where(fin[:, None], buf, upd)
            cur = torch.where(fin, cur, cur_next)
            n = n + emit
            pos = pos + emit
            fin = new_fin | (n >= max_new_tokens)
        out = buf[:, :total]
        if eos_token_id is not None:
            out = _truncate_at_eos(out, prompt_len, eos_token_id)
        return out
