"""Autoregressive decoding with a KV cache, and the helpers the serving
engine shares.

Counterpart: `paddle_tpu/text/generation.py`.  `generate` is the eager
loop over concat-style caches (each step's cache one token longer),
routing to beam search (`num_beams > 1`, through
`decode.jit_beam_search`) and to speculative decoding (`draft_model`),
with per-row eos padding.  `shape_buckets` (or
``PADDLE_TPU_SHAPE_BUCKETS``) pads the prompt to a bucket and decodes
over the preallocated caches instead, with identical tokens: the length
mask `cols <= pos + row` hides the padded slots, and each decode write
lands on the next slot before the mask first admits it.  "auto" arms
bucketing once the compile tracker has recorded shape-change recompiles
of the model (its `jit.to_static` compiles), as in the JAX package.

Sampling draws from an explicit `torch.Generator` (None: the device's
default generator) by the Gumbel-max rule, as `jax.random.categorical`
draws; the two packages' random streams differ.
"""
from __future__ import annotations

import os
import warnings

import torch

from ..observability import metrics as _metrics


class BucketPolicy:
    """Pad-to-bucket policy for decode shapes.

    `buckets` is an explicit ascending list of lengths; lengths beyond
    the last bucket keep doubling from it.  The default geometric ladder
    (32, 64, 128, ...) bounds the number of distinct shapes to
    log2(max length) while wasting at most 2x on padding."""

    def __init__(self, buckets=None, min_bucket=32):
        self.buckets = sorted(int(b) for b in buckets) if buckets else []
        self.min_bucket = int(min_bucket)

    def bucket(self, n):
        """Smallest bucket >= n."""
        n = int(n)
        for b in self.buckets:
            if n <= b:
                return b
        b = self.buckets[-1] if self.buckets else self.min_bucket
        while b < n:
            b *= 2
        return b

    @classmethod
    def from_spec(cls, spec):
        """None/"0"/"off" -> None; "1"/"on"/"auto" -> default ladder;
        "64,128,512" -> explicit buckets."""
        if spec is None:
            return None
        s = str(spec).strip().lower()
        if s in ("", "0", "off", "false", "none"):
            return None
        if s in ("1", "on", "true", "auto"):
            return cls()
        return cls(buckets=[int(p) for p in s.split(",") if p.strip()])


def _tracker_wants_buckets(model):
    """The "auto" signal: has the compile tracker recorded at least two
    shape-change recompiles of this model, or of a `to_static` wrapping
    it (the event's owner, or the Layer its owner wraps)?"""
    from ..observability import compile_tracker as _ct

    def ours(owner):
        return owner is model or getattr(owner, "layer", None) is model
    return sum(1 for e in _ct.events()
               if "shape" in e.cause and ours(e.owner)) >= 2


def _resolve_bucket_policy(shape_buckets, model):
    """The active BucketPolicy for this generate() call, or None.

    An explicit argument wins; unset falls back to
    PADDLE_TPU_SHAPE_BUCKETS.  "auto" (argument or environment) arms
    bucketing once the compile tracker has recorded shape-change
    recompiles for the model (`_tracker_wants_buckets`), before that it
    gives None."""
    spec = shape_buckets
    if spec is None:
        spec = os.environ.get("PADDLE_TPU_SHAPE_BUCKETS") or None
    if isinstance(spec, BucketPolicy):
        return spec
    if isinstance(spec, (list, tuple)):
        return BucketPolicy(buckets=spec)
    if isinstance(spec, str) and spec.strip().lower() == "auto":
        return BucketPolicy() if _tracker_wants_buckets(model) else None
    return BucketPolicy.from_spec(spec)


def filter_logits(logits, temperature, top_k, top_p):
    """Temperature / top-k / nucleus filtering of float logits [..., V],
    with the JAX package's ties and cutoffs: top-k keeps every logit >=
    the k-th largest; top-p keeps every logit >= the sorted logit at
    index sum(cumsum(softmax(sorted)) < top_p).  When rounding leaves
    the whole cumsum below top_p that index is past the end: JAX's
    gather then yields NaN and masks nothing, and so does the clamp to
    the smallest logit here."""
    logits = logits / max(float(temperature), 1e-6)
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, int(top_k), dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(
            max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _gumbel_argmax(logits, generator=None):
    """A categorical draw per row of `logits` [..., V] by the Gumbel-max
    rule, from `generator` on the logits' device.  Device ops only, so a
    captured step can draw."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _sample_next(logits, temperature, top_k, top_p, greedy, generator=None):
    """The next token of each row of float logits [..., V]: argmax, or a
    draw from the filtered distribution."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    return _gumbel_argmax(filter_logits(logits, temperature, top_k, top_p),
                          generator)


def generate(model, input_ids, max_new_tokens=20, do_sample=False,
             temperature=1.0, top_k=None, top_p=None, eos_token_id=None,
             draft_model=None, num_speculative_tokens=4, num_beams=1,
             length_penalty=1.0, shape_buckets=None, generator=None):
    """Returns [b, prompt + new] long token ids on the model's device.

    ``draft_model`` routes through speculative decoding
    (`decode.speculative_generate`): greedy output equals the plain
    path's; sampled output follows the same law from another stream.
    ``num_beams > 1`` routes through `decode.jit_beam_search`.
    ``shape_buckets`` (or ``PADDLE_TPU_SHAPE_BUCKETS``) decodes over
    preallocated caches with the prompt padded to a bucket, with
    identical tokens.  With `eos_token_id` a finished row emits eos and
    the loop stops once every row has finished.  `generator` is the
    `torch.Generator` sampling draws from."""
    if num_beams > 1:
        if do_sample or draft_model is not None:
            raise NotImplementedError(
                "beam search does not compose with do_sample or "
                "draft_model")
        from .decode import jit_beam_search
        return jit_beam_search(model, input_ids, beam_size=num_beams,
                               max_new_tokens=max_new_tokens,
                               length_penalty=length_penalty,
                               eos_token_id=eos_token_id)
    if draft_model is not None:
        from .decode import speculative_generate
        return speculative_generate(
            model, draft_model, input_ids, max_new_tokens=max_new_tokens,
            num_speculative_tokens=num_speculative_tokens,
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            top_p=top_p, eos_token_id=eos_token_id, generator=generator)
    policy = _resolve_bucket_policy(shape_buckets, model)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            if policy is not None:
                return _bucketed_generate(
                    model, input_ids, max_new_tokens, do_sample,
                    temperature, top_k, top_p, eos_token_id, policy,
                    generator)
            param = next(iter(model.parameters()))
            tokens = input_ids.to(param.device).long()
            caches = model.new_caches(tokens.shape[0], dtype=param.dtype)
            return _decode_loop(model, tokens, caches, tokens.shape[1] - 1,
                                max_new_tokens, do_sample, temperature,
                                top_k, top_p, eos_token_id, generator)
    finally:
        if was_training:
            model.train()


def _decode_loop(model, ids, caches, last, max_new_tokens, do_sample,
                 temperature, top_k, top_p, eos_token_id, generator,
                 set_pos=None):
    """The eager loop shared by the plain and the bucketed paths: prefill
    `ids` and pick from the logits at column `last`, then one step per
    token; `set_pos(t)` (bucketed) points the preallocated caches at step
    t's slot.  With an eos, finished rows emit eos and the loop stops
    when every row has (one host read a step)."""
    def pick(logits):
        return _sample_next(logits.float(), temperature, top_k, top_p,
                            greedy=not do_sample, generator=generator)

    prompt = ids[:, :last + 1]
    nxt = pick(model(ids, caches=caches)[:, last, :])[:, None]
    out = [prompt, nxt]
    finished = torch.zeros(ids.shape[0], dtype=torch.bool, device=ids.device)
    for t in range(max_new_tokens - 1):
        if eos_token_id is not None:
            finished |= out[-1][:, 0] == eos_token_id
            if bool(finished.all()):
                break
        if set_pos is not None:
            set_pos(t)
        nxt = pick(model(out[-1], caches=caches)[:, -1, :])[:, None]
        if eos_token_id is not None:
            # per-sequence stop: a finished row emits eos padding
            nxt = torch.where(finished[:, None], eos_token_id, nxt)
        out.append(nxt)
    return torch.cat(out, dim=1)


def _bucketed_generate(model, input_ids, max_new_tokens, do_sample,
                       temperature, top_k, top_p, eos_token_id, policy,
                       generator=None):
    """The decode loop over preallocated caches with the prompt padded
    to a bucket: one prefill shape per (batch, prompt bucket), one decode
    shape per batch.  The prefill writes junk k/v into slots [prompt,
    prompt bucket), but the length mask only exposes `cols <= pos + row`
    and decode step t writes slot prompt + t before the mask first
    admits it, so every attended key is real and the tokens match the
    unbucketed loop."""
    b, prompt = input_ids.shape
    param = next(iter(model.parameters()))
    max_pos = getattr(getattr(model, "cfg", None),
                      "max_position_embeddings", None)
    if max_pos is not None and prompt + max_new_tokens > int(max_pos):
        # preallocated caches cannot exceed the position table; a request
        # already past it keeps the unbucketed loop's semantics
        warnings.warn(
            f"generation request ({prompt} prompt + {max_new_tokens} "
            f"new) exceeds max_position_embeddings={max_pos}; shape "
            f"bucketing disabled for this call", UserWarning, stacklevel=3)
        return generate(model, input_ids, max_new_tokens=max_new_tokens,
                        do_sample=do_sample, temperature=temperature,
                        top_k=top_k, top_p=top_p, eos_token_id=eos_token_id,
                        shape_buckets="off", generator=generator)
    cap = policy.bucket(prompt + max_new_tokens)
    pb = max(policy.bucket(prompt), prompt)
    if max_pos is not None:
        cap = min(cap, int(max_pos))
        pb = min(pb, int(max_pos))
    cap = max(cap, prompt + max_new_tokens)
    pb = min(max(pb, prompt), cap)
    try:
        caches = model.new_caches(b, dtype=param.dtype, max_length=cap)
    except TypeError:
        warnings.warn(
            f"{type(model).__name__} does not support preallocated caches "
            f"(new_caches(max_length=)); shape bucketing disabled for this "
            f"call", UserWarning, stacklevel=3)
        return generate(model, input_ids, max_new_tokens=max_new_tokens,
                        do_sample=do_sample, temperature=temperature,
                        top_k=top_k, top_p=top_p, eos_token_id=eos_token_id,
                        shape_buckets="off", generator=generator)
    reg = _metrics.registry()
    reg.counter("generation_bucketed_calls_total").inc()
    reg.counter("generation_bucket_pad_tokens_total").inc((pb - prompt) * b)
    ids = input_ids.to(param.device).long()
    if pb > prompt:
        pad = eos_token_id if eos_token_id is not None else 0
        ids = torch.nn.functional.pad(ids, (0, pb - prompt), value=pad)

    def set_pos(t):
        for c in caches:
            c["pos"].fill_(prompt + t)

    return _decode_loop(model, ids, caches, prompt - 1, max_new_tokens,
                        do_sample, temperature, top_k, top_p, eos_token_id,
                        generator, set_pos)


def beam_search(model, input_ids, beam_size=4, max_new_tokens=20,
                length_penalty=1.0, eos_token_id=None):
    """Beam-search decode over concat caches.  Beams ride the batch axis
    ([b * beam]), so every model step is one batched call; the caches
    are gathered along the batch axis on each beam reorder.

    Returns [b, prompt + new]: the highest-scoring beam per batch row
    under the GNMT length penalty ((5 + len) / 6) ** alpha."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return _beam_search_impl(model, input_ids, beam_size,
                                     max_new_tokens, length_penalty,
                                     eos_token_id)
    finally:
        if was_training:
            model.train()


def _beam_penalty(length, alpha):
    return ((5.0 + length) / 6.0) ** alpha


def _beam_search_impl(model, input_ids, beam, max_new, alpha, eos_id):
    from .decode import _beam_top, _reorder_caches
    b = input_ids.shape[0]
    param = next(iter(model.parameters()))
    dev = param.device
    ids = input_ids.to(dev).long().repeat_interleave(beam, dim=0)
    caches = model.new_caches(b * beam, dtype=param.dtype)
    logits = model(ids, caches=caches)
    logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
    # step 0: all beams identical — keep only beam 0 alive to avoid dupes
    init = torch.tensor([0.0] + [-1e9] * (beam - 1), device=dev).repeat(b)
    beam_scores, tok, gather = _beam_top(init, logp, b, beam)
    seqs = torch.cat([ids[gather], tok[:, None]], dim=1)
    _reorder_caches(caches, gather)
    finished = torch.zeros(b * beam, dtype=torch.bool, device=dev)
    if eos_id is not None:
        finished = seqs[:, -1] == eos_id
        frozen = torch.full((logp.shape[-1],), float("-inf"), device=dev)
        frozen[eos_id] = 0.0
    gen_lens = torch.ones(b * beam, device=dev)   # per-beam finished length
    for _ in range(max_new - 1):
        if eos_id is not None and bool(finished.all()):
            break
        logits = model(seqs[:, -1:], caches=caches)
        logp = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
        if eos_id is not None:
            # finished beams may only extend with eos at unchanged score
            logp = torch.where(finished[:, None], frozen[None, :], logp)
        beam_scores, tok, gather = _beam_top(beam_scores, logp, b, beam)
        seqs = torch.cat([seqs[gather], tok[:, None]], dim=1)
        _reorder_caches(caches, gather)
        # a beam's length only grows while it was still alive
        gen_lens = gen_lens[gather] + (~finished[gather]).float()
        finished = finished[gather]
        if eos_id is not None:
            finished = finished | (seqs[:, -1] == eos_id)
    final = beam_scores / _beam_penalty(gen_lens, alpha)
    best = torch.argmax(final.reshape(b, beam), dim=1)
    return seqs[torch.arange(b, device=dev) * beam + best]
