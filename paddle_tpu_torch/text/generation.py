"""Decoding helpers shared with the serving engine.

Counterpart: `paddle_tpu/text/generation.py` (`BucketPolicy`,
`filter_logits`).  Eager `generate` waits for the flash-attention slice
of the port: its dense forward runs `sdpa`, which has no CUDA kernel yet.
"""
from __future__ import annotations

import torch


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
