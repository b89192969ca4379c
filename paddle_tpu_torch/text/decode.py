"""KV-cache updates for decoding.

Counterpart: `paddle_tpu/text/decode.py`.  This slice ports the serving
path's `_update_paged_cache`; the preallocated cache and the jitted
decode loops (`jit_generate`, beam search, speculative decoding) are a
later slice (ROADMAP.md).
"""
from __future__ import annotations

from ..ops import paged_write


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
