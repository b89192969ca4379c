"""Op routing between the hand-written kernels and the plain versions.

Counterpart: `paddle_tpu/ops/pallas/__init__.py`, which overrides the
`sdpa` and `paged_attention` registry entries with Pallas kernels.

* `paged_attention` — a decode step (s == 1) on CUDA runs the CUDA paged
  kernel, which raises on a shape it does not take.  Prefill chunks
  (s > 1) run the plain gather path, as the JAX package sends them to its
  XLA gather path: that split by s is the reference's own design.  CPU
  tensors run the plain version.
* `sdpa` — plain on the CPU.  Its kernel is the flash-attention slice of
  the port (ROADMAP.md, queue B, B1-B3), not yet written, so on CUDA it
  raises rather than put the plain version on a main path.
* `paged_write` — plain on every device, as in the JAX package (no
  Pallas kernel there either).
"""
from __future__ import annotations

import torch

from . import nn_kernels
from .nn_kernels import paged_write
from .paged_decode import paged_decode_attention

__all__ = ["paged_attention", "paged_decode_attention", "paged_write",
           "sdpa"]


def paged_attention(q, k_pool, v_pool, tables, pos, scale=None):
    """q [b, s, H, D] attends the paged pool through `tables` [b, M] at
    row offsets `pos` [b] (the position of q's first token)."""
    if q.device.type == "cuda" and q.shape[1] == 1:
        lens = (pos + 1).to(torch.int32)
        return paged_decode_attention(q.contiguous(), k_pool, v_pool,
                                      tables, lens.contiguous(), scale=scale)
    return nn_kernels.paged_attention(q, k_pool, v_pool, tables, pos,
                                      scale=scale)


def sdpa(q, k, v, mask=None, is_causal=False, scale=None):
    if q.device.type == "cuda":
        raise NotImplementedError(
            "sdpa on CUDA needs the flash-attention kernel, which the port "
            "has not written yet (ROADMAP.md, queue B: B1-B3, the training "
            "slice); the plain version does not stand in for it on the card")
    return nn_kernels.sdpa(q, k, v, mask=mask, is_causal=is_causal,
                           scale=scale)
