"""Op routing between the hand-written kernels and the plain versions.

Counterpart: `paddle_tpu/ops/pallas/__init__.py`, which overrides the
`sdpa` and `paged_attention` registry entries with Pallas kernels.

* `paged_attention` — a decode step (s == 1) on CUDA runs the CUDA paged
  kernel, which raises on a shape it does not take.  Prefill chunks
  (s > 1) run the plain gather path, as the JAX package sends them to its
  XLA gather path: that split by s is the reference's own design.  CPU
  tensors run the plain version.
* `sdpa` — on CUDA, a call inside the flash gate (`flash_attention.
  supports`, and no mask that needs a gradient, and no window without
  causal) runs the flash-attention kernels, which launch or raise, as
  `sdpa_with_flash` (`:44-55`) sends such calls to Pallas.  A CUDA call
  outside the gate runs the plain version, as the JAX package sends it to
  XLA, and adds 1 to `sdpa.plain_calls`.  CPU tensors run the plain
  version.
* `paged_write`, `dyn_update_seq`, `rms_norm` and the ResNet stem
  (`s2d_stem_conv`, `s2d_stem_conv_nhwc`) — plain on every device, as in
  the JAX package (no Pallas kernel there either).

`launch_counts()` reads every kernel launch counter and
`sdpa.plain_calls` at once; `add_launch_counts` adds a captured CUDA
graph's launches to them each time the graph replays (the wrappers run
once, at capture, where they launch nothing).

The kernel module of `sdpa` is `ops/flash_attention.py` (the module, not
re-exported here under that name, so that the attribute stays the
module).
"""
from __future__ import annotations

import torch

from .. import amp as _amp
from . import flash_attention as _flash
from . import nn_kernels
from .nn_kernels import (dyn_update_seq, paged_write, s2d_stem_conv,
                         s2d_stem_conv_nhwc)
from .paged_decode import paged_decode_attention

__all__ = ["add_launch_counts", "dyn_update_seq", "launch_counts",
           "paged_attention", "paged_decode_attention", "paged_write",
           "rms_norm", "s2d_stem_conv", "s2d_stem_conv_nhwc", "sdpa"]


def paged_attention(q, k_pool, v_pool, tables, pos, scale=None):
    """q [b, s, H, D] attends the paged pool through `tables` [b, M] at
    row offsets `pos` [b] (the position of q's first token).  Under
    `amp.auto_cast` an allow op ("paged_attention")."""
    q, k_pool, v_pool = _amp.cast_inputs("paged_attention", "allow", q,
                                         k_pool, v_pool)
    with _amp.no_cast():
        return _paged_attention(q, k_pool, v_pool, tables, pos, scale)


def _paged_attention(q, k_pool, v_pool, tables, pos, scale):
    if q.device.type == "cuda" and q.shape[1] == 1:
        lens = (pos + 1).to(torch.int32)
        return paged_decode_attention(q.contiguous(), k_pool, v_pool,
                                      tables, lens.contiguous(), scale=scale)
    return nn_kernels.paged_attention(q, k_pool, v_pool, tables, pos,
                                      scale=scale)


def rms_norm(x, weight=None, eps=1e-6):
    """`nn_kernels.rms_norm`; under `amp.auto_cast` with a weight a deny
    op ("rms_norm": x and the weight in float32), without one its dtypes
    stay, as in the JAX package."""
    if weight is not None:
        x, weight = _amp.cast_inputs("rms_norm", "deny", x, weight)
    with _amp.no_cast():
        return nn_kernels.rms_norm(x, weight, eps)


def sdpa(q, k, v, mask=None, is_causal=False, scale=None,
         sliding_window=None, _mask_needs_grad=False):
    """Scaled dot-product attention on (B, L, H, D); see the module note
    for the route.  `_mask_needs_grad` (a trained additive mask) forces
    the plain version, which differentiates through `scores + mask`.
    Under `amp.auto_cast` a masked call is an allow op ("sdpa"): q, k, v
    and a floating mask cast to the AMP dtype; an unmasked call keeps its
    dtypes, as the JAX package runs it outside its dispatch."""
    if mask is not None:
        q, k, v, mask = _amp.cast_inputs("sdpa", "allow", q, k, v, mask)
    with _amp.no_cast():
        return _sdpa(q, k, v, mask, is_causal, scale, sliding_window,
                     _mask_needs_grad)


def _sdpa(q, k, v, mask, is_causal, scale, sliding_window, _mask_needs_grad):
    if q.device.type == "cuda":
        if not _mask_needs_grad and (not sliding_window or is_causal) and \
                _flash.supports(q.shape, k.shape, mask, q.dtype,
                                v_shape=v.shape, is_causal=is_causal):
            return _flash.flash_attention(q, k, v, mask=mask,
                                          is_causal=is_causal, scale=scale,
                                          window=sliding_window)
        sdpa.plain_calls += 1
    return nn_kernels.sdpa(q, k, v, mask=mask, is_causal=is_causal,
                           scale=scale, sliding_window=sliding_window)


sdpa.plain_calls = 0


def _counters():
    """name -> (object, attribute) of each launch counter."""
    f = _flash.flash_attention
    out = {f"flash_{k}": (f, f"launches_{k}") for k in (
        "fwd", "dkv", "dq", "fwd_sm90", "dkv_sm90", "dq_sm90",
        "fwd_decode", "fwd_fp32", "dkv_fp32", "dq_fp32")}
    out["paged_decode"] = (paged_decode_attention, "launches")
    out["sdpa_plain"] = (sdpa, "plain_calls")
    return out


def launch_counts():
    """{counter: value} of every kernel's launch counter and of
    `sdpa.plain_calls`."""
    return {name: getattr(obj, attr)
            for name, (obj, attr) in _counters().items()}


def add_launch_counts(delta, times=1):
    """Add `times` x `delta` ({counter: n}, as `launch_counts` names them)
    to the counters: a CUDA graph replay launches the kernels its capture
    recorded without running the wrappers that count them."""
    for name, (obj, attr) in _counters().items():
        n = delta.get(name, 0)
        if n:
            setattr(obj, attr, getattr(obj, attr) + n * times)
