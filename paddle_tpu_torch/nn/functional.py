"""Functional ops of the training path and the LLaMA family.

Counterpart: `paddle_tpu/nn/functional.py` — `dropout` (`:117-129`),
`scaled_dot_product_attention` (`:400-428`) and `cross_entropy`
(`:432-454`, over `softmax_ce_k` in `paddle_tpu/ops/nn_kernels.py:415-430`).
Ported here: what the GPT training step runs — upscale-in-train dropout,
attention with dropout on its output, and hard-label cross entropy with
`ignore_index` — and what the LLaMA family adds: `silu` (`:19`) and
`rms_norm` (`rms_norm_k`, `paddle_tpu/ops/nn_kernels.py:266-272`).
Weighted, soft-label and smoothed cross entropy are not ported yet.

Randomness goes through an explicit `torch.Generator` (None: PyTorch's
default generator of the tensor's device).  The JAX package draws from
its key stream; the two give different masks from one seed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import ops


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout: each element is kept with probability
    1 - p and scaled by 1 / (1 - p); identity when not training or p == 0.
    The keep mask is drawn from `generator` on x's device."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u >= p, x / (1.0 - p), torch.zeros_like(x))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None,
                                 sliding_window=None, generator=None):
    """(B, L, H, D) attention through `ops.sdpa` (the flash kernels on the
    card inside their gate).  Dropout applies to the attention OUTPUT in
    training, as the JAX package does (`:426-427`), not to the
    probabilities.  A window without causal raises ValueError on every
    device."""
    if sliding_window and not is_causal:
        raise ValueError("sliding_window requires is_causal=True")
    out = ops.sdpa(query, key, value, mask=attn_mask, is_causal=is_causal,
                   scale=scale, sliding_window=sliding_window,
                   _mask_needs_grad=attn_mask is not None
                   and attn_mask.requires_grad)
    if dropout_p > 0.0 and training:
        out = dropout(out, dropout_p, training=True, generator=generator)
    return out


def silu(x):
    """x * sigmoid(x) (`jax.nn.silu`), computed in float32 and rounded
    once to x's dtype, as XLA's fused elementwise ops round."""
    return F.silu(x)


def rms_norm(x, weight=None, epsilon=1e-6):
    """Root-mean-square norm over the last axis, in the JAX package's
    rounding order (`ops.nn_kernels.rms_norm`)."""
    return ops.rms_norm(x, weight, epsilon)


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """Hard-label softmax cross entropy over the last axis, logits in
    float32.  Labels equal to `ignore_index` give 0; "mean" divides the sum
    by the number of valid labels (at least 1e-12), as the JAX package
    does, so an all-ignored batch gives 0 and not NaN."""
    logits = input.float()
    n = logits.shape[-1]
    loss = F.cross_entropy(logits.reshape(-1, n), label.reshape(-1).long(),
                           ignore_index=ignore_index, reduction="none")
    loss = loss.reshape(label.shape)
    if reduction == "none":
        return loss
    if reduction != "mean":
        raise ValueError(f"reduction must be 'mean' or 'none', not "
                         f"{reduction!r}")
    valid = (label != ignore_index).to(loss.dtype)
    return loss.sum() / valid.sum().clamp(min=1e-12)
