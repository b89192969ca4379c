"""The fused functions of the incubate package.

Counterpart: `paddle_tpu/incubate/nn/functional.py`, where "fused" means
one region that XLA fuses.  Here each is the same arithmetic in torch ops
(attention inside the fused layers goes through the port's flash
kernels; these functions have no kernel of their own).  Dropout draws
from `generator` (None: the device's default generator), as
`nn.functional.dropout` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...nn import functional as PF

__all__ = ["fused_bias_dropout_residual_layer_norm", "fused_dropout_add",
           "fused_layer_norm", "fused_linear", "fused_rms_norm",
           "fused_rotary_position_embedding", "swiglu"]


def _layer_norm(x, shape, weight, bias, epsilon):
    """Layer norm over the trailing `shape`; a weight or bias of another
    shape broadcasts, as the JAX kernel multiplies it in."""
    shape = tuple(shape)
    if all(t is None or tuple(t.shape) == shape for t in (weight, bias)):
        return F.layer_norm(x, shape, weight, bias, epsilon)
    out = F.layer_norm(x, shape, None, None, epsilon)
    if weight is not None:
        out = out * weight
    return out if bias is None else out + bias


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1):
    """RMS norm of the last axis, scaled (and shifted by `norm_bias`)."""
    if begin_norm_axis not in (-1, x.dim() - 1):
        raise NotImplementedError(
            "fused_rms_norm normalizes the last axis only")
    out = PF.rms_norm(x, norm_weight, epsilon)
    return out if norm_bias is None else out + norm_bias


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, residual=None):
    """Layer norm of x (+ `residual`) over the axes from
    `begin_norm_axis` on."""
    if residual is not None:
        x = x + residual
    axis = begin_norm_axis % x.dim()
    return _layer_norm(x, x.shape[axis:], norm_weight, norm_bias, epsilon)


def swiglu(x, y=None):
    """silu(x) * y; with one input, its last axis split in half."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y


def _rope(x, cos, sin, neox):
    if neox:
        x1, x2 = torch.chunk(x, 2, dim=-1)
        rot = torch.cat([-x2, x1], dim=-1)
        return x * torch.cat([cos, cos], -1) + rot * torch.cat([sin, sin], -1)
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    rotary_emb_base=10000.0):
    """RoPE on q and k [b, s, h, d] (v passes through): (q, k, v), None
    where not given.  `sin` / `cos` hold [s, d / 2] angles (any shape of
    that size); without them the angles come from `position_ids` [b, s]
    (default arange) and `rotary_emb_base`.  Neox style rotates the two
    halves, the other style interleaved pairs."""
    b, s, h, d = q.shape
    if sin is not None:
        sin_a = sin.reshape(1, s, 1, -1)
        cos_a = cos.reshape(1, s, 1, -1)
    else:
        pos = (position_ids.float() if position_ids is not None else
               torch.arange(s, dtype=torch.float32, device=q.device)[None])
        inv = 1.0 / (rotary_emb_base ** (torch.arange(
            0, d, 2, dtype=torch.float32, device=q.device) / d))
        ang = pos[..., None] * inv                          # [b?, s, d/2]
        sin_a = torch.sin(ang)[:, :, None, :]
        cos_a = torch.cos(ang)[:, :, None, :]
    rot = [_rope(t, cos_a, sin_a, use_neox_rotary_style)
           if t is not None else None for t in (q, k)]
    return rot[0], rot[1], v


def fused_linear(x, weight, bias=None, transpose_weight=False):
    """x @ weight + bias, weight [in, out] (or [out, in] with
    `transpose_weight`)."""
    return F.linear(x, weight if transpose_weight else weight.t(), bias)


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      *, generator=None):
    """dropout(x) + y."""
    return PF.dropout(x, p, training=training, mode=mode,
                      generator=generator) + y


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, epsilon=1e-5,
                                           training=True, *,
                                           generator=None):
    """layer_norm(dropout(x + bias) + residual) over the last axis."""
    if bias is not None:
        x = x + bias
    out = PF.dropout(x, dropout_rate, training=training,
                     generator=generator) + residual
    return _layer_norm(out, out.shape[-1:], ln_scale, ln_bias, epsilon)
