"""Weight-only int8 / int4 quantization for serving.

Counterpart: `paddle_tpu/nn/quant.py:21-181` — `weight_quantize`,
`weight_only_linear`, `WeightOnlyLinear` and `convert_to_weight_only`,
with the same codes, scales and rounding order.  The layouts are the JAX
package's, so a converted model carries across name for name and bit for
bit (`weights.load_paddle_tpu_state`):

* `quant_weight` is an int8 buffer [in, out] (int8) or [ceil(in / 2),
  out] (int4: two codes a byte along the IN axis, the even row in the
  low nibble);
* `weight_scale` is a float32 [out] parameter that takes no gradient
  (the per-output-channel absmax; w ~ q * scale / 127, or / 7 for int4).
  As a parameter, `amp.decorate` casts it as the JAX package's does; the
  int8 buffer stays int8.

`weight_only_linear` dequantizes in the compute dtype in the JAX rounding
order, `q.to(cdt) * (scale / 127).to(cdt)` (one promoting product), then
calls `torch.matmul`:
the JAX package leaves the fusion of the dequantize into the product to
XLA and has no Pallas kernel here.  Each call on the card therefore
writes a dequantized copy of the weight before its product.
"""
from __future__ import annotations

import torch
from torch import nn

_LEVELS = {"int8": 127.0, "int4": 7.0}


def _absmax_scale(w):
    s = w.abs().amax(dim=0)
    return torch.where(s == 0, torch.ones_like(s), s)


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """Quantize a 2-D weight x [in, out] (the JAX package's Linear layout;
    a `torch.nn.Linear` weight is its transpose).  Returns (codes, scale):
    int8 [in, out] or nibble-packed int4 [ceil(in / 2), out], and a
    float32 scale [out].  `arch` is a CUDA SM hint of the reference API
    and is ignored."""
    if group_size != -1:
        raise NotImplementedError(
            "weight_quantize: grouped scales are not supported; "
            "per-output-channel scales only")
    w = x.detach().float()
    if w.dim() != 2:
        raise ValueError(f"weight_quantize expects 2-D weights, got "
                         f"{tuple(w.shape)}")
    if algo not in ("weight_only_int8", "weight_only_int4"):
        raise ValueError(f"unknown weight_quantize algo {algo!r}")
    scale = _absmax_scale(w)
    n = _LEVELS[algo[-4:]]
    q = torch.clamp(torch.round(w / scale * n), -n, n).to(torch.int8)
    if algo == "weight_only_int8":
        return q, scale
    if q.shape[0] % 2:
        q = torch.cat([q, q.new_zeros(1, q.shape[1])])
    return (q[0::2] & 0x0F) | ((q[1::2] & 0x0F) << 4), scale


def _unpack_int4(packed, k):
    """[ceil(k / 2), n] nibble pairs -> [k, n] int8 codes in [-7, 7]."""
    lo = ((packed << 4).to(torch.int8) >> 4)     # sign-extended low nibble
    hi = packed >> 4                             # arithmetic shift: signed
    return torch.stack([lo, hi], dim=1).reshape(-1, packed.shape[1])[:k]


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", group_size=-1):
    """y = x @ dequant(weight) + bias, dequantized in x's dtype."""
    if group_size != -1:
        raise NotImplementedError(
            "weight_only_linear: grouped scales are not supported; "
            "per-output-channel scales only")
    if weight_scale is None:
        raise ValueError("weight_only_linear requires weight_scale "
                         "(from weight_quantize)")
    if weight_dtype not in _LEVELS:
        raise ValueError(f"weight_dtype {weight_dtype!r}")
    cdt = x.dtype
    q = weight if weight_dtype == "int8" else \
        _unpack_int4(weight, x.shape[-1])
    # int8 codes times a cdt scale promote to cdt in one pass; a code is
    # exact in any float dtype, so this is q.to(cdt) * scale rounded once
    w = q * (weight_scale / _LEVELS[weight_dtype]).to(cdt)
    y = torch.matmul(x, w)
    return y if bias is None else y + bias.to(cdt)


class WeightOnlyLinear(nn.Module):
    """A Linear with int8 / int4 weights.  Build it from a trained Linear
    with `from_linear`, or convert a model with `convert_to_weight_only`.
    `WeightOnlyLinear(in, out)` alone holds zero codes and unit scales,
    to be loaded."""

    def __init__(self, in_features, out_features, weight_dtype="int8",
                 bias=True, device=None, dtype=torch.float32):
        super().__init__()
        if weight_dtype not in _LEVELS:
            raise ValueError(
                f"WeightOnlyLinear weight_dtype must be 'int8' or "
                f"'int4', got {weight_dtype!r}")
        self.in_features, self.out_features = in_features, out_features
        self.weight_dtype = weight_dtype
        rows = in_features if weight_dtype == "int8" \
            else (in_features + 1) // 2
        self.register_buffer("quant_weight", torch.zeros(
            rows, out_features, dtype=torch.int8, device=device))
        self.weight_scale = nn.Parameter(
            torch.ones(out_features, dtype=torch.float32, device=device),
            requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                             device=device)) \
            if bias else None

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear, algo="weight_only_int8"):
        """Quantize `linear` (a `torch.nn.Linear`, weight [out, in]); the
        layer lands on its device, the bias in its dtype."""
        out_f, in_f = linear.weight.shape
        w = linear.weight
        m = cls(in_f, out_f, weight_dtype=algo[-4:],
                bias=linear.bias is not None, device=w.device,
                dtype=w.dtype)
        q, s = weight_quantize(w.t(), algo=algo)
        m.quant_weight.copy_(q)
        m.weight_scale.copy_(s)
        if linear.bias is not None:
            m.bias.copy_(linear.bias)
        return m

    def forward(self, x):
        return weight_only_linear(x, self.quant_weight, bias=self.bias,
                                  weight_scale=self.weight_scale,
                                  weight_dtype=self.weight_dtype)

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.out_features}, "
                f"weight_dtype={self.weight_dtype}")


def convert_to_weight_only(model, algo="weight_only_int8",
                           skip=lambda name, layer: False):
    """Swap every `torch.nn.Linear` of `model` (IN PLACE; returns model)
    for a WeightOnlyLinear on the Linear's device; `skip(name, layer)`
    exempts layers by their dotted path (e.g. "lm_head")."""

    def _convert(parent, prefix):
        for name, sub in list(parent.named_children()):
            full = f"{prefix}.{name}" if prefix else name
            if isinstance(sub, nn.Linear) and not skip(full, sub):
                setattr(parent, name,
                        WeightOnlyLinear.from_linear(sub, algo=algo))
            else:
                _convert(sub, full)

    _convert(model, "")
    return model
