"""Quantization (counterpart: `paddle_tpu/quantization/__init__.py`;
reference: python/paddle/quantization): `QuantConfig`, `QAT`, `PTQ`, the
quanted layers and the int8 inference layer.

Fake quantization is symmetric int8 (127 levels a side) with the
straight-through gradient: it passes inside the clip range, is zero
outside it, and the scale gets none (`_FakeQuant`, the JAX package's
`jax.custom_vjp`).  QAT's quanters keep a moving absmax scale, PTQ's
observers a running absmax, both as float32 buffers.  `QAT.convert`
turns each `QuantedLinear` into an `Int8Linear` (int8 weight [in, out]
as the JAX package keeps it, its scale and the activation scale as
buffers) and folds each `QuantedConv2D`'s weight fake-quant into the
float conv.

`Int8Linear` multiplies int8 by int8 into int32 with `torch._int_mm`,
the library's int8 GEMM (the JAX package's `lax.dot_general` with an
int32 result, outside any Pallas kernel).  On CUDA `_int_mm` takes
M > 16 and K, N multiples of 8; a shape that falls short is padded with
zeros, which add nothing to an int32 sum, so the product stays exact.

Quanters and observers build their buffers on `device` (the card
unless told otherwise, as every port layer); `QAT.quantize` moves them
to the device of the layer they wrap.
"""
from __future__ import annotations

import copy

import torch

from .. import nn, ops  # noqa: F401  (bound as in the JAX package)
from ..device import resolve_device
from ..nn import functional as F
from ..nn.conv import Conv2D
from ..nn.layer import Layer
from ..tensor import Tensor  # noqa: F401

__all__ = ["QuantConfig", "QAT", "PTQ", "FakeQuanterWithAbsMax",
           "AbsmaxObserver", "QuantedLinear", "QuantedConv2D",
           "Int8Linear", "quant_absmax", "fake_quantize"]


# ------------------------------------------------------------ fake quant op
class _FakeQuant(torch.autograd.Function):
    """Symmetric int8 quantize-dequantize with the straight-through
    gradient."""

    @staticmethod
    def forward(ctx, x, scale):
        s = scale.clamp(min=1e-8)
        ctx.save_for_backward(x, s)
        q = torch.clamp(torch.round(x / s * 127.0), -127.0, 127.0)
        return q * s / 127.0

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * (x.abs() <= s).to(g.dtype), None


def fake_quantize(x, scale):
    """Quantize-dequantize `x` by `scale` (a tensor or a number), the
    straight-through gradient to `x` (QAT's building block)."""
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(float(scale), dtype=torch.float32,
                             device=x.device)
    return _FakeQuant.apply(x, scale.to(x.device))


def quant_absmax(x):
    """max |x| as a Python float (one host read)."""
    return float(x.detach().abs().max())


# -------------------------------------------------------------- quanters
class FakeQuanterWithAbsMax(Layer):
    """QAT's activation / weight quanter: in training the scale moves to
    `moving_rate` x scale + (1 - moving_rate) x max |x| (the first call
    takes max |x|), then fake quant by it; in eval the kept scale."""

    def __init__(self, moving_rate=0.9, device=None):
        super().__init__()
        self.moving_rate = moving_rate
        dev = dict(dtype=torch.float32, device=resolve_device(device))
        self.register_buffer("scale", torch.ones((), **dev))
        self.register_buffer("initialized", torch.zeros((), **dev))

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                cur = x.detach().abs().max().to(torch.float32)
                r = self.moving_rate
                init = self.initialized
                self.scale.copy_(init * (self.scale * r + cur * (1 - r))
                                 + (1.0 - init) * cur)
                self.initialized.fill_(1.0)
            # a copy: a later call's update must not touch the scale this
            # call's backward reads
            return fake_quantize(x, self.scale.clone())
        return fake_quantize(x, self.scale)


class AbsmaxObserver(Layer):
    """PTQ's observer: keeps the running max |x|, passes x unchanged."""

    def __init__(self, device=None):
        super().__init__()
        self.register_buffer("scale", torch.zeros(
            (), dtype=torch.float32, device=resolve_device(device)))

    def forward(self, x):
        with torch.no_grad():
            torch.maximum(self.scale,
                          x.detach().abs().max().to(torch.float32),
                          out=self.scale)
        return x


# ---------------------------------------------------------- quanted layers
def _follow(quanter, layer):
    """`quanter` moved to the device of `layer`'s weight."""
    return quanter.to(layer.weight.device)


class QuantedLinear(Layer):
    """A Linear with an activation and a weight quanter (QAT) or
    observer (PTQ)."""

    def __init__(self, layer, act_quanter, w_quanter):
        super().__init__()
        self.inner = layer
        self.act_q = _follow(act_quanter, layer)
        self.w_q = _follow(w_quanter, layer)

    def forward(self, x):
        return torch.nn.functional.linear(self.act_q(x),
                                          self.w_q(self.inner.weight),
                                          self.inner.bias)


class QuantedConv2D(Layer):
    """A Conv2D with an activation and a weight quanter or observer."""

    def __init__(self, layer, act_quanter, w_quanter):
        super().__init__()
        self.inner = layer
        self.act_q = _follow(act_quanter, layer)
        self.w_q = _follow(w_quanter, layer)

    def forward(self, x):
        L = self.inner
        return F.conv2d(self.act_q(x), self.w_q(L.weight), L.bias,
                         L.stride, L.padding, L.dilation, L.groups,
                         L.data_format)


def _int8(x, scale):
    return torch.clamp(torch.round(x / scale * 127.0), -127,
                       127).to(torch.int8)


def int8_matmul(a, b):
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32 by `torch._int_mm`,
    zero-padded to M > 16 and K, N multiples of 8 where the shape falls
    short (zeros add nothing, so the product is exact)."""
    M, K = a.shape
    N = b.shape[1]
    pm, pk, pn = max(0, 17 - M), (-K) % 8, (-N) % 8
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = torch.nn.functional.pad(b, (0, pn, 0, pk))
    return torch._int_mm(a, b)[:M, :N]


class Int8Linear(Layer):
    """The converted inference layer: `w_int8` [in, out] int8, `w_scale`
    and `act_scale` float32 buffers; the input is quantized by the
    activation scale, multiplied int8 x int8 -> int32 (`int8_matmul`)
    and dequantized once."""

    def __init__(self, layer, w_scale, act_scale):
        super().__init__()
        w = layer.weight.detach()
        dev = dict(dtype=torch.float32, device=w.device)
        s = max(float(w_scale), 1e-8)
        self.register_buffer("w_int8", _int8(w.t().to(torch.float32),
                                             torch.tensor(s, **dev))
                             .contiguous())
        self.register_buffer("w_scale", torch.tensor(s, **dev))
        self.register_buffer("act_scale", torch.tensor(
            max(float(act_scale), 1e-8), **dev))
        self.bias = layer.bias

    def forward(self, x):
        x_q = _int8(x.to(torch.float32), self.act_scale)
        acc = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), self.w_int8)
        out = acc.to(torch.float32) * (self.act_scale * self.w_scale
                                       / (127.0 * 127.0))
        out = out.reshape(tuple(x.shape[:-1]) + (acc.shape[-1],)).to(x.dtype)
        return out if self.bias is None else out + self.bias


# ------------------------------------------------------------------ config
class QuantConfig:
    """Which layers get which quanters: `activation` / `weight` are
    factories (callables returning a quanter layer), the defaults
    `FakeQuanterWithAbsMax`; `add_type_config` overrides them for a
    layer type and adds it to the quantized types (Linear and Conv2D by
    default)."""

    def __init__(self, activation=None, weight=None):
        self.activation = activation or (lambda: FakeQuanterWithAbsMax())
        self.weight = weight or (lambda: FakeQuanterWithAbsMax())
        self._types = (torch.nn.Linear, Conv2D)
        self._per_type = {}

    def add_type_config(self, types, activation=None, weight=None):
        types = tuple(types) if isinstance(types, (list, tuple)) \
            else (types,)
        for t in types:
            self._per_type[t] = (activation or self.activation,
                                 weight or self.weight)
        self._types = tuple(set(self._types) | set(types))

    def factories_for(self, layer):
        return self._per_type.get(type(layer),
                                  (self.activation, self.weight))


def _swap_layers(model, cfg, make):
    for name, child in list(model._modules.items()):
        if isinstance(child, cfg._types):
            setattr(model, name, make(child))
        elif child is not None:
            _swap_layers(child, cfg, make)
    return model


def _scale_of(quanter):
    return float(quanter.scale) if hasattr(quanter, "scale") else 0.0


class QAT:
    """Quantization-aware training: `quantize` wraps the configured
    layers with fake quant, the model trains as usual, `convert` freezes
    it to int8 inference layers."""

    def __init__(self, config=None):
        self.config = config or QuantConfig()

    def quantize(self, model, inplace=True):
        if not inplace:
            model = copy.deepcopy(model)
        cfg = self.config

        def make(layer):
            q_cls = QuantedConv2D if isinstance(layer, Conv2D) \
                else QuantedLinear
            act_f, w_f = cfg.factories_for(layer)
            return q_cls(layer, act_f(), w_f())

        return _swap_layers(model, cfg, make)

    @torch.no_grad()
    def convert(self, model, inplace=True):
        if not inplace:
            model = copy.deepcopy(model)

        def act_scale_of(child, what):
            s = _scale_of(child.act_q)
            if s <= 0.0:
                raise ValueError(
                    f"{what} has an uncalibrated activation scale (0.0) — "
                    "run training (QAT) or calibration forwards (PTQ) "
                    "before convert()")
            return s

        def conv(m):
            for name, child in list(m._modules.items()):
                if isinstance(child, QuantedLinear):
                    w_scale = _scale_of(child.w_q) \
                        or quant_absmax(child.inner.weight)
                    setattr(m, name, Int8Linear(
                        child.inner, w_scale,
                        act_scale_of(child, f"QuantedLinear '{name}'")))
                elif isinstance(child, QuantedConv2D):
                    inner = child.inner
                    w_scale = _scale_of(child.w_q) \
                        or quant_absmax(inner.weight)
                    inner.weight.copy_(fake_quantize(inner.weight, w_scale))
                    setattr(m, name, inner)
                elif child is not None:
                    conv(child)
            return m
        return conv(model)


class PTQ(QAT):
    """Post-training quantization: observers collect absmax over
    calibration forwards (in eval mode), then `convert`."""

    def __init__(self, config=None):
        if config is None:
            config = QuantConfig(activation=AbsmaxObserver,
                                 weight=AbsmaxObserver)
        super().__init__(config)
