"""Parameter initializers (counterpart: `paddle_tpu/nn/initializer.py`).

An initializer is called on a tensor, `init(t, generator=None)`, and
fills it in place; random ones draw from `generator` (None: PyTorch's
default generator of the tensor's device).  The JAX package draws from
its key stream, so one seed gives other values there: the two agree on
what the draws fix exactly (Constant, Assign, Dirac, Bilinear, the
orthogonality of Orthogonal, the bounds) and on their moments.

Every initializer works in the JAX package's layout.  A `Linear` weight
is [out, in] in the port and [in, out] there; `Linear` marks its weight
(`_paddle_transposed`), and an initializer fills the [in, out] view of a
marked tensor.  So the fans of Xavier and Kaiming, the rows of
Orthogonal and the value of `Assign` are those of the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Assign", "Bilinear", "Constant", "Dirac", "Initializer",
           "KaimingNormal", "KaimingUniform", "Normal", "Orthogonal",
           "TruncatedNormal", "Uniform", "XavierNormal", "XavierUniform",
           "calculate_gain", "set_global_initializer"]


def _view(t):
    """`t` in the JAX package's layout: a marked [out, in] Linear weight
    as its [in, out] view."""
    return t.t() if getattr(t, "_paddle_transposed", False) else t


@torch.no_grad()
def _fill_float32(t, draw):
    """Fill `t`'s reference view with `draw(tmp)` made in float32 on its
    device, rounded once to its dtype (as the JAX initializers draw in
    float32 and cast).  A marked weight takes `tmp.t()` whole, which
    copies by blocks, where a copy into its transposed view goes element
    by element."""
    v = _view(t)
    tmp = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    draw(tmp)
    if v is t:
        t.copy_(tmp)
    else:
        t.copy_(tmp.t())
    return t


class Initializer:
    def __call__(self, tensor, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    @torch.no_grad()
    def __call__(self, t, generator=None):
        t.fill_(self.value)
        return t


class Assign(Initializer):
    """Copies `value` (array-like or tensor, in the JAX package's layout)
    into the tensor, cast to its dtype and reshaped to its shape."""

    def __init__(self, value):
        self.value = value

    @torch.no_grad()
    def __call__(self, t, generator=None):
        v = _view(t)
        src = self.value
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.array(src))
        v.copy_(src.to(device=v.device, dtype=v.dtype).reshape(v.shape))
        return t


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, t, generator=None):
        return _fill_float32(t, lambda x: x.normal_(
            self.mean, self.std, generator=generator))


class TruncatedNormal(Initializer):
    """A normal cut at two standard deviations from the mean."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, t, generator=None):
        return _fill_float32(t, lambda x: torch.nn.init.trunc_normal_(
            x, self.mean, self.std, self.mean - 2.0 * self.std,
            self.mean + 2.0 * self.std, generator=generator))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, t, generator=None):
        return _fill_float32(t, lambda x: x.uniform_(
            self.low, self.high, generator=generator))


def _fans(shape):
    """(fan_in, fan_out) of a shape in the JAX package's layout: a vector
    (n, n), a matrix [in, out], a convolution OIHW... (in and out times
    the receptive field)."""
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


def _ref_shape(t):
    return tuple(_view(t).shape)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, t, generator=None):
        fi, fo = _fans(_ref_shape(t))
        fi, fo = self.fan_in or fi, self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(t, generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, t, generator=None):
        fi, fo = _fans(_ref_shape(t))
        fi, fo = self.fan_in or fi, self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(t, generator)


class KaimingUniform(Initializer):
    """Uniform with limit gain * sqrt(3 / fan_in), gain sqrt(2 / (1 +
    negative_slope^2)); `nonlinearity` is taken and changes nothing, as
    in the JAX package."""

    def __init__(self, negative_slope=0.0, nonlinearity="leaky_relu",
                 fan_in=None):
        self.a, self.fan_in = negative_slope, fan_in

    def __call__(self, t, generator=None):
        fi = self.fan_in or _fans(_ref_shape(t))[0]
        gain = math.sqrt(2.0 / (1 + self.a ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(t, generator)


class KaimingNormal(Initializer):
    def __init__(self, negative_slope=0.0, nonlinearity="leaky_relu",
                 fan_in=None):
        self.a, self.fan_in = negative_slope, fan_in

    def __call__(self, t, generator=None):
        fi = self.fan_in or _fans(_ref_shape(t))[0]
        gain = math.sqrt(2.0 / (1 + self.a ** 2))
        return Normal(0.0, gain / math.sqrt(fi))(t, generator)


class Orthogonal(Initializer):
    """gain times an orthonormal matrix of [rows, size / rows] (rows the
    first dim in the JAX package's layout): orthonormal rows when rows <=
    columns, else orthonormal columns; the QR of a normal draw with R's
    diagonal signs folded in."""

    def __init__(self, gain=1.0):
        self.gain = gain

    @torch.no_grad()
    def __call__(self, t, generator=None):
        v = _view(t)
        rows = v.shape[0]
        cols = v.numel() // rows
        a = torch.empty(max(rows, cols), min(rows, cols),
                        dtype=torch.float32, device=v.device)
        a.normal_(generator=generator)
        q, r = torch.linalg.qr(a.cpu())
        q = (q * torch.sign(torch.diagonal(r))).to(v.device)
        if rows < cols:
            q = q.t()
        v.copy_((self.gain * q[:rows, :cols]).reshape(v.shape))
        return t


class Dirac(Initializer):
    """An OIHW... convolution weight that passes input channel i to output
    channel i (i < min(O, I)) through its kernel's centre."""

    @torch.no_grad()
    def __call__(self, t, generator=None):
        t.zero_()
        m = min(t.shape[0], t.shape[1])
        idx = (torch.arange(m), torch.arange(m)) + tuple(
            s // 2 for s in t.shape[2:])
        t[idx] = 1.0
        return t


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = param if param is not None else 0.01
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


class Bilinear(Initializer):
    """The bilinear-upsampling kernel in every (out, in) slot of a 4-D
    transpose-convolution weight."""

    @torch.no_grad()
    def __call__(self, t, generator=None):
        if t.dim() != 4:
            raise ValueError("Bilinear initializer expects 4-D weights")
        kh, kw = t.shape[2], t.shape[3]
        fh, fw = (kh + 1) // 2, (kw + 1) // 2
        ch = (2 * fh - 1 - fh % 2) / (2.0 * fh)
        cw = (2 * fw - 1 - fw % 2) / (2.0 * fw)
        og = np.ogrid[:kh, :kw]
        filt = (1 - abs(og[0] / fh - ch)) * (1 - abs(og[1] / fw - cw))
        t.copy_(torch.from_numpy(filt.astype(np.float32)).expand(t.shape))
        return t


_GLOBAL_INIT = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """Record process-wide default initializers; None clears.  As in the
    JAX package, the record is kept and no layer reads it."""
    _GLOBAL_INIT["weight"] = weight_init
    _GLOBAL_INIT["bias"] = bias_init
