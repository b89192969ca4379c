"""The top-level tensor functions (counterpart: `paddle_tpu/tensor_api.py`;
reference: python/paddle/tensor/*.py), star-imported by the package.

Plain functions on torch tensors with the reference's Paddle signatures:
`axis` for torch's `dim`, `keepdim`, and `name` / `name_arg` arguments
taken and ignored.  The module defines `sum`, `max`, `min`, `abs`,
`all`, `any`, `round`, `pow` and `slice`, so Python's own are reached
through `builtins` here, as in the reference.

Devices.  A creation function (`zeros`, `arange`, `rand`, `eye`, ...)
resolves its device as `to_tensor` does (`device.resolve_device`): the
card unless its `device=` argument or an earlier `set_device("cpu")`
names the CPU, and RuntimeError without a card.  A function of tensors
works on their device; a Python scalar or list beside a tensor lands on
that tensor's device.

Semantics kept from the reference where torch's differ:
- `max` / `min` return the values only; `median` and `nanmedian`
  average the two middle values (`jnp.median`); `cumsum(axis=None)` and
  `cumprod(dim=None)` flatten; `std` / `var` are unbiased by default.
- `floor_divide`, `mod` and `remainder` follow Python's sign rule;
  `polygamma(x, n)` takes the order second.
- `sort`, `argsort`, `topk` and `kthvalue` are stable: ties keep their
  index order, the descending ones too (the reference's
  `argsort(-x)`); `mode` returns the smallest of the most frequent values
  with its last index.
- `scatter(overwrite=False)` adds the updates to `x` without zeroing the
  rows first (the reference's `.at[].add`).
- `one_hot` is a comparison with an `arange` (float, a zero row for an
  index out of range), never a device assert.
- `take(mode="raise")` checks its bounds on the host, then clamps as
  "clip" does (negative indices clamp to 0, as `jnp.take` clips).

The reference computes `unique`, `unique_consecutive`, `nonzero`,
`masked_select`, `histogram` and `histogramdd` on the host with numpy;
the port keeps them on the device (`unique`'s first occurrences from a
scatter of positions: `torch.unique` has no `return_index`).

Random functions go through torch's factories (`torch.rand`, `randn`,
`randint`, `randperm`, `bernoulli`, `multinomial`), so static mode
marks them pending and draws anew on every `Executor.run`; `seed` is
`framework.random.seed`.  Threefry and Philox never give the same
numbers: only shapes, dtypes, ranges and moments carry across.

Intended divergences (ROADMAP.md C): integer results keep torch's int64
where the reference's JAX (x64 off) gives int32 (`arange`, `argmax`,
`sum` of integers, `nonzero`, `unique`, `tril_indices`, ...), and
float64 requests stay float64.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from . import dtypes
from .api import to_tensor
from .device import resolve_device
from .dtypes import finfo, iinfo
from .framework.random import seed


# ------------------------------------------------------------------ helpers
def _t(x, ref=None, device=None):
    """`x` as a tensor: a tensor as it is; a Python scalar beside `ref`
    in `ref`'s dtype where the reference keeps it (`_coerce_scalar`), on
    `ref`'s device; anything else as `to_tensor` makes it (float64 data
    the default dtype), on `device` or the resolved one."""
    if isinstance(x, torch.Tensor):
        return x
    if ref is not None and isinstance(x, (bool, np.bool_)):
        return torch.tensor(bool(x), device=ref.device)
    if ref is not None and isinstance(x, (int, float, np.number)):
        if ref.is_floating_point() or ref.is_complex() or \
                isinstance(x, (int, np.integer)):
            return torch.tensor(x, dtype=ref.dtype, device=ref.device)
        return torch.tensor(x, dtype=dtypes.get_default_dtype(),
                            device=ref.device)
    if device is None and ref is not None:
        device = ref.device
    arr = np.asarray(x)
    dt = dtypes.get_default_dtype() if arr.dtype == np.float64 else None
    return torch.as_tensor(arr, dtype=dt, device=resolve_device(device))


def _dt(dtype):
    return dtypes.convert_dtype(dtype) or dtypes.get_default_dtype()


def _int(v):
    return builtins.int(v.item() if isinstance(v, torch.Tensor) else v)


def _num(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (builtins.int, np.integer)):
        return [builtins.int(shape)]
    return [_int(s) for s in shape]


def _axes(axis):
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(builtins.int(a) for a in axis)
    return axis


def _float(x):
    """Integers and bools computed in the default dtype, as jnp's float
    functions promote them."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(dtypes.get_default_dtype())


# ------------------------------------------------------------------ creation
def zeros(shape, dtype=None, device=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=resolve_device(device))


def ones(shape, dtype=None, device=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=resolve_device(device))


def full(shape, fill_value, dtype=None, device=None):
    fill_value = _num(fill_value)
    if dtype is None and isinstance(fill_value, builtins.int):
        dtype = dtypes.int64
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=resolve_device(device))


def empty(shape, dtype=None, device=None):
    return zeros(shape, dtype, device=device)


def zeros_like(x, dtype=None):
    return torch.zeros_like(_t(x), dtype=dtypes.convert_dtype(dtype))


def ones_like(x, dtype=None):
    return torch.ones_like(_t(x), dtype=dtypes.convert_dtype(dtype))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(_t(x), _num(fill_value),
                           dtype=dtypes.convert_dtype(dtype))


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, device=None):
    start, end, step = _num(start), _num(end), _num(step)
    if end is None:
        start, end = 0, start
    d = dtypes.convert_dtype(dtype)
    if d is None:
        d = dtypes.int64 if builtins.all(
            isinstance(v, builtins.int) for v in (start, end, step)) \
            else dtypes.get_default_dtype()
    return torch.arange(start, end, step, dtype=d,
                        device=resolve_device(device))


def linspace(start, stop, num, dtype=None, device=None):
    return torch.linspace(_num(start), _num(stop), _int(num),
                          dtype=_dt(dtype), device=resolve_device(device))


def logspace(start, stop, num, base=10.0, dtype=None, device=None):
    return torch.logspace(_num(start), _num(stop), _int(num),
                          base=_num(base), dtype=_dt(dtype),
                          device=resolve_device(device))


def eye(num_rows, num_columns=None, dtype=None, device=None):
    n = _int(num_rows)
    m = n if num_columns is None else _int(num_columns)
    return torch.eye(n, m, dtype=_dt(dtype), device=resolve_device(device))


def diag(x, offset=0):
    return torch.diag(_t(x), offset)


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(_t(x), offset, dim1, dim2)


def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_t(x), offset, axis1, axis2)


def meshgrid(*args):
    return list(torch.meshgrid(*[_t(a) for a in args], indexing="ij"))


def tril(x, diagonal=0):
    return torch.tril(_t(x), diagonal)


def triu(x, diagonal=0):
    return torch.triu(_t(x), diagonal)


def clone(x):
    return _t(x).clone()


def assign(x, output=None):
    """A new tensor with x's values, outside the graph; with `output`,
    x's values written into it."""
    src = _t(x)
    if output is None:
        return src.detach().clone()
    with torch.no_grad():
        output.copy_(src)
    return output


# -------------------------------------------------------------------- random
def rand(shape, dtype=None, device=None):
    return torch.rand(_shape(shape), dtype=_dt(dtype),
                      device=resolve_device(device))


def randn(shape, dtype=None, device=None):
    return torch.randn(_shape(shape), dtype=_dt(dtype),
                       device=resolve_device(device))


def uniform(shape, dtype=None, min=-1.0, max=1.0, device=None):
    u = torch.rand(_shape(shape), dtype=_dt(dtype),
                   device=resolve_device(device))
    return u * (_num(max) - _num(min)) + _num(min)


def normal(mean=0.0, std=1.0, shape=None, device=None):
    z = torch.randn(_shape(() if shape is None else shape),
                    dtype=dtypes.get_default_dtype(),
                    device=resolve_device(device))
    return z * std + mean


def randint(low=0, high=None, shape=(1,), dtype=None, device=None):
    low, high = _num(low), _num(high)
    if high is None:
        low, high = 0, low
    d = dtypes.convert_dtype(dtype if dtype is not None else dtypes.int64)
    return torch.randint(builtins.int(low), builtins.int(high),
                         _shape(shape), dtype=d,
                         device=resolve_device(device))


def randperm(n, dtype=None, device=None):
    d = dtypes.convert_dtype(dtype if dtype is not None else dtypes.int64)
    return torch.randperm(_int(n), dtype=d, device=resolve_device(device))


def multinomial(x, num_samples=1, replacement=False):
    return torch.multinomial(_t(x), _int(num_samples), replacement)


def bernoulli(x):
    return torch.bernoulli(_t(x))


# ------------------------------------------------------------- binary/math
def _floor_divide(x, y):
    return torch.div(x, y, rounding_mode="floor")


def _heaviside(x, y):
    return torch.heaviside(x, y.to(x.dtype))


_BINARY = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": torch.true_divide, "floor_divide": _floor_divide,
    "mod": torch.remainder, "remainder": torch.remainder, "pow": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum, "fmax": torch.fmax,
    "fmin": torch.fmin, "atan2": torch.atan2, "equal": torch.eq,
    "not_equal": torch.ne, "greater_than": torch.gt,
    "greater_equal": torch.ge, "less_than": torch.lt, "less_equal": torch.le,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor, "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or, "bitwise_xor": torch.bitwise_xor,
    "heaviside": _heaviside, "logaddexp": torch.logaddexp,
    "hypot": torch.hypot, "copysign": torch.copysign,
    "nextafter": torch.nextafter,
}


def _binop(name):
    fn = _BINARY[name]

    def f(x, y, name_arg=None):
        xt = _t(x)
        return fn(xt, _t(y, ref=xt))
    f.__name__ = f.__qualname__ = name
    return f


for _n in ("add", "subtract", "multiply", "divide", "floor_divide", "mod",
           "remainder", "pow", "maximum", "minimum", "fmax", "fmin", "atan2",
           "equal", "not_equal", "greater_than", "greater_equal", "less_than",
           "less_equal", "logical_and", "logical_or", "logical_xor",
           "bitwise_and", "bitwise_or", "bitwise_xor", "heaviside",
           "logaddexp", "hypot", "copysign", "nextafter"):
    globals()[_n] = _binop(_n)


def _real(x):
    return torch.real(x) if x.is_complex() else x


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


_UNARY = {
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "abs": torch.abs,
    "sign": torch.sign, "floor": torch.floor, "ceil": torch.ceil,
    "round": torch.round, "trunc": torch.trunc, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh, "tanh": torch.tanh, "asinh": torch.asinh,
    "acosh": torch.acosh, "atanh": torch.atanh, "erf": torch.erf,
    "erfinv": torch.erfinv, "reciprocal": torch.reciprocal,
    "square": torch.square, "sigmoid": torch.sigmoid,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "logical_not": torch.logical_not, "bitwise_not": torch.bitwise_not,
    "conj": lambda x: torch.conj(x).resolve_conj(), "real": _real,
    "imag": _imag, "digamma": torch.digamma, "lgamma": torch.lgamma,
    "frac": torch.frac, "neg": torch.neg, "i0": torch.special.i0,
}


def _unop(name):
    fn = _UNARY[name]

    def f(x, name_arg=None):
        return fn(_t(x))
    f.__name__ = f.__qualname__ = name
    return f


for _n in ("exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
           "abs", "sign", "floor", "ceil", "round", "trunc", "sin", "cos",
           "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh",
           "acosh", "atanh", "erf", "erfinv", "reciprocal", "square",
           "sigmoid", "isnan", "isinf", "isfinite", "logical_not",
           "bitwise_not", "conj", "real", "imag", "digamma", "lgamma",
           "frac", "neg", "i0"):
    globals()[_n] = _unop(_n)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = _t(x), _t(y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(x, y):
    return torch.matmul(_t(x), _t(y))


def bmm(x, y):
    return torch.matmul(_t(x), _t(y))


def dot(x, y):
    """`jnp.dot`: the last axis of x against the second-to-last of y
    (the only one of a vector); a 0-d operand multiplies."""
    x, y = _t(x), _t(y)
    if x.dim() == 0 or y.dim() == 0:
        return x * y
    return torch.tensordot(x, y, dims=([x.dim() - 1],
                                       [builtins.max(0, y.dim() - 2)]))


def cross(x, y, axis=-1):
    return torch.linalg.cross(_t(x), _t(y), dim=axis)


def outer(x, y):
    return torch.outer(_t(x).reshape(-1), _t(y).reshape(-1))


def einsum(equation, *operands):
    return torch.einsum(equation, *[_t(o) for o in operands])


def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * _t(input) + alpha * (_t(x) @ _t(y))


def lerp(x, y, weight):
    x = _t(x)
    return x + _t(weight, ref=x) * (_t(y) - x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    x = _t(x)
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def clip(x, min=None, max=None):
    """`jnp.clip` with scalar or Tensor bounds."""
    x = _t(x)
    if not isinstance(min, torch.Tensor) and \
            not isinstance(max, torch.Tensor):
        return torch.clamp(x, min=min, max=max)
    if min is not None:
        x = torch.maximum(x, _t(min, ref=x))
    if max is not None:
        x = torch.minimum(x, _t(max, ref=x))
    return x


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(_t(x), nan=nan, posinf=posinf, neginf=neginf)


def cast(x, dtype):
    return _t(x).to(dtypes.convert_dtype(dtype))


# --------------------------------------------------------------- reductions
def _all_dims(x, axis):
    if axis is None:
        return tuple(range(x.dim()))
    return (axis,) if isinstance(axis, builtins.int) else tuple(axis)


def _keep_none(out, x, keepdim):
    """A full reduction (axis None) with keepdim: x.dim() ones."""
    return out.reshape([1] * x.dim()) if keepdim else out


def _sum(x, axis, keepdim):
    if x.dtype == torch.bool:
        x = x.to(torch.int64)
    return torch.sum(x, dim=_all_dims(x, axis), keepdim=keepdim)


def _mean(x, axis, keepdim):
    return torch.mean(_float(x), dim=_all_dims(x, axis), keepdim=keepdim)


def _prod(x, axis, keepdim):
    if axis is None:
        return _keep_none(torch.prod(x), x, keepdim)
    for d in sorted((a % x.dim() for a in _all_dims(x, axis)),
                    reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _over(fn):
    """A reduction over `axis` (None: every axis) by `fn`."""
    def k(x, axis, keepdim):
        if axis is None:
            return _keep_none(fn(x), x, keepdim)
        return fn(x, dim=_all_dims(x, axis), keepdim=keepdim)
    return k


def _logsumexp(x, axis, keepdim):
    return torch.logsumexp(_float(x), dim=_all_dims(x, axis),
                           keepdim=keepdim)


def _count_nonzero(x, axis, keepdim):
    dims = _all_dims(x, axis)
    out = torch.count_nonzero(x, dim=dims)
    if keepdim:
        for d in sorted(a % x.dim() for a in dims):
            out = out.unsqueeze(d)
    return out


def _move_to_end(x, axis):
    """(x with the axes moved last and flattened into one, the sorted
    reduced axes)."""
    dims = sorted(a % x.dim() for a in _all_dims(x, axis)) \
        if x.dim() else []
    keep = [d for d in range(x.dim()) if d not in dims]
    x = x.permute(keep + dims) if x.dim() else x.reshape(1)
    return x.reshape(list(x.shape[:len(keep)]) + [-1]), dims


def _quantile(x, q, axis, keepdim, nan=False):
    """`jnp.quantile` / `nanquantile` (linear interpolation) over one or
    more axes; a list of q puts its axis first."""
    x = _float(_t(x))
    flat, dims = _move_to_end(x, axis)
    qs = torch.as_tensor(q, dtype=flat.dtype, device=flat.device) \
        if not isinstance(q, torch.Tensor) else q.to(flat.dtype)
    fn = torch.nanquantile if nan else torch.quantile
    out = fn(flat, qs, dim=-1)
    if keepdim:
        lead = 1 if qs.dim() else 0
        for d in (dims if x.dim() else []):
            out = out.unsqueeze(d + lead)
    return out


def _median(x, axis, keepdim):
    return _quantile(x, 0.5, axis, keepdim)


def _nanmean(x, axis, keepdim):
    return torch.nanmean(_float(x), dim=_all_dims(x, axis), keepdim=keepdim)


def _nansum(x, axis, keepdim):
    return torch.nansum(x, dim=_all_dims(x, axis), keepdim=keepdim)


_REDUCE = {
    "sum": _sum, "mean": _mean, "prod": _prod,
    "max": _over(torch.amax), "min": _over(torch.amin),
    "amax": _over(torch.amax), "amin": _over(torch.amin),
    "all": _over(torch.all), "any": _over(torch.any),
    "logsumexp": _logsumexp, "count_nonzero": _count_nonzero,
    "median": _median, "nanmean": _nanmean, "nansum": _nansum,
}


def _redop(name):
    fn = _REDUCE[name]

    def f(x, axis=None, keepdim=False, name_arg=None):
        return fn(_t(x), _axes(axis), keepdim)
    f.__name__ = f.__qualname__ = name
    return f


for _n in ("sum", "mean", "prod", "max", "min", "amax", "amin", "all", "any",
           "logsumexp", "count_nonzero", "median", "nanmean", "nansum"):
    globals()[_n] = _redop(_n)


def std(x, axis=None, unbiased=True, keepdim=False):
    x = _float(_t(x))
    return torch.std(x, dim=_all_dims(x, _axes(axis)),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False):
    x = _float(_t(x))
    return torch.var(x, dim=_all_dims(x, _axes(axis)),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _arg(fn, x, axis, keepdim, dtype):
    x = _t(x)
    if axis is None:
        out = fn(x.reshape(-1), dim=0)
    else:
        out = fn(x, dim=axis, keepdim=keepdim)
    return out.to(dtypes.convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def _cum(fn, x, axis, dtype):
    x = _t(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    if x.dtype == torch.bool:
        x = x.to(torch.int64)
    out = fn(x, dim=axis)
    return out.to(dtypes.convert_dtype(dtype)) if dtype else out


def cumsum(x, axis=None, dtype=None):
    return _cum(torch.cumsum, x, axis, dtype)


def cumprod(x, dim=None, dtype=None):
    return _cum(torch.cumprod, x, dim, dtype)


def logcumsumexp(x, axis=0):
    return torch.logcumsumexp(_float(_t(x)), dim=axis)


def _p_norm(x, p, axis, keepdim):
    dims = _all_dims(x, axis)
    if p == float("inf"):
        return torch.amax(x.abs(), dim=dims, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(x.abs(), dim=dims, keepdim=keepdim)
    return torch.sum(x.abs() ** p, dim=dims, keepdim=keepdim) ** (1.0 / p)


def norm(x, p=2.0, axis=None, keepdim=False):
    if p == "fro":
        p = 2.0
    return _p_norm(_float(_t(x)), builtins.float(p), _axes(axis), keepdim)


def quantile(x, q, axis=None, keepdim=False):
    return _quantile(x, q, _axes(axis), keepdim)


# ------------------------------------------------------------- manipulation
def reshape(x, shape):
    return _t(x).reshape(_shape(shape))


def transpose(x, perm):
    return _t(x).permute([_int(p) for p in perm])


def flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(_t(x), start_axis, stop_axis)


def squeeze(x, axis=None):
    x = _t(x)
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, _axes(axis))


def unsqueeze(x, axis):
    x = _t(x)
    axes = _axes(axis)
    axes = axes if isinstance(axes, tuple) else (axes,)
    for a in sorted(a if a >= 0 else a + x.dim() + 1 for a in axes):
        x = x.unsqueeze(a)
    return x


def concat(x, axis=0):
    return torch.cat([_t(v) for v in x], dim=_int(axis))


def stack(x, axis=0):
    return torch.stack([_t(v) for v in x], dim=_int(axis))


def split(x, num_or_sections, axis=0):
    x = _t(x)
    axis = _int(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, (builtins.int, np.integer)):
        n = builtins.int(num_or_sections)
        if total % n:
            raise ValueError(f"split: {total} is not divisible by {n}")
        return list(torch.split(x, total // n, dim=axis))
    sections = [_int(s) for s in num_or_sections]
    known = builtins.sum(s for s in sections if s != -1)
    sizes = [s if s != -1 else total - known for s in sections]
    return list(torch.split(x, sizes, dim=axis))


def chunk(x, chunks, axis=0):
    xt = _t(x)
    n = xt.shape[_int(axis)]
    base = -(-n // chunks)
    sections = [base] * (n // base) + ([n % base] if n % base else [])
    return split(xt, sections, axis)


def unbind(x, axis=0):
    return list(torch.unbind(_t(x), dim=axis))


def tile(x, repeat_times):
    return torch.tile(_t(x), tuple(_shape(repeat_times)))


def expand(x, shape):
    x = _t(x)
    shape = _shape(shape)
    lead = [1] * (len(shape) - x.dim()) + list(x.shape)
    return x.broadcast_to([s if s != -1 else xs
                           for s, xs in zip(shape, lead)])


def expand_as(x, y):
    return _t(x).broadcast_to(_t(y).shape)


def broadcast_to(x, shape):
    return _t(x).broadcast_to(_shape(shape))


def broadcast_tensors(inputs):
    return list(torch.broadcast_tensors(*[_t(i) for i in inputs]))


def roll(x, shifts, axis=None):
    return torch.roll(_t(x), shifts, dims=_axes(axis))


def flip(x, axis):
    axis = _axes(axis)
    return torch.flip(_t(x), axis if isinstance(axis, tuple) else (axis,))


def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(_t(x), k, tuple(axes))


def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(_t(x), repeats, dim=axis)


def _pad_index(n, lo, hi, mode, device):
    """Source index of each output position of one axis padded by (lo,
    hi) under jnp.pad's reflect / edge / wrap."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i.remainder(n)
    period = 2 * (n - 1)
    if period == 0:
        return torch.zeros_like(i)
    i = i.remainder(period)
    return torch.where(i < n, i, period - i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """Paddle's pad: a flat list of (before, after) pairs for every axis
    in order, or for the trailing axes last axis first."""
    x = _t(x)
    pad = _shape(pad)
    if len(pad) == 2 * x.dim():
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.dim())]
    else:
        widths = [(0, 0)] * (x.dim() - len(pad) // 2)
        tail = [(pad[i], pad[i + 1]) for i in range(0, len(pad), 2)]
        widths += tail[::-1]
    jmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]
    if jmode == "constant":
        flat = [w for lo_hi in reversed(widths) for w in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, jmode,
                                             x.device))
    return x


def _take(x, index, axis):
    index = _t(index, device=x.device)
    n = x.shape[axis]
    flat = index.reshape(-1).long()
    flat = torch.where(flat < 0, flat + n, flat)
    out = x.index_select(axis, flat)
    return out.reshape(list(x.shape[:axis]) + list(index.shape)
                       + list(x.shape[axis + 1:]))


def gather(x, index, axis=0):
    x = _t(x)
    return _take(x, index, _int(axis) % builtins.max(x.dim(), 1))


def gather_nd(x, index):
    x = _t(x)
    index = _t(index, device=x.device).long()
    return x[tuple(index.unbind(-1))]


def scatter(x, index, updates, overwrite=True):
    """Rows `index` of x set to `updates`, or (overwrite=False) the
    updates added to them without zeroing them first."""
    x = _t(x)
    index = _t(index, device=x.device).reshape(-1).long()
    updates = _t(updates, ref=x)
    if overwrite:
        return x.index_copy(0, index, updates.to(x.dtype))
    return x.index_add(0, index, updates.to(x.dtype))


def scatter_nd_add(x, index, updates):
    x = _t(x)
    index = _t(index, device=x.device).long()
    return x.index_put(tuple(index.unbind(-1)), _t(updates, ref=x),
                       accumulate=True)


def index_select(x, index, axis=0):
    x = _t(x)
    return _take(x, index, _int(axis) % builtins.max(x.dim(), 1))


def index_add(x, index, axis, value):
    x = _t(x)
    return x.index_add(axis, _t(index, device=x.device).long(),
                       _t(value, ref=x))


def index_fill(x, index, axis, value):
    x = _t(x)
    return x.index_fill(axis, _t(index, device=x.device).long(),
                        _num(value))


def take_along_axis(x, indices, axis):
    x = _t(x)
    return torch.take_along_dim(x, _t(indices, device=x.device).long(),
                                dim=axis)


def put_along_axis(x, indices, values, axis, reduce="assign"):
    x = _t(x)
    indices = _t(indices, device=x.device).long()
    values = _t(values, ref=x).to(x.dtype).broadcast_to(indices.shape)
    if reduce == "assign":
        return x.scatter(axis, indices, values)
    if reduce == "add":
        return x.scatter_add(axis, indices, values)
    if reduce in ("multiply", "mul"):
        return x.scatter_reduce(axis, indices, values, "prod")
    raise ValueError(reduce)


def masked_fill(x, mask, value):
    x = _t(x)
    return torch.where(_t(mask, device=x.device).bool(), _t(value, ref=x), x)


def masked_select(x, mask):
    x = _t(x)
    return torch.masked_select(x, _t(mask, device=x.device).bool())


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    condition = _t(condition)
    dev = condition.device
    return torch.where(condition.bool(), _t(x, device=dev),
                       _t(y, device=dev))


def nonzero(x, as_tuple=False):
    x = _t(x)
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    """`np.unique` on the device: the sorted unique values, and as asked
    the index of each one's first occurrence, the inverse and the
    counts."""
    x = _t(x)
    if axis is None:
        x = x.reshape(-1)
    dim = 0 if axis is None else axis
    uniq, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    out = [uniq]
    if return_index:
        n = x.shape[dim]
        first = torch.full((uniq.shape[dim],), n, dtype=torch.int64,
                           device=x.device)
        out.append(first.scatter_reduce(
            0, inv, torch.arange(n, device=x.device), "amin"))
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def sort(x, axis=-1, descending=False):
    return torch.sort(_t(x), dim=axis, descending=descending,
                      stable=True).values


def argsort(x, axis=-1, descending=False):
    return torch.sort(_t(x), dim=axis, descending=descending,
                      stable=True).indices


def topk(x, k, axis=-1, largest=True, sorted=True):
    """(values, indices) of the k largest (smallest) along `axis`; ties
    to the lower index first, as `lax.top_k`."""
    x = _t(x)
    v, i = torch.sort(x, dim=axis, descending=largest, stable=True)
    k = _int(k)
    return v.narrow(axis, 0, k), i.narrow(axis, 0, k)


def searchsorted(sorted_sequence, values, right=False):
    s = _t(sorted_sequence)
    return torch.searchsorted(s, _t(values, ref=s), right=right)


def bincount(x, weights=None, minlength=0):
    x = _t(x)
    return torch.bincount(x, weights=None if weights is None
                          else _t(weights, device=x.device),
                          minlength=minlength)


def one_hot(x, num_classes):
    x = _t(x)
    n = _int(num_classes)
    return (x.unsqueeze(-1) == torch.arange(n, device=x.device)).to(
        dtypes.get_default_dtype())


def histogram(x, bins=100, min=0, max=0):
    """np.histogram's counts on the device; min == max == 0 takes the
    data's range."""
    x = _float(_t(x)).reshape(-1)
    if min == 0 and max == 0:
        min, max = x.min(), x.max()
    return _histdd(x[:, None], [builtins.int(bins)],
                   [(min, max)])[0].to(torch.int64)


def _histdd(x, bins, ranges, weights=None, density=False):
    """np.histogramdd on the device: edges from each range (float64),
    a value on the last edge in the last bin, the rest outside dropped."""
    n, d = x.shape
    xd = x.double()
    edges, idx, inside = [], [], torch.ones(n, dtype=torch.bool,
                                            device=x.device)
    for k in range(d):
        lo, hi = (_num(v) for v in ranges[k])
        lo, hi = builtins.float(lo), builtins.float(hi)
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        e = torch.linspace(lo, hi, bins[k] + 1, dtype=torch.float64,
                           device=x.device)
        col = xd[:, k].contiguous()
        j = torch.searchsorted(e, col, right=True) - 1
        j = torch.where(col == e[-1], j - 1, j)
        inside &= (col >= e[0]) & (col <= e[-1])
        edges.append(e)
        idx.append(j.clamp(0, bins[k] - 1))
    flat = torch.zeros(n, dtype=torch.int64, device=x.device)
    for k in range(d):
        flat = flat * bins[k] + idx[k]
    w = inside.to(torch.float64) if weights is None else \
        inside.to(torch.float64) * weights.reshape(-1).double()
    total = 1
    for b in bins:
        total *= b
    h = torch.zeros(total, dtype=torch.float64, device=x.device)
    h = h.index_add(0, flat, w).reshape(bins)
    if density:
        vol = torch.ones((), dtype=torch.float64, device=x.device)
        for k, e in enumerate(edges):
            shape = [1] * d
            shape[k] = -1
            vol = vol * (e[1:] - e[:-1]).reshape(shape)
        h = h / h.sum() / vol
    return h, edges


# -------------------------------------------------------------- comparisons
def _pair(x, y):
    x, y = _t(x), _t(y)
    t = torch.promote_types(x.dtype, y.dtype)
    return x.to(t), y.to(x.device, t)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = _pair(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = _pair(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def equal_all(x, y):
    x, y = _t(x), _t(y)
    if x.shape != y.shape:
        return torch.tensor(False, device=x.device)
    return (x == y.to(x.device)).all()


# ------------------------------------------------------------------ numeric
def numel(x):
    x = _t(x)
    return torch.tensor(x.numel(), device=x.device)


def shape(x):
    x = _t(x)
    return torch.tensor(list(x.shape), dtype=torch.int64, device=x.device)


def rank(x):
    x = _t(x)
    return torch.tensor(x.dim(), device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def increment(x, value=1.0):
    """x += value in place, outside the graph (a counter's update)."""
    with torch.no_grad():
        x.add_(value)
    return x


def kthvalue(x, k, axis=-1, keepdim=False):
    x = _t(x)
    v, i = torch.sort(x, dim=axis, stable=True)
    sel, seli = v.select(axis, k - 1), i.select(axis, k - 1)
    if keepdim:
        sel, seli = sel.unsqueeze(axis), seli.unsqueeze(axis)
    return sel, seli


def mode(x, axis=-1, keepdim=False):
    """The most frequent value along `axis` and the index of its last
    occurrence; ties to the smallest value (pairwise counts, O(n^2)
    along the axis, as in the reference)."""
    x = _t(x)
    arr = x.movedim(axis, -1)
    counts = (arr[..., :, None] == arr[..., None, :]).sum(-1)
    order = torch.sort(arr, dim=-1, stable=True).indices
    arr_sorted = arr.gather(-1, order)
    counts_sorted = counts.gather(-1, order)
    pos = torch.argmax(counts_sorted, dim=-1)
    values = arr_sorted.gather(-1, pos[..., None])[..., 0]
    n = arr.shape[-1]
    iota = torch.arange(n, device=x.device)
    idx = torch.where(arr == values[..., None], iota, -1).amax(-1)
    if keepdim:
        values = values[..., None].movedim(-1, axis)
        idx = idx[..., None].movedim(-1, axis)
    return values, idx


def diff(x, n=1, axis=-1, prepend=None, append=None):
    x = _t(x)
    return torch.diff(
        x, n=n, dim=axis,
        prepend=None if prepend is None else _t(prepend, ref=x),
        append=None if append is None else _t(append, ref=x))


def as_strided(x, shape, stride, offset=0):
    """The reference's as_strided: a gather over the flattened input at
    offset + sum_k stride_k * i_k (not a view of torch's storage)."""
    x = _t(x)
    flat = x.reshape(-1)
    shape = _shape(shape)
    idx = torch.full([1] * len(shape), _int(offset), dtype=torch.int64,
                     device=x.device)
    for k, (s, st) in enumerate(zip(shape, stride)):
        view = [1] * len(shape)
        view[k] = s
        idx = idx + (torch.arange(s, device=x.device)
                     * _int(st)).reshape(view)
    return flat.take(idx)


def matrix_power(x, n):
    return torch.linalg.matrix_power(_t(x), _int(n))


def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_t(x), offset, axis1, axis2).sum(-1)


# ---------------------------------------------------------- more functions
def trapezoid(y, x=None, dx=None, axis=-1):
    y = _t(y)
    if x is not None:
        return torch.trapezoid(y, _t(x, ref=y), dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def nanquantile(x, q, axis=None, keepdim=False):
    return _quantile(x, q, _axes(axis), keepdim, nan=True)


def bucketize(x, sorted_sequence, out_int32=False, right=False):
    x = _t(x)
    return torch.bucketize(x, _t(sorted_sequence, ref=x),
                           out_int32=out_int32, right=right)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    x = _t(x)
    if axis is None:
        x = x.reshape(-1)
    uniq, inv, counts = torch.unique_consecutive(
        x, return_inverse=True, return_counts=True, dim=axis)
    out = [uniq]
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def take(x, index, mode="raise"):
    """Elements of the flattened x at `index`: "raise" checks the bounds
    on the host (IndexError) and then clamps as "clip", "wrap" wraps."""
    x = _t(x)
    idx = _t(index, device=x.device).long()
    n = x.numel()
    if mode == "raise" and idx.numel():
        lo, hi = idx.min().item(), idx.max().item()
        if lo < -n or hi >= n:
            raise IndexError(
                f"take index out of range for tensor of {n} elements")
    if mode == "wrap":
        idx = idx.remainder(n)
    elif mode in ("raise", "clip"):
        idx = idx.clamp(0, n - 1)
    else:
        raise ValueError(f"take: unknown mode {mode!r}")
    return x.reshape(-1).take(idx)


def renorm(x, p, axis, max_norm):
    x = _t(x)
    axis = axis % x.dim()
    dims = tuple(d for d in range(x.dim()) if d != axis)
    norms = torch.sum(x.abs() ** builtins.float(p), dim=dims,
                      keepdim=True) ** (1.0 / builtins.float(p))
    factor = (max_norm / norms.clamp(min=1e-7)).clamp(max=1.0)
    return x * factor


def gcd(x, y):
    x = _t(x)
    return torch.gcd(x, _t(y, ref=x))


def lcm(x, y):
    x = _t(x)
    return torch.lcm(x, _t(y, ref=x))


def frexp(x):
    m, e = torch.frexp(_float(_t(x)))
    return m, e


def ldexp(x, y):
    x = _t(x)
    return torch.ldexp(_float(x), _t(y, ref=x).to(torch.int32))


def vander(x, n=None, increasing=False):
    return torch.vander(_t(x), N=n, increasing=increasing)


def msort(x):
    return torch.sort(_t(x), dim=0, stable=True).values


def view_as(x, other):
    return _t(x).reshape(_t(other).shape)


def unflatten(x, axis, shape):
    x = _t(x)
    axis = axis % x.dim()
    return x.reshape(list(x.shape[:axis]) + _shape(shape)
                     + list(x.shape[axis + 1:]))


def moveaxis(x, source, destination):
    return torch.movedim(_t(x), source, destination)


def tensordot(x, y, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return torch.tensordot(_t(x), _t(y), dims=axes)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None):
    """(histogram [bins...], [edges of each axis]) of the rows of x
    [n, d], on the device (np.histogramdd's rules)."""
    x = _float(_t(x))
    d = x.shape[-1]
    x = x.reshape(-1, d)
    bins = [builtins.int(bins)] * d if isinstance(
        bins, (builtins.int, np.integer)) else [_int(b) for b in bins]
    if ranges is None:
        ranges = list(zip(x.min(0).values.tolist(),
                          x.max(0).values.tolist()))
    else:
        r = list(ranges)
        ranges = r if isinstance(r[0], (list, tuple)) else \
            [(r[2 * k], r[2 * k + 1]) for k in range(d)]
    h, edges = _histdd(x, bins, ranges,
                       None if weights is None
                       else _t(weights, device=x.device), density)
    dt = dtypes.get_default_dtype()
    return h.to(dt), [e.to(dt) for e in edges]


def signbit(x):
    return torch.signbit(_t(x))


def isneginf(x):
    return torch.isneginf(_t(x))


def isposinf(x):
    return torch.isposinf(_t(x))


def polar(abs, angle):
    return torch.polar(_float(_t(abs)).float(), _float(_t(angle)).float())


def angle(x):
    return torch.angle(_t(x))


def deg2rad(x):
    return torch.deg2rad(_float(_t(x)))


def rad2deg(x):
    return torch.rad2deg(_float(_t(x)))


def cat(x, axis=0):
    return concat(x, axis=axis)


def t(x):
    x = _t(x)
    if x.dim() > 2:
        raise ValueError("paddle.t expects a 0/1/2-D tensor; use transpose")
    return x if x.dim() < 2 else x.permute(1, 0)


def tolist(x):
    return _t(x).tolist()


def add_n(inputs):
    if isinstance(inputs, torch.Tensor):
        return inputs
    out = inputs[0]
    for v in inputs[1:]:
        out = out + v
    return out


def as_complex(x):
    x = _t(x).float()
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x):
    x = _t(x)
    return torch.stack([x.real, x.imag], dim=-1).float()


def block_diag(inputs):
    return torch.block_diag(*[_t(v) for v in inputs])


def broadcast_shape(x_shape, y_shape):
    # numpy's rule: torch.broadcast_shapes imports sympy on first use
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def column_stack(x):
    return torch.column_stack([_t(v) for v in x])


def hstack(x):
    return torch.hstack([_t(v) for v in x])


def vstack(x):
    return torch.vstack([_t(v) for v in x])


def dstack(x):
    return torch.dstack([_t(v) for v in x])


def tensor_split(x, num_or_indices, axis=0):
    x = _t(x)
    sections = builtins.int(num_or_indices) if isinstance(
        num_or_indices, (builtins.int, np.integer)) \
        else [_int(i) for i in num_or_indices]
    return list(torch.tensor_split(x, sections, dim=axis))


def hsplit(x, num_or_indices):
    return tensor_split(x, num_or_indices, axis=1 if _t(x).dim() > 1 else 0)


def vsplit(x, num_or_indices):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices):
    return tensor_split(x, num_or_indices, axis=2)


def _cumextreme(x, axis, fn):
    """(running extremum, index of the latest element equal to it)."""
    x = _t(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals = fn(x, dim=axis).values
    shape = [1] * x.dim()
    shape[axis] = -1
    iota = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    idx = torch.cummax(torch.where(x == vals, iota, -1), dim=axis).values
    return vals, idx


def cummax(x, axis=None, dtype="int64"):
    v, i = _cumextreme(x, axis, torch.cummax)
    return v, i.to(dtypes.convert_dtype(dtype))


def cummin(x, axis=None, dtype="int64"):
    v, i = _cumextreme(x, axis, torch.cummin)
    return v, i.to(dtypes.convert_dtype(dtype))


def diagflat(x, offset=0):
    return torch.diagflat(_t(x), offset)


def dist(x, y, p=2):
    return norm(_t(x) - _t(y), p=p)


def floor_mod(x, y):
    return mod(x, y)  # noqa: F821 — bound by the binary loop


def index_put(x, indices, value, accumulate=False):
    x = _t(x)
    idx = tuple(i if i.dtype == torch.bool else i.long()
                for i in (_t(i, device=x.device) for i in indices))
    return x.index_put(idx, _t(value, ref=x), accumulate=accumulate)


def index_sample(x, index):
    x = _t(x)
    return torch.take_along_dim(x, _t(index, device=x.device).long(),
                                dim=1)


def inner(x, y):
    return torch.inner(_t(x), _t(y))


def is_complex(x):
    return _t(x).is_complex()


def is_floating_point(x):
    return _t(x).is_floating_point()


def is_integer(x):
    x = _t(x)
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def is_empty(x):
    x = _t(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def kron(x, y):
    return torch.kron(_t(x), _t(y))


def logit(x, eps=None):
    x = _t(x)
    if eps is not None:
        x = x.clamp(eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def multiplex(inputs, index):
    stacked = stack(inputs, axis=0)             # (K, B, ...)
    idx = _t(index, device=stacked.device).reshape(-1).long()
    rows = torch.arange(idx.shape[0], device=stacked.device)
    return stacked[idx, rows]


def mv(x, vec):
    return matmul(x, vec)


def nanmedian(x, axis=None, keepdim=False):
    return _quantile(x, 0.5, _axes(axis), keepdim, nan=True)


def polygamma(x, n):
    return torch.special.polygamma(_int(n), _float(_t(x)))


def randint_like(x, low=0, high=None, dtype=None):
    x = _t(x)
    return randint(low, high, list(x.shape), dtype=dtype or x.dtype,
                   device=x.device)


def scatter_nd(index, updates, shape):
    updates = _t(updates)
    index = _t(index, device=updates.device).long()
    out = torch.zeros(_shape(shape), dtype=updates.dtype,
                      device=updates.device)
    return out.index_put(tuple(index.unbind(-1)), updates, accumulate=True)


def sgn(x):
    return torch.sgn(_t(x))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    x = _t(input)
    size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(x, size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, x.remainder(size),
                       torch.full_like(x, ignore_value))


def slice(input, axes, starts, ends):
    x = _t(input)
    idx = [builtins.slice(None)] * x.dim()
    for ax, s, e in zip(axes, starts, ends):
        idx[ax] = builtins.slice(_int(s), _int(e))
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides):
    """Python slices per axis; a negative stride gathers its rows (torch
    slicing takes positive steps only)."""
    x = _t(x)
    for ax, s, e, st in zip(axes, starts, ends, strides):
        sl = builtins.slice(_int(s), _int(e), _int(st))
        if sl.step > 0:
            idx = [builtins.slice(None)] * x.dim()
            idx[ax] = sl
            x = x[tuple(idx)]
        else:
            rows = range(*sl.indices(x.shape[ax]))
            x = x.index_select(ax, torch.tensor(list(rows), dtype=torch.long,
                                                device=x.device))
    return x


def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * _t(x))


def tril_indices(row, col=None, offset=0, dtype="int64", device=None):
    col = row if col is None else col
    return torch.tril_indices(row, col, offset, device=resolve_device(
        device)).to(dtypes.convert_dtype(dtype))


def triu_indices(row, col=None, offset=0, dtype="int64", device=None):
    col = row if col is None else col
    return torch.triu_indices(row, col, offset, device=resolve_device(
        device)).to(dtypes.convert_dtype(dtype))


def unfold(x, axis, size, step):
    return _t(x).unfold(axis, size, step)


def unstack(x, axis=0, num=None):
    return unbind(x, axis=axis)


__all__ = sorted(
    n for n, v in list(globals().items())
    if not n.startswith("_") and callable(v)
    and getattr(v, "__module__", None) == __name__) + [
    "finfo", "iinfo", "seed", "to_tensor"]
del _n
