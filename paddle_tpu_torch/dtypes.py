"""The dtype surface (counterpart: `paddle_tpu/dtypes.py`).

The names are torch dtypes (`paddle_tpu_torch.float32 is torch.float32`),
and every function here also takes Paddle's dtype strings ("float32",
"bf16", "paddle.int64", ...) and numpy dtypes.

Intended divergence: the JAX package turns a 64-bit request into its
32-bit counterpart unless JAX's x64 mode is on (`paddle_tpu/dtypes.py:
111-127`), since XLA on a TPU has no fast 64-bit path.  The port keeps
torch's real 64-bit types: `convert_dtype("int64")` is `torch.int64`.
`enable_x64` / `x64_enabled` configure JAX itself and have no
counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

float64 = torch.float64
float32 = torch.float32
float16 = torch.float16
bfloat16 = torch.bfloat16
int64 = torch.int64
int32 = torch.int32
int16 = torch.int16
int8 = torch.int8
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR_ALIASES = {
    "float64": float64, "double": float64,
    "float32": float32, "float": float32,
    "float16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "int64": int64, "long": int64,
    "int32": int32, "int": int32,
    "int16": int16, "short": int16,
    "int8": int8, "uint8": uint8,
    "bool": bool_,
    "complex64": complex64, "complex128": complex128,
}
_NUMPY = {np.dtype(k): v for k, v in (
    ("float64", float64), ("float32", float32), ("float16", float16),
    ("int64", int64), ("int32", int32), ("int16", int16), ("int8", int8),
    ("uint8", uint8), ("bool", bool_), ("complex64", complex64),
    ("complex128", complex128))}

_DEFAULT_DTYPE = [float32]


def convert_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or a Paddle dtype
    name; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower().replace("paddle.", "").replace("torch.", "")
        if key in _STR_ALIASES:
            return _STR_ALIASES[key]
        dtype = key
    try:
        return _NUMPY[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise ValueError(f"unknown dtype {dtype!r}") from None


def set_default_dtype(dtype):
    d = convert_dtype(dtype)
    if d not in (float64, float32, float16, bfloat16):
        raise TypeError(f"default dtype must be floating, got {d}")
    _DEFAULT_DTYPE[0] = d


def get_default_dtype():
    return _DEFAULT_DTYPE[0]


def is_floating_point_dtype(dtype):
    return convert_dtype(dtype).is_floating_point


def is_integer_dtype(dtype):
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex)


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))


def promote_types(a, b):
    return torch.promote_types(convert_dtype(a), convert_dtype(b))


def dtype_name(dtype) -> str:
    return str(convert_dtype(dtype)).replace("torch.", "")
