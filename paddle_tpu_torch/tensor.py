"""`Tensor` and `parameter` (counterpart: `paddle_tpu/tensor.py`).

The port's tensor is `torch.Tensor` itself: no subclass, and nothing is
patched onto torch's class.  The JAX package's Tensor wraps a jax array
and carries Paddle's methods; the port's code calls torch's.  The
Paddle-only spellings that the reference's `tests/test_tensor.py` uses
and torch lacks (ROADMAP.md, "Intended divergences"): `astype(dtype)` is
`.to(dtype)`; `transpose(perm)` is `.permute(perm)` (torch's `transpose`
swaps two dims); `shape` is a `torch.Size` (a tuple, unequal to a list);
`squeeze(None)` is `.squeeze()`; `stop_gradient` is `not
requires_grad`.
"""
from __future__ import annotations

import torch

from . import dtypes as _dtypes
from .device import resolve_device

Tensor = torch.Tensor

__all__ = ["Tensor", "parameter"]


def parameter(data, dtype=None, name=None):
    """A trainable parameter (`torch.nn.Parameter`) holding a copy of
    `data`, on the card unless the CPU is the current device.  `name` is
    taken and not kept: a torch tensor's `name` is read-only (named
    tensors); a module names its parameters."""
    t = data.detach() if isinstance(data, torch.Tensor) else \
        torch.as_tensor(data)
    dt = _dtypes.convert_dtype(dtype)
    if dt is None and t.dtype == torch.float64:
        dt = _dtypes.get_default_dtype()
    p = torch.nn.Parameter(t.to(device=resolve_device(None), dtype=dt,
                                copy=True))
    return p
