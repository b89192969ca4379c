"""The top-level functions of the port that are not modules of their own
(counterparts: `paddle_tpu/__init__.py:79-143` and
`paddle_tpu/tensor_api.py:32`): `to_tensor`, `create_parameter`,
`flops`, `summary` and `is_grad_enabled`.

`to_tensor` and `create_parameter` make their tensors on the card unless
`place` / `device` (or an earlier `set_device("cpu")`) names the CPU,
and raise RuntimeError without a card, as every entry point of the port
does.  `to_tensor` follows the reference's dtypes: a float64 array or
Python floats become the default dtype (float32), other dtypes stay
(an int64 stays int64: the reference's 64-to-32-bit policy is JAX's,
see `dtypes`), and `stop_gradient=False` is `requires_grad=True`.

`flops` counts the forward's floating-point operations with
`profiler.program_stats` (`torch.utils.flop_counter.FlopCounterMode`,
as the reference's `flops` asks its `program_stats`): matrix products and
convolutions, 2 a multiply-add.  The reference asks XLA's cost analysis,
which also counts elementwise operations (activations, norms, adds) and
leaves a convolution's padded taps out, so the two differ by what those
come to (`tests/test_torch_device_api.py` holds the gap).
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtypes as _dtypes
from .device import resolve_device


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    device = resolve_device(place)
    dt = _dtypes.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device=device, dtype=dt, copy=True)
    else:
        arr = np.asarray(data)
        if dt is None and arr.dtype == np.float64:
            dt = _dtypes.get_default_dtype()
        t = torch.tensor(arr, dtype=dt, device=device)
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def create_parameter(shape, dtype=None, default_initializer=None,
                     is_bias=False, device=None):
    """A zero Parameter of `shape` (the default dtype unless `dtype`),
    filled by `default_initializer` when one is given (its draws from
    the device's default generator)."""
    p = torch.nn.Parameter(torch.zeros(
        [int(s) for s in shape],
        dtype=_dtypes.convert_dtype(dtype) or _dtypes.get_default_dtype(),
        device=resolve_device(device)))
    if default_initializer is not None:
        default_initializer(p)
    return p


def is_grad_enabled():
    return torch.is_grad_enabled()


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The forward's flops on a float32 zero input of `input_size` (as
    given, the batch included), on the network's device, in eval mode
    (each sublayer's mode is restored after)."""
    from .profiler import program_stats
    modes = [(m, m.training) for m in net.modules()]
    param = next(iter(net.parameters()), None)
    device = param.device if param is not None else resolve_device(None)
    net.eval()
    try:
        x = torch.zeros(tuple(input_size), dtype=torch.float32,
                        device=device)
        with torch.no_grad():
            total = program_stats(net, x)["flops"]
    finally:
        for m, mode in modes:
            m.training = mode
    if print_detail:
        n_params = sum(p.numel() for p in net.parameters())
        print(f"Total flops: {total:,}  params: {n_params:,}")
    return total


def summary(layer, input_size=None):
    n_params = sum(p.numel() for p in layer.parameters())
    print(f"{type(layer).__name__}: {n_params:,} parameters")
    return {"total_params": n_params}
