"""Discrete Fourier transforms (counterpart: `paddle_tpu/fft.py`;
reference: python/paddle/fft.py), over `torch.fft`.

The norm conventions are the reference's: "backward" (the default),
"ortho", "forward".  `fftfreq` / `rfftfreq` default to float32 and
resolve their device as `to_tensor` does (the card unless `device=` or
`set_device("cpu")` names the CPU); `fftshift` / `ifftshift` with
`axes=None` shift every axis.  Every transform is differentiable
(autograd through torch's).
"""
from __future__ import annotations

import torch

from . import dtypes
from .device import resolve_device
from .tensor_api import _t

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft", "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]


def _dims(axes):
    return axes if axes is None or isinstance(axes, int) else tuple(axes)


def fft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.fft(_t(x), n=n, dim=axis, norm=norm)


def ifft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ifft(_t(x), n=n, dim=axis, norm=norm)


def rfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.rfft(_t(x), n=n, dim=axis, norm=norm)


def irfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.irfft(_t(x), n=n, dim=axis, norm=norm)


def hfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.hfft(_t(x), n=n, dim=axis, norm=norm)


def ihfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ihfft(_t(x), n=n, dim=axis, norm=norm)


def fft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.fft2(_t(x), s=s, dim=_dims(axes), norm=norm)


def ifft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.ifft2(_t(x), s=s, dim=_dims(axes), norm=norm)


def rfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.rfft2(_t(x), s=s, dim=_dims(axes), norm=norm)


def irfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.irfft2(_t(x), s=s, dim=_dims(axes), norm=norm)


def fftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.fftn(_t(x), s=s, dim=_dims(axes), norm=norm)


def ifftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.ifftn(_t(x), s=s, dim=_dims(axes), norm=norm)


def rfftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.rfftn(_t(x), s=s, dim=_dims(axes), norm=norm)


def irfftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.irfftn(_t(x), s=s, dim=_dims(axes), norm=norm)


def fftfreq(n, d=1.0, dtype=None, device=None):
    return torch.fft.fftfreq(int(n), d=d,
                             dtype=dtypes.convert_dtype(dtype)
                             or torch.float32,
                             device=resolve_device(device))


def rfftfreq(n, d=1.0, dtype=None, device=None):
    return torch.fft.rfftfreq(int(n), d=d,
                              dtype=dtypes.convert_dtype(dtype)
                              or torch.float32,
                              device=resolve_device(device))


def fftshift(x, axes=None):
    return torch.fft.fftshift(_t(x), dim=_dims(axes))


def ifftshift(x, axes=None):
    return torch.fft.ifftshift(_t(x), dim=_dims(axes))
