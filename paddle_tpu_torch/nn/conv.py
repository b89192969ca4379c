"""Conv2D (counterpart: `paddle_tpu/nn/conv.py:14-65`).

The weight is OIHW [out, in / groups, kh, kw] in both data formats, so a
state dict carries across formats and from the JAX package unchanged.
With `data_format="NHWC"` the layer takes and returns [b, H, W, c]
tensors and keeps its weight in channels-last memory, so cuDNN runs the
NHWC kernels without converting the weight at each call.  XLA's conv in
the JAX package becomes `torch.nn.functional.conv2d`: no Pallas kernel
exists there.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import functional as PF


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class Conv2D(nn.Module):
    """The weight is drawn Kaiming-uniform (limit sqrt(6 / fan_in), the
    JAX package's default) from `generator` (None: the device's default
    generator); the bias starts at zero.  `bias_attr=False` drops the
    bias; other parameter attributes are not ported."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None, generator=None):
        super().__init__()
        if padding_mode != "zeros" or weight_attr is not None or \
                bias_attr not in (None, False):
            raise NotImplementedError(
                "Conv2D: only zero padding and bias_attr=False are ported")
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, not "
                             f"{data_format!r}")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _ntuple(kernel_size, 2)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.data_format = data_format
        kw = dict(device=device, dtype=dtype)
        fmt = torch.channels_last if data_format == "NHWC" else \
            torch.contiguous_format
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *self.kernel_size,
            **kw).contiguous(memory_format=fmt))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(out_channels, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        fan_in = self.weight[0].numel()
        limit = math.sqrt(6.0 / fan_in)
        self.weight.uniform_(-limit, limit, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return PF.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                         self.dilation, self.groups, self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"data_format={self.data_format}")
