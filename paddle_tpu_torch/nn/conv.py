"""Convolution layers (counterpart: `paddle_tpu/nn/conv.py`).

Weights keep the JAX package's layout, which is torch's: OIHW... [out,
in / groups, k...] for the convolutions and [in, out / groups, k...]
for the transpose ones, so a state dict carries across unchanged.  The
weight is drawn Kaiming-uniform (limit sqrt(6 / fan_in)), the bias
zero, unless `weight_attr` / `bias_attr` name an initializer (a
`ParamAttr` also stamps its name, `trainable` and learning rate);
`bias_attr=False` drops the bias.  With `data_format="NHWC"` `Conv2D`
takes and returns [b, H, W, c] tensors and keeps its weight in
channels-last memory, so cuDNN runs the NHWC kernels without converting
the weight at each call.  XLA's conv in the JAX package becomes torch's:
no Pallas kernel exists there.
"""
from __future__ import annotations

import torch

from . import functional as PF
from . import initializer as I
from .common import _attr_init, _kw
from .layer import Layer


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride,
                 padding, dilation, groups, weight_attr, bias_attr,
                 data_format, transpose=False, device=None, dtype=None,
                 generator=None):
        super().__init__(**_kw(device, dtype, generator))
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _ntuple(kernel_size, nd)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.data_format = data_format
        shape = [in_channels, out_channels // groups] if transpose else \
            [out_channels, in_channels // groups]
        self.weight = self.create_parameter(
            shape + list(self.kernel_size), attr=weight_attr,
            default_initializer=_attr_init(weight_attr)
            or I.KaimingUniform())
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=_attr_init(bias_attr) or I.Constant(0.0))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Kaiming-uniform weight, zero bias, drawn from `generator`."""
        I.KaimingUniform()(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"data_format={self.data_format}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, device=device, dtype=dtype,
                         generator=generator)

    def forward(self, x):
        return PF.conv1d(x, self.weight, self.bias, self.stride,
                         self.padding, self.dilation, self.groups)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None, generator=None):
        if padding_mode != "zeros":
            raise NotImplementedError("Conv2D: only zero padding is ported")
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, not "
                             f"{data_format!r}")
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, device=device, dtype=dtype,
                         generator=generator)
        if data_format == "NHWC":
            self.weight.data = self.weight.data.contiguous(
                memory_format=torch.channels_last)

    def forward(self, x):
        return PF.conv2d(x, self.weight, self.bias, self.stride,
                         self.padding, self.dilation, self.groups,
                         self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, device=device, dtype=dtype,
                         generator=generator)

    def forward(self, x):
        return PF.conv3d(x, self.weight, self.bias, self.stride,
                         self.padding, self.dilation, self.groups)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, transpose=True, device=device,
                         dtype=dtype, generator=generator)
        self.output_padding = output_padding

    def forward(self, x):
        return PF.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                   self.padding, self.output_padding,
                                   self.dilation, self.groups)
