"""Pooling layers (counterpart: `paddle_tpu/nn/pooling.py:8-48`), over the
functional versions in `functional`, NCHW or NHWC."""
from __future__ import annotations

from torch import nn

from . import functional as PF


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW"):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.return_mask = return_mask
        self.data_format = data_format

    def forward(self, x):
        return PF.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                             self.ceil_mode, return_mask=self.return_mask,
                             data_format=self.data_format)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, data_format="NCHW"):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.exclusive = exclusive
        self.data_format = data_format

    def forward(self, x):
        return PF.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                             self.ceil_mode, self.exclusive,
                             data_format=self.data_format)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return PF.adaptive_avg_pool2d(x, self.output_size,
                                      data_format=self.data_format)
