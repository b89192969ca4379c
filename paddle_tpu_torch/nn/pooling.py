"""Pooling layers (counterpart: `paddle_tpu/nn/pooling.py`), over the
functional versions in `functional`; the 2-D ones NCHW or NHWC."""
from __future__ import annotations

from . import functional as PF
from .layer import Layer


class MaxPool2D(Layer):
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


class AvgPool2D(Layer):
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


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return PF.adaptive_avg_pool2d(x, self.output_size,
                                      data_format=self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return PF.adaptive_max_pool2d(x, self.output_size)


class MaxPool1D(Layer):
    """Over the last axis of [N, C, L]; `ceil_mode` is taken and unused,
    as in the JAX package."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding = padding

    def forward(self, x):
        return PF.max_pool1d(x, self.kernel_size, self.stride, self.padding)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding = padding
        self.exclusive = exclusive

    def forward(self, x):
        return PF.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                             exclusive=self.exclusive)


class MaxUnpool2D(Layer):
    """The inverse of MaxPool2D given its mask (`return_mask=True`)."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_size = output_size

    def forward(self, x, indices):
        return PF.max_unpool2d(x, indices, self.kernel_size, self.stride,
                               self.padding, self.output_size)
