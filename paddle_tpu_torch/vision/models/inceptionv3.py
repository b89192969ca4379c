"""InceptionV3 (counterpart: `paddle_tpu/vision/models/inceptionv3.py`),
for [b, 3, 299, 299] images."""
from __future__ import annotations

import torch

from ...nn import (AdaptiveAvgPool2D, AvgPool2D, Dropout, Layer, MaxPool2D,
                   ReLU, Sequential)
from ._builder import Builder, no_pretrained

__all__ = ["InceptionV3", "inception_v3"]


def _cat(xs):
    return torch.cat(xs, dim=1)


class _ConvBN(Sequential):
    def __init__(self, inp, out, kernel, b, **kw):
        super().__init__(b.conv(inp, out, kernel, bias_attr=False, **kw),
                         b.bn(out), ReLU())


class _InceptionA(Layer):
    def __init__(self, inp, pool_c, b):
        super().__init__()
        self.b1 = _ConvBN(inp, 64, 1, b)
        self.b5 = Sequential(_ConvBN(inp, 48, 1, b),
                             _ConvBN(48, 64, 5, b, padding=2))
        self.b3 = Sequential(_ConvBN(inp, 64, 1, b),
                             _ConvBN(64, 96, 3, b, padding=1),
                             _ConvBN(96, 96, 3, b, padding=1))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             _ConvBN(inp, pool_c, 1, b))

    def forward(self, x):
        return _cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)])


class _ReductionA(Layer):
    def __init__(self, inp, b):
        super().__init__()
        self.b3 = _ConvBN(inp, 384, 3, b, stride=2)
        self.b3d = Sequential(_ConvBN(inp, 64, 1, b),
                              _ConvBN(64, 96, 3, b, padding=1),
                              _ConvBN(96, 96, 3, b, stride=2))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return _cat([self.b3(x), self.b3d(x), self.pool(x)])


class _InceptionB(Layer):
    def __init__(self, inp, c7, b):
        super().__init__()
        self.b1 = _ConvBN(inp, 192, 1, b)
        self.b7 = Sequential(
            _ConvBN(inp, c7, 1, b),
            _ConvBN(c7, c7, (1, 7), b, padding=(0, 3)),
            _ConvBN(c7, 192, (7, 1), b, padding=(3, 0)))
        self.b7d = Sequential(
            _ConvBN(inp, c7, 1, b),
            _ConvBN(c7, c7, (7, 1), b, padding=(3, 0)),
            _ConvBN(c7, c7, (1, 7), b, padding=(0, 3)),
            _ConvBN(c7, c7, (7, 1), b, padding=(3, 0)),
            _ConvBN(c7, 192, (1, 7), b, padding=(0, 3)))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             _ConvBN(inp, 192, 1, b))

    def forward(self, x):
        return _cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)])


class _ReductionB(Layer):
    def __init__(self, inp, b):
        super().__init__()
        self.b3 = Sequential(_ConvBN(inp, 192, 1, b),
                             _ConvBN(192, 320, 3, b, stride=2))
        self.b7 = Sequential(
            _ConvBN(inp, 192, 1, b),
            _ConvBN(192, 192, (1, 7), b, padding=(0, 3)),
            _ConvBN(192, 192, (7, 1), b, padding=(3, 0)),
            _ConvBN(192, 192, 3, b, stride=2))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return _cat([self.b3(x), self.b7(x), self.pool(x)])


class _InceptionC(Layer):
    def __init__(self, inp, b):
        super().__init__()
        self.b1 = _ConvBN(inp, 320, 1, b)
        self.b3_stem = _ConvBN(inp, 384, 1, b)
        self.b3_a = _ConvBN(384, 384, (1, 3), b, padding=(0, 1))
        self.b3_b = _ConvBN(384, 384, (3, 1), b, padding=(1, 0))
        self.b3d_stem = Sequential(_ConvBN(inp, 448, 1, b),
                                   _ConvBN(448, 384, 3, b, padding=1))
        self.b3d_a = _ConvBN(384, 384, (1, 3), b, padding=(0, 1))
        self.b3d_b = _ConvBN(384, 384, (3, 1), b, padding=(1, 0))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             _ConvBN(inp, 192, 1, b))

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3d_stem(x)
        return _cat([self.b1(x), self.b3_a(s), self.b3_b(s),
                     self.b3d_a(d), self.b3d_b(d), self.bp(x)])


class InceptionV3(Layer):
    """`device` / `generator`: see `Builder`."""

    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 generator=None):
        super().__init__()
        b = Builder(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            _ConvBN(3, 32, 3, b, stride=2), _ConvBN(32, 32, 3, b),
            _ConvBN(32, 64, 3, b, padding=1), MaxPool2D(3, stride=2),
            _ConvBN(64, 80, 1, b), _ConvBN(80, 192, 3, b),
            MaxPool2D(3, stride=2))
        self.blocks = Sequential(
            _InceptionA(192, 32, b), _InceptionA(256, 64, b),
            _InceptionA(288, 64, b), _ReductionA(288, b),
            _InceptionB(768, 128, b), _InceptionB(768, 160, b),
            _InceptionB(768, 160, b), _InceptionB(768, 192, b),
            _ReductionB(768, b), _InceptionC(1280, b), _InceptionC(2048, b))
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.5)
            self.fc = b.linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return InceptionV3(**kwargs)
