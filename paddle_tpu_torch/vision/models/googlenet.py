"""GoogLeNet / Inception v1 (counterpart:
`paddle_tpu/vision/models/googlenet.py`): with `num_classes > 0` it
returns (main, aux1, aux2) logits, as the reference does."""
from __future__ import annotations

import torch

from ...nn import AdaptiveAvgPool2D, Dropout, Layer, MaxPool2D, ReLU
from ...nn import Sequential
from ._builder import Builder, no_pretrained

__all__ = ["GoogLeNet", "googlenet"]


class _ConvReLU(Sequential):
    def __init__(self, inp, out, kernel, b, **kw):
        super().__init__(b.conv(inp, out, kernel, **kw), ReLU())


class Inception(Layer):
    def __init__(self, inp, c1, c3r, c3, c5r, c5, proj, b):
        super().__init__()
        self.b1 = _ConvReLU(inp, c1, 1, b)
        self.b2 = Sequential(_ConvReLU(inp, c3r, 1, b),
                             _ConvReLU(c3r, c3, 3, b, padding=1))
        self.b3 = Sequential(_ConvReLU(inp, c5r, 1, b),
                             _ConvReLU(c5r, c5, 5, b, padding=2))
        self.b4 = Sequential(MaxPool2D(3, stride=1, padding=1),
                             _ConvReLU(inp, proj, 1, b))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                         dim=1)


class _AuxHead(Layer):
    def __init__(self, inp, num_classes, b):
        super().__init__()
        self.pool = AdaptiveAvgPool2D(4)
        self.conv = _ConvReLU(inp, 128, 1, b)
        self.fc1 = b.linear(128 * 16, 1024)
        self.relu = ReLU()
        self.drop = Dropout(0.7)
        self.fc2 = b.linear(1024, num_classes)

    def forward(self, x):
        x = self.conv(self.pool(x)).flatten(1)
        return self.fc2(self.drop(self.relu(self.fc1(x))))


class GoogLeNet(Layer):
    """`device` / `generator`: see `Builder`."""

    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 generator=None):
        super().__init__()
        b = Builder(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            _ConvReLU(3, 64, 7, b, stride=2, padding=3),
            MaxPool2D(3, stride=2, ceil_mode=True),
            _ConvReLU(64, 64, 1, b), _ConvReLU(64, 192, 3, b, padding=1),
            MaxPool2D(3, stride=2, ceil_mode=True))
        self.i3a = Inception(192, 64, 96, 128, 16, 32, 32, b)
        self.i3b = Inception(256, 128, 128, 192, 32, 96, 64, b)
        self.pool3 = MaxPool2D(3, stride=2, ceil_mode=True)
        self.i4a = Inception(480, 192, 96, 208, 16, 48, 64, b)
        self.i4b = Inception(512, 160, 112, 224, 24, 64, 64, b)
        self.i4c = Inception(512, 128, 128, 256, 24, 64, 64, b)
        self.i4d = Inception(512, 112, 144, 288, 32, 64, 64, b)
        self.i4e = Inception(528, 256, 160, 320, 32, 128, 128, b)
        self.pool4 = MaxPool2D(3, stride=2, ceil_mode=True)
        self.i5a = Inception(832, 256, 160, 320, 32, 128, 128, b)
        self.i5b = Inception(832, 384, 192, 384, 48, 128, 128, b)
        if with_pool or num_classes > 0:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.drop = Dropout(0.4)
            self.fc = b.linear(1024, num_classes)
            self.aux1 = _AuxHead(512, num_classes, b)
            self.aux2 = _AuxHead(528, num_classes, b)

    def forward(self, x):
        x = self.i3b(self.i3a(self.stem(x)))
        x = self.i4a(self.pool3(x))
        aux1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.i4d(self.i4c(self.i4b(x)))
        aux2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.i5b(self.i5a(self.pool4(self.i4e(x))))
        if self.num_classes > 0:
            return self.fc(self.drop(self.avgpool(x).flatten(1))), aux1, aux2
        if self.with_pool:
            x = self.avgpool(x)
        return x


def googlenet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return GoogLeNet(**kwargs)
