"""SqueezeNet 1.0 / 1.1 (counterpart:
`paddle_tpu/vision/models/squeezenet.py`); the max pools round their
output size up (`ceil_mode=True`), as the reference's do."""
from __future__ import annotations

import torch

from ...nn import AdaptiveAvgPool2D, Dropout, Layer, MaxPool2D, ReLU
from ...nn import Sequential
from ._builder import Builder, no_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(Layer):
    def __init__(self, inp, squeeze, e1, e3, b):
        super().__init__()
        self.squeeze = Sequential(b.conv(inp, squeeze, 1), ReLU())
        self.expand1 = Sequential(b.conv(squeeze, e1, 1), ReLU())
        self.expand3 = Sequential(b.conv(squeeze, e3, 3, padding=1), ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return torch.cat([self.expand1(s), self.expand3(s)], dim=1)


class SqueezeNet(Layer):
    """`version` "1.0" or "1.1"; `device` / `generator`: see
    `Builder`."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__()
        b = Builder(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def pool():
            return MaxPool2D(3, stride=2, ceil_mode=True)

        if version == "1.0":
            self.features = Sequential(
                b.conv(3, 96, 7, stride=2), ReLU(), pool(),
                Fire(96, 16, 64, 64, b), Fire(128, 16, 64, 64, b),
                Fire(128, 32, 128, 128, b), pool(),
                Fire(256, 32, 128, 128, b), Fire(256, 48, 192, 192, b),
                Fire(384, 48, 192, 192, b), Fire(384, 64, 256, 256, b),
                pool(), Fire(512, 64, 256, 256, b))
        else:
            self.features = Sequential(
                b.conv(3, 64, 3, stride=2), ReLU(), pool(),
                Fire(64, 16, 64, 64, b), Fire(128, 16, 64, 64, b), pool(),
                Fire(128, 32, 128, 128, b), Fire(256, 32, 128, 128, b),
                pool(),
                Fire(256, 48, 192, 192, b), Fire(384, 48, 192, 192, b),
                Fire(384, 64, 256, 256, b), Fire(512, 64, 256, 256, b))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5), b.conv(512, num_classes, 1), ReLU(),
                AdaptiveAvgPool2D(1))
        elif with_pool:
            self.pool = AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x).flatten(1)
        elif self.with_pool:
            x = self.pool(x)
        return x


def squeezenet1_0(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)
