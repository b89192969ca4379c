"""AlexNet (counterpart: `paddle_tpu/vision/models/alexnet.py`)."""
from __future__ import annotations

from ...nn import (AdaptiveAvgPool2D, Dropout, Layer, MaxPool2D, ReLU,
                   Sequential)
from ._builder import Builder, no_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(Layer):
    """`device` / `generator`: see `Builder`."""

    def __init__(self, num_classes=1000, dropout=0.5, device=None,
                 generator=None):
        super().__init__()
        b = Builder(device, generator)
        self.num_classes = num_classes
        self.features = Sequential(
            b.conv(3, 64, 11, stride=4, padding=2), ReLU(),
            MaxPool2D(3, stride=2),
            b.conv(64, 192, 5, padding=2), ReLU(),
            MaxPool2D(3, stride=2),
            b.conv(192, 384, 3, padding=1), ReLU(),
            b.conv(384, 256, 3, padding=1), ReLU(),
            b.conv(256, 256, 3, padding=1), ReLU(),
            MaxPool2D(3, stride=2))
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(dropout), b.linear(256 * 6 * 6, 4096), ReLU(),
                Dropout(dropout), b.linear(4096, 4096), ReLU(),
                b.linear(4096, num_classes))

    def forward(self, x):
        x = self.avgpool(self.features(x)).flatten(1)
        if self.num_classes > 0:
            x = self.classifier(x)
        return x


def alexnet(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return AlexNet(**kwargs)
