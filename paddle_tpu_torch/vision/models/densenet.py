"""DenseNet (counterpart: `paddle_tpu/vision/models/densenet.py`)."""
from __future__ import annotations

import torch

from ...nn import (AdaptiveAvgPool2D, AvgPool2D, Dropout, Layer, MaxPool2D,
                   ReLU, Sequential)
from ._builder import Builder, no_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFG = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class _DenseLayer(Layer):
    def __init__(self, inp, growth, bn_size, dropout, b):
        super().__init__()
        self.norm1 = b.bn(inp)
        self.relu = ReLU()
        self.conv1 = b.conv(inp, bn_size * growth, 1, bias_attr=False)
        self.norm2 = b.bn(bn_size * growth)
        self.conv2 = b.conv(bn_size * growth, growth, 3, padding=1,
                            bias_attr=False)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        y = self.conv1(self.relu(self.norm1(x)))
        y = self.conv2(self.relu(self.norm2(y)))
        if self.dropout is not None:
            y = self.dropout(y)
        return torch.cat([x, y], dim=1)


class _Transition(Sequential):
    def __init__(self, inp, out, b):
        super().__init__(b.bn(inp), ReLU(),
                         b.conv(inp, out, 1, bias_attr=False),
                         AvgPool2D(2, stride=2))


class DenseNet(Layer):
    """`layers` one of 121, 161, 169, 201, 264; `device` / `generator`:
    see `Builder`."""

    def __init__(self, layers=121, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True, device=None,
                 generator=None):
        super().__init__()
        if layers not in _CFG:
            raise ValueError(f"unsupported densenet depth {layers}")
        b = Builder(device, generator)
        init_c, growth, blocks = _CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        feats = [b.conv(3, init_c, 7, stride=2, padding=3, bias_attr=False),
                 b.bn(init_c), ReLU(), MaxPool2D(3, stride=2, padding=1)]
        c = init_c
        for i, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(c, growth, bn_size, dropout, b))
                c += growth
            if i != len(blocks) - 1:
                feats.append(_Transition(c, c // 2, b))
                c //= 2
        feats += [b.bn(c), ReLU()]
        self.features = Sequential(*feats)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = b.linear(c, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _make(layers):
    def build(pretrained=False, **kwargs):
        no_pretrained(pretrained)
        return DenseNet(layers=layers, **kwargs)
    build.__name__ = build.__qualname__ = f"densenet{layers}"
    return build


densenet121 = _make(121)
densenet161 = _make(161)
densenet169 = _make(169)
densenet201 = _make(201)
densenet264 = _make(264)
