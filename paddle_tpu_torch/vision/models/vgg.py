"""VGG (counterpart: `paddle_tpu/vision/models/vgg.py`)."""
from __future__ import annotations

from ...nn import (AdaptiveAvgPool2D, Dropout, Layer, MaxPool2D, ReLU,
                   Sequential)
from ._builder import Builder, no_pretrained

_CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M",
         512, 512, "M", 512, 512, "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm, b):
    layers, in_c = [], 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(b.conv(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(b.bn(v))
            layers.append(ReLU())
            in_c = v
    return Sequential(*layers)


class VGG(Layer):
    """`features`: the conv stack (`_make_features`); `device` /
    `generator` (see `Builder`) make the classifier."""

    def __init__(self, features, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__()
        b = Builder(device, generator)
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        self.classifier = Sequential(
            b.linear(512 * 7 * 7, 4096), ReLU(), Dropout(),
            b.linear(4096, 4096), ReLU(), Dropout(),
            b.linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        return self.classifier(x.flatten(1))


def _vgg(depth, batch_norm, device=None, generator=None, **kwargs):
    b = Builder(device, generator)
    return VGG(_make_features(_CFGS[depth], batch_norm, b), **kwargs,
               device=b.device, generator=b.generator)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    no_pretrained(pretrained)
    return _vgg(11, batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    no_pretrained(pretrained)
    return _vgg(13, batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    no_pretrained(pretrained)
    return _vgg(16, batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    no_pretrained(pretrained)
    return _vgg(19, batch_norm, **kwargs)
