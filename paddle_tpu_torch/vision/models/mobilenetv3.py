"""MobileNetV3 Small and Large (counterpart:
`paddle_tpu/vision/models/mobilenetv3.py`; Howard et al. 2019, Tables 1
and 2): inverted residuals with depthwise convolutions (`groups=exp`),
squeeze-excite gated by `Hardsigmoid`, `Hardswish` in the later
stages."""
from __future__ import annotations

from ...nn import (AdaptiveAvgPool2D, Dropout, Hardsigmoid, Hardswish,
                   Layer, ReLU, Sequential)
from ._builder import Builder, no_pretrained
from .mobilenetv2 import _make_divisible

__all__ = ["MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]


def _act(name):
    return {"relu": ReLU, "hardswish": Hardswish}[name]()


class _SqueezeExcite(Layer):
    def __init__(self, c, squeeze, b):
        super().__init__()
        self.pool = AdaptiveAvgPool2D(1)
        self.fc1 = b.conv(c, squeeze, 1)
        self.relu = ReLU()
        self.fc2 = b.conv(squeeze, c, 1)
        self.hsig = Hardsigmoid()

    def forward(self, x):
        return x * self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))


class _InvertedResidual(Layer):
    def __init__(self, inp, exp, out, kernel, stride, use_se, act, b):
        super().__init__()
        self.use_res = stride == 1 and inp == out
        layers = []
        if exp != inp:
            layers += [b.conv(inp, exp, 1, bias_attr=False), b.bn(exp),
                       _act(act)]
        layers += [b.conv(exp, exp, kernel, stride=stride,
                          padding=kernel // 2, groups=exp, bias_attr=False),
                   b.bn(exp), _act(act)]
        if use_se:
            layers.append(_SqueezeExcite(exp, _make_divisible(exp // 4), b))
        layers += [b.conv(exp, out, 1, bias_attr=False), b.bn(out)]
        self.block = Sequential(*layers)

    def forward(self, x):
        y = self.block(x)
        return x + y if self.use_res else y


# (kernel, exp, out, se, act, stride), the reference's tables
_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class _MobileNetV3(Layer):
    def __init__(self, cfg, last_exp, last_c, scale=1.0, num_classes=1000,
                 with_pool=True, device=None, generator=None):
        super().__init__()
        b = Builder(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def sc(c):
            return _make_divisible(c * scale)

        inp = sc(16)
        layers = [b.conv(3, inp, 3, stride=2, padding=1, bias_attr=False),
                  b.bn(inp), Hardswish()]
        for kernel, exp, out, se, act, stride in cfg:
            layers.append(_InvertedResidual(inp, sc(exp), sc(out), kernel,
                                            stride, se, act, b))
            inp = sc(out)
        layers += [b.conv(inp, sc(last_exp), 1, bias_attr=False),
                   b.bn(sc(last_exp)), Hardswish()]
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                b.linear(sc(last_exp), last_c), Hardswish(), Dropout(0.2),
                b.linear(last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class MobileNetV3Large(_MobileNetV3):
    """`device` / `generator`: see `Builder`."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__(_LARGE, 960, 1280, scale, num_classes, with_pool,
                         device, generator)


class MobileNetV3Small(_MobileNetV3):
    """`device` / `generator`: see `Builder`."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__(_SMALL, 576, 1024, scale, num_classes, with_pool,
                         device, generator)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
