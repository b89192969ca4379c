"""MobileNetV1 (counterpart: `paddle_tpu/vision/models/mobilenetv1.py`)."""
from __future__ import annotations

from ...nn import AdaptiveAvgPool2D, Layer, ReLU, Sequential
from ._builder import Builder, no_pretrained

__all__ = ["MobileNetV1", "mobilenet_v1"]


class _ConvBNReLU(Sequential):
    def __init__(self, inp, out, kernel, b, stride=1, padding=0, groups=1):
        super().__init__(
            b.conv(inp, out, kernel, stride=stride, padding=padding,
                   groups=groups, bias_attr=False),
            b.bn(out), ReLU())


class _DepthwiseSeparable(Sequential):
    def __init__(self, inp, out, stride, b):
        super().__init__(
            _ConvBNReLU(inp, inp, 3, b, stride=stride, padding=1,
                        groups=inp),
            _ConvBNReLU(inp, out, 1, b))


class MobileNetV1(Layer):
    """`device` / `generator`: see `Builder`."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__()
        b = Builder(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return max(int(c * scale), 8)

        cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
               (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
               (1024, 1)]
        layers = [_ConvBNReLU(3, s(32), 3, b, stride=2, padding=1)]
        c = s(32)
        for out, stride in cfg:
            layers.append(_DepthwiseSeparable(c, s(out), stride, b))
            c = s(out)
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = b.linear(c, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)
