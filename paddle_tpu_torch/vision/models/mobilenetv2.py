"""MobileNetV2 (counterpart: `paddle_tpu/vision/models/mobilenetv2.py`)."""
from __future__ import annotations

from ...nn import AdaptiveAvgPool2D, Dropout, Layer, ReLU6, Sequential
from ._builder import Builder, no_pretrained


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(Sequential):
    def __init__(self, in_c, out_c, b, kernel=3, stride=1, groups=1):
        super().__init__(
            b.conv(in_c, out_c, kernel, stride=stride,
                   padding=(kernel - 1) // 2, groups=groups,
                   bias_attr=False),
            b.bn(out_c), ReLU6())


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio, b):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden, b, kernel=1))
        layers += [ConvBNReLU(hidden, hidden, b, stride=stride,
                              groups=hidden),
                   b.conv(hidden, oup, 1, bias_attr=False), b.bn(oup)]
        self.conv = Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2(Layer):
    """`device` / `generator`: see `Builder`."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__()
        b = Builder(device, generator)
        cfg = [[1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2], [6, 64, 4, 2],
               [6, 96, 3, 1], [6, 160, 3, 2], [6, 320, 1, 1]]
        input_channel = _make_divisible(32 * scale)
        last_channel = _make_divisible(1280 * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, b, stride=2)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t, b))
                input_channel = out_c
        features.append(ConvBNReLU(input_channel, last_channel, b, kernel=1))
        self.features = Sequential(*features)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2), b.linear(last_channel, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
