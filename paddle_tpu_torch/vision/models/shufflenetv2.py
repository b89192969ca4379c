"""ShuffleNetV2 (counterpart: `paddle_tpu/vision/models/shufflenetv2.py`)."""
from __future__ import annotations

import torch

from ... import tensor_api as T
from ...nn import (AdaptiveAvgPool2D, Layer, LayerList, MaxPool2D, ReLU,
                   Sequential, Swish)
from ._builder import Builder, no_pretrained

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]

_STAGE_OUT = {
    0.25: (24, 24, 48, 96, 512), 0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024), 1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024), 2.0: (24, 244, 488, 976, 2048),
}


def channel_shuffle(x, groups):
    b, c, h, w = x.shape
    x = T.reshape(x, [b, groups, c // groups, h, w])
    x = T.transpose(x, [0, 2, 1, 3, 4])
    return T.reshape(x, [b, c, h, w])


def _act(name):
    return Swish() if name == "swish" else ReLU()


class _ShuffleUnit(Layer):
    def __init__(self, inp, out, stride, act, b):
        super().__init__()
        self.stride = stride
        branch = out // 2
        if stride == 1:
            if inp != out:
                raise ValueError(f"a stride-1 unit keeps its width: "
                                 f"{inp} != {out}")
            in_branch = inp // 2
        else:
            in_branch = inp
            self.branch1 = Sequential(
                b.conv(in_branch, in_branch, 3, stride=stride, padding=1,
                       groups=in_branch, bias_attr=False),
                b.bn(in_branch),
                b.conv(in_branch, branch, 1, bias_attr=False),
                b.bn(branch), _act(act))
        self.branch2 = Sequential(
            b.conv(in_branch if stride > 1 else branch, branch, 1,
                   bias_attr=False),
            b.bn(branch), _act(act),
            b.conv(branch, branch, 3, stride=stride, padding=1,
                   groups=branch, bias_attr=False),
            b.bn(branch),
            b.conv(branch, branch, 1, bias_attr=False),
            b.bn(branch), _act(act))

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            out = torch.cat([x[:, :c], self.branch2(x[:, c:])], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(Layer):
    """`scale` one of 0.25, 0.33, 0.5, 1.0, 1.5, 2.0; `act` "relu" or
    "swish"; `device` / `generator`: see `Builder`."""

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, device=None, generator=None):
        super().__init__()
        b = Builder(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        c0, c1, c2, c3, c_last = _STAGE_OUT[scale]
        self.conv1 = Sequential(
            b.conv(3, c0, 3, stride=2, padding=1, bias_attr=False),
            b.bn(c0), _act(act))
        self.max_pool = MaxPool2D(3, stride=2, padding=1)
        stages, inp = [], c0
        for reps, out in zip((4, 8, 4), (c1, c2, c3)):
            units = [_ShuffleUnit(inp, out, 2, act, b)]
            units += [_ShuffleUnit(out, out, 1, act, b)
                      for _ in range(reps - 1)]
            stages.append(Sequential(*units))
            inp = out
        self.stages = LayerList(stages)
        self.conv_last = Sequential(
            b.conv(inp, c_last, 1, bias_attr=False), b.bn(c_last),
            _act(act))
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = b.linear(c_last, num_classes)

    def forward(self, x):
        x = self.max_pool(self.conv1(x))
        for stage in self.stages:
            x = stage(x)
        x = self.conv_last(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _make(scale, act="relu", name=None):
    def build(pretrained=False, **kwargs):
        no_pretrained(pretrained)
        return ShuffleNetV2(scale=scale, act=act, **kwargs)
    build.__name__ = build.__qualname__ = name or f"shufflenet_v2_x{scale}"
    return build


shufflenet_v2_x0_25 = _make(0.25, name="shufflenet_v2_x0_25")
shufflenet_v2_x0_33 = _make(0.33, name="shufflenet_v2_x0_33")
shufflenet_v2_x0_5 = _make(0.5, name="shufflenet_v2_x0_5")
shufflenet_v2_x1_0 = _make(1.0, name="shufflenet_v2_x1_0")
shufflenet_v2_x1_5 = _make(1.5, name="shufflenet_v2_x1_5")
shufflenet_v2_x2_0 = _make(2.0, name="shufflenet_v2_x2_0")
shufflenet_v2_swish = _make(1.0, act="swish", name="shufflenet_v2_swish")
