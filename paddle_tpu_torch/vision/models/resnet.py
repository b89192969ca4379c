"""ResNet family (counterpart: `paddle_tpu/vision/models/resnet.py:16-199`).

The same module tree and names as the JAX package (`conv1.weight`,
`layer1.0.bn1._mean`, `layer2.0.downsample.0.weight`, `fc.weight`, ...),
so `weights.load_paddle_tpu_state` carries a JAX ResNet across (the fc
weight transposed, conv weights OIHW on both sides).

`data_format="NHWC"` takes [b, H, W, 3] images and runs every conv,
batch norm and pool channels-last: each layer sees its NHWC tensor as an
NCHW-shaped view with `torch.channels_last` strides, and the conv
weights are kept in channels-last memory, so cuDNN runs its NHWC kernels
with no layout copy between layers.  `s2d_stem=True` runs the 7x7 /
stride-2 stem as space-to-depth + a 4x4 conv over the same weight
(`ops.s2d_stem_conv`, exact in exact arithmetic) when H and W are even.
"""
from __future__ import annotations

import inspect
import math

import torch
from torch import nn

from ... import ops
from ...device import generator as make_generator
from ...device import resolve_device
from ...nn.conv import Conv2D
from ...nn.norm import BatchNorm2D
from ...nn.pooling import AdaptiveAvgPool2D, MaxPool2D
from ._builder import no_pretrained


def _mk_norm(norm_layer, num_features, kw):
    """`norm_layer(num_features)`, handing it `data_format` and `device`
    only where its signature takes them, so that a custom callable (a
    GroupNorm lambda, ...) works as in the JAX package (`:16-25`)."""
    try:
        params = inspect.signature(norm_layer).parameters
    except (TypeError, ValueError):
        params = {}
    return norm_layer(num_features,
                      **{k: v for k, v in kw.items() if k in params})


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", device=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = dict(data_format=data_format, device=device)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, **kw)
        self.bn1 = _mk_norm(norm_layer, planes, kw)
        self.relu = nn.ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **kw)
        self.bn2 = _mk_norm(norm_layer, planes, kw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(out)) + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", device=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = dict(data_format=data_format, device=device)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = _mk_norm(norm_layer, width, kw)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=dilation,
                            groups=groups, dilation=dilation,
                            bias_attr=False, **kw)
        self.bn2 = _mk_norm(norm_layer, width, kw)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, **kw)
        self.bn3 = _mk_norm(norm_layer, planes * self.expansion, kw)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        return self.relu(self.bn3(self.conv3(out)) + identity)


class ResNet(nn.Module):
    """ResNet of `depth` over `block`, built on `device` (the CUDA device
    unless told otherwise; raises when there is none) in float32; cast it
    with `amp.decorate`.  Conv weights are drawn Kaiming-uniform and the
    fc weight Xavier-uniform (the JAX package's defaults) from
    `generator` (a torch.Generator on `device`; by default one seeded
    with 0); batch norms start at unit scale, zero shift."""

    LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
              101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, s2d_stem=False,
                 data_format="NCHW", device=None, generator=None):
        super().__init__()
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, not "
                             f"{data_format!r}")
        device = resolve_device(device)
        layers = self.LAYERS[depth]
        self.groups, self.base_width = groups, width
        self.num_classes, self.with_pool = num_classes, with_pool
        self.inplanes = 64
        self.data_format = data_format
        self.s2d_stem = bool(s2d_stem)
        kw = dict(data_format=data_format, device=device)
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, **kw)
        self.bn1 = BatchNorm2D(self.inplanes, **kw)
        self.relu = nn.ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1,
                                 data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0], 1, kw)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, kw)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, kw)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, kw)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1), data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                device=device)
        self.reset_parameters(generator if generator is not None
                              else make_generator(0, device))

    def _make_layer(self, block, planes, blocks, stride, kw):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **kw),
                BatchNorm2D(planes * block.expansion, **kw))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **kw))
        return nn.Sequential(*layers)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for mod in self.modules():
            if isinstance(mod, Conv2D):
                mod.reset_parameters(generator)
            elif isinstance(mod, nn.Linear):
                fan_in, fan_out = mod.in_features, mod.out_features
                limit = math.sqrt(6.0 / (fan_in + fan_out))
                mod.weight.uniform_(-limit, limit, generator=generator)
                mod.bias.zero_()

    def forward(self, x):
        nhwc = self.data_format == "NHWC"
        h, w = (x.shape[1], x.shape[2]) if nhwc else (x.shape[2],
                                                      x.shape[3])
        if self.s2d_stem and h % 2 == 0 and w % 2 == 0:
            stem = ops.s2d_stem_conv_nhwc if nhwc else ops.s2d_stem_conv
            x = stem(x, self.conv1.weight)
        else:
            x = self.conv1(x)
        x = self.maxpool(self.relu(self.bn1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=32, width=4,
                   **kwargs)
