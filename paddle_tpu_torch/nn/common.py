"""Common layers (counterpart: `paddle_tpu/nn/common.py`).

`Linear` is a `torch.nn.Linear` with the weight [out, in], where the JAX
package keeps [in, out]: `weights.load_paddle_tpu_state` transposes it on
the way in (it does so for every `torch.nn.Linear`), and LoRA, the
weight-only conversion and the parallel layers take it as they take any
torch Linear.  Its initializers still see [in, out] (see `initializer`),
so Xavier's and Kaiming's fans and `Assign`'s value are the JAX
package's.  `Embedding` zeroes its `padding_idx` row when it is built,
and that row gets no gradient, as the JAX `embedding` kernel stops it.

Randomness (the dropouts, RReLU) draws from the layer's `generator`
attribute (None: the device's default generator).
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F
from . import initializer as I
from .layer import Layer


def _attr_init(attr):
    """The initializer a `weight_attr` / `bias_attr` names: a ParamAttr's
    or an initializer given directly."""
    if attr is None or attr is False:
        return None
    return getattr(attr, "initializer", None) or (
        attr if isinstance(attr, I.Initializer) else None)


def _kw(device, dtype, generator):
    return dict(dtype=dtype or "float32", device=device, generator=generator)


class Linear(nn.Linear, Layer):
    """y = x W^T + b with W [out_features, in_features] (see the module
    note); `bias_attr=False` drops the bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None, dtype=None,
                 generator=None):
        Layer.__init__(self, name, **_kw(device, dtype, generator))
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr, transposed=True,
            default_initializer=_attr_init(weight_attr) or I.XavierUniform())
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = self.create_parameter(
                [out_features], attr=bias_attr, is_bias=True,
                default_initializer=_attr_init(bias_attr) or I.Constant(0.0))

    def __setstate__(self, state):
        # a copy (deepcopy, pickle) keeps the weight's layout mark
        super().__setstate__(state)
        self.weight._paddle_transposed = True


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, device=None,
                 dtype=None, generator=None):
        super().__init__(name, **_kw(device, dtype, generator))
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=_attr_init(weight_attr) or I.Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    """`functional.dropout` as a layer (upscale_in_train: `mode` is kept
    and not passed on, as in the JAX layer); GPT's
    `set_dropout_generator` sets `generator`."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__(name)
        self.p = float(p)
        self.axis = axis
        self.mode = mode
        self.generator = None

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         generator=self.generator)


class Dropout2D(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__(name)
        self.p = p
        self.generator = None

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           generator=self.generator)


class AlphaDropout(Dropout):
    pass


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return x.flatten(self.start_axis, self.stop_axis)


class Identity(Layer):
    def forward(self, x):
        return x


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None):
        super().__init__(size, scale_factor, "bilinear", True)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None):
        super().__init__(size, scale_factor, "nearest")


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL"):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        p = [padding] * 4 if isinstance(padding, int) else list(padding)
        super().__init__(p, mode, value)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW"):
        super().__init__(padding, mode="constant", value=0.0,
                         data_format=data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW"):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW"):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Bilinear(Layer):
    """out[b, o] = x1[b] W[o] x2[b] + bias; W [out, in1, in2] Xavier-
    uniform, bias [1, out] zero.  The attrs are taken and not applied,
    as in the JAX package."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, device=None, dtype=None,
                 generator=None):
        super().__init__(**_kw(device, dtype, generator))
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features])
        self.bias = None if bias_attr is False else self.create_parameter(
            [1, out_features], is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Softmax2D(Layer):
    """Softmax over the channel axis of [N, C, H, W] (or [C, H, W])."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings,
                     dilations)

    def forward(self, x):
        return F.fold(x, *self.args)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class PReLU(Layer):
    """max(0, x) + weight * min(0, x), one weight or one per channel
    (axis 1)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 device=None, dtype=None):
        super().__init__(**_kw(device, dtype, None))
        self.weight = self.create_parameter(
            [num_parameters], default_initializer=I.Constant(init))

    def forward(self, x):
        w = self.weight
        if w.numel() > 1:
            w = w.reshape([1, -1] + [1] * (x.dim() - 2))
        return F.prelu(x, w)


# ------------------------------------------------------ activation layers
def _act_layer(name, fn, **defaults):
    """A layer class calling fn(x, **kwargs), its keyword arguments given
    at construction over `defaults`."""
    class _Act(Layer):
        def __init__(self, **kwargs):
            super().__init__()
            self._kw = {**defaults, **kwargs}

        def forward(self, x):
            return fn(x, **self._kw)

        def extra_repr(self):
            return ", ".join(f"{k}={v}" for k, v in self._kw.items())

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
GELU = _act_layer("GELU", F.gelu)
SiLU = _act_layer("SiLU", F.silu)
Swish = _act_layer("Swish", F.swish)
Mish = _act_layer("Mish", F.mish)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
Tanh = _act_layer("Tanh", F.tanh)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardsigmoid = _act_layer("Hardsigmoid", lambda x: F.hardsigmoid(x))
Hardtanh = _act_layer("Hardtanh", F.hardtanh)
LeakyReLU = _act_layer("LeakyReLU", F.leaky_relu)
ELU = _act_layer("ELU", F.elu)
CELU = _act_layer("CELU", F.celu)
SELU = _act_layer("SELU", F.selu)
Softplus = _act_layer("Softplus", F.softplus)
Softshrink = _act_layer("Softshrink", F.softshrink)
Hardshrink = _act_layer("Hardshrink", F.hardshrink)
Softsign = _act_layer("Softsign", F.softsign)
Tanhshrink = _act_layer("Tanhshrink", F.tanhshrink)
LogSigmoid = _act_layer("LogSigmoid", F.log_sigmoid)
Softmax = _act_layer("Softmax", F.softmax, axis=-1)
LogSoftmax = _act_layer("LogSoftmax", F.log_softmax, axis=-1)
GLU = _act_layer("GLU", F.glu, axis=-1)
