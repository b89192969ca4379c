"""More layers of the reference surface (counterpart:
`paddle_tpu/nn/extras_r3.py`): 1-D and 3-D pools, channel dropout,
activations, 3-D padding, three losses, 1-D / 3-D instance norms, 1-D /
3-D transpose convolutions, the cell-driven `RNN`, `SpectralNorm` and a
beam-search decoder over a cell.  Thin layers over `functional`, each
as the JAX class computes it."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import functional as PF
from . import initializer as I
from .common import _kw
from .layer import Layer


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return PF.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return PF.adaptive_max_pool1d(x, self.output_size)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return PF.adaptive_avg_pool3d(x, self.output_size)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return PF.adaptive_max_pool3d(x, self.output_size)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True):
        super().__init__()
        self._kw = dict(kernel_size=kernel_size, stride=stride,
                        padding=padding, ceil_mode=ceil_mode,
                        exclusive=exclusive)

    def forward(self, x):
        return PF.avg_pool3d(x, **self._kw)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 ceil_mode=False, return_mask=False):
        super().__init__()
        self._kw = dict(kernel_size=kernel_size, stride=stride,
                        padding=padding, ceil_mode=ceil_mode)

    def forward(self, x):
        return PF.max_pool3d(x, **self._kw)


class Dropout3D(Layer):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        return PF.dropout3d(x, self.p, training=self.training,
                            generator=self.generator)


class Maxout(Layer):
    def __init__(self, groups, axis=1):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return PF.maxout(x, self.groups, self.axis)


class RReLU(Layer):
    def __init__(self, lower=1. / 8., upper=1. / 3.):
        super().__init__()
        self.lower, self.upper = lower, upper
        self.generator = None

    def forward(self, x):
        return PF.rrelu(x, self.lower, self.upper, training=self.training,
                        generator=self.generator)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return PF.thresholded_relu(x, self.threshold)


class Pad3D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW"):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value

    def forward(self, x):
        return PF.pad(x, self.padding, mode=self.mode, value=self.value)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean"):
        super().__init__()
        self._kw = dict(p=p, margin=margin, weight=weight,
                        reduction=reduction)

    def forward(self, input, label):
        return PF.multi_margin_loss(input, label, **self._kw)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean"):
        super().__init__()
        self.distance_function = distance_function
        self.margin, self.swap, self.reduction = margin, swap, reduction

    def forward(self, input, positive, negative):
        return PF.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function, self.margin,
            self.swap, self.reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over the default complete binary tree: weight
    [num_classes - 1, feature_size] from U(+-1/sqrt(feature_size)), bias
    zero; a custom or sparse tree raises."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 device=None, dtype=None, generator=None):
        super().__init__(**_kw(device, dtype, generator))
        if is_custom or is_sparse:
            raise NotImplementedError(
                "custom-tree / sparse hsigmoid is not supported")
        self.num_classes = num_classes
        bound = 1.0 / np.sqrt(feature_size)
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size],
            default_initializer=I.Uniform(-bound, bound))
        self.bias = self.create_parameter([num_classes - 1], is_bias=True)

    def forward(self, input, label):
        return PF.hsigmoid_loss(input, label, self.num_classes,
                                self.weight, self.bias)


class InstanceNorm1D(Layer):
    """Instance norm with a scale (ones) and a shift (zeros); the attrs
    and momentum are taken and unused, as in the JAX package."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, device=None, dtype=None):
        super().__init__(**_kw(device, dtype, None))
        self.eps = epsilon
        self.weight = self.create_parameter(
            [num_features], default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], is_bias=True)

    def forward(self, x):
        return PF.instance_norm(x, weight=self.weight, bias=self.bias,
                                eps=self.eps)


class InstanceNorm3D(InstanceNorm1D):
    pass


class _ConvTransposeU(Layer):
    """A transpose convolution with weight [in, out / groups, k...] and
    bias both from U(+-1/sqrt(in * prod(k))) (the JAX extras' draw)."""

    def __init__(self, nd, in_channels, out_channels, kernel_size, stride,
                 padding, output_padding, dilation, groups, bias_attr,
                 device, dtype, generator):
        super().__init__(**_kw(device, dtype, generator))
        k = (kernel_size,) * nd if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        bound = 1.0 / math.sqrt(in_channels * int(np.prod(k)))
        init = I.Uniform(-bound, bound)
        self.weight = self.create_parameter(
            [in_channels, out_channels // groups, *k],
            default_initializer=init)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], default_initializer=init)
        self._kw = dict(stride=stride, padding=padding,
                        output_padding=output_padding, dilation=dilation,
                        groups=groups)


class Conv1DTranspose(_ConvTransposeU):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, device=None, dtype=None,
                 generator=None):
        k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
        super().__init__(1, in_channels, out_channels, k, stride, padding,
                         output_padding, dilation, groups, bias_attr,
                         device, dtype, generator)

    def forward(self, x):
        return PF.conv1d_transpose(x, self.weight, self.bias, **self._kw)


class Conv3DTranspose(_ConvTransposeU):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, device=None, dtype=None,
                 generator=None):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         bias_attr, device, dtype, generator)

    def forward(self, x):
        return PF.conv3d_transpose(x, self.weight, self.bias, **self._kw)


class RNNCellBase(Layer):
    """The base of user cells driven by `RNN`."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None):
        from .layer import convert_dtype
        return torch.zeros(batch_ref.shape[0], self.hidden_size,
                           dtype=convert_dtype(dtype) or torch.float32,
                           device=batch_ref.device)


class RNN(Layer):
    """Run a cell over a sequence: cell(input_t, state) -> (output_t,
    state); outputs stacked on the time axis."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else inputs.transpose(0, 1)
        steps = range(x.shape[0])
        if self.is_reverse:
            steps = reversed(steps)
        state = initial_states
        if state is None and hasattr(self.cell, "get_initial_states"):
            state = self.cell.get_initial_states(x[0])
        outs = []
        for t in steps:
            out, state = self.cell(x[t], state)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        y = torch.stack(outs, 0)
        return (y if self.time_major else y.transpose(0, 1)), state


class SpectralNorm(Layer):
    """`forward(weight)`: weight / sigma, sigma its largest singular value
    (of `weight` with `dim` moved first and the rest flattened) by
    `power_iters` power iterations from the buffers `weight_u` [h] and
    `weight_v` [w] (normal draws, not updated: the JAX layer keeps them
    fixed too)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self.dim, self.power_iters, self.eps = dim, power_iters, eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        dev = self._resolved_device()
        u = torch.empty(h, device=dev)
        v = torch.empty(w, device=dev)
        self.register_buffer("weight_u", u.normal_(generator=generator))
        self.register_buffer("weight_v", v.normal_(generator=generator))

    def forward(self, weight):
        mat = weight.movedim(self.dim, 0).reshape(weight.shape[self.dim],
                                                  -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self.power_iters):
            v = mat.t() @ u
            v = v / (torch.linalg.vector_norm(v) + self.eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self.eps)
        sigma = (u * (mat @ v)).sum()
        return weight / sigma


class BeamSearchDecoder(Layer):
    """Beam search over a cell.  `decode(init_state, batch_size,
    max_steps)` keeps `beam_size` hypotheses a row by summed log-prob
    (only beam 0 live at the start), and returns (the [T, B, beam] tokens
    walked back through the parents with `gather_tree`, the final
    scores)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        super().__init__()
        self.cell = cell
        self.start_token, self.end_token = start_token, end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def decode(self, init_state, batch_size, max_steps=32):
        B, K = batch_size, self.beam_size
        dev = next(iter(self.cell.parameters())).device
        ids = torch.full((B, K), self.start_token, dtype=torch.int64,
                         device=dev)
        scores = torch.zeros(B, K, device=dev)
        scores[:, 1:] = -1e9
        state = init_state
        all_ids, all_parents = [], []
        for _ in range(max_steps):
            tok = ids.reshape(B * K)
            emb = self.embedding_fn(tok) if self.embedding_fn else \
                tok.unsqueeze(-1).float()
            out, state = self.cell(emb, state)
            logits = self.output_fn(out) if self.output_fn else out
            V = logits.shape[-1]
            logp = torch.log_softmax(logits.reshape(B, K, V), -1)
            cand = scores.unsqueeze(-1) + logp
            top_v, top_i = cand.reshape(B, K * V).topk(K, dim=-1)
            all_parents.append(top_i // V)
            ids = top_i % V
            scores = top_v
            all_ids.append(ids)
        return PF.gather_tree(torch.stack(all_ids), torch.stack(
            all_parents)), scores
