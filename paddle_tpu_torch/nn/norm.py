"""Normalization layers (counterpart: `paddle_tpu/nn/norm.py`).

`LayerNorm`, `RMSNorm`, `GroupNorm` and `InstanceNorm2D` hold a scale
(ones) and a shift (zeros); `weight_attr=False` / `bias_attr=False` drop
them, and a `ParamAttr` or an initializer sets how they are made.

The batch norms keep the running statistics in float32 buffers named as
the JAX package names them (`_mean`, `_variance`), so they carry across
through `weights.load_paddle_tpu_state`, and `amp.decorate` leaves them
in float32 (it casts parameters only).  The momentum convention is the
JAX package's (running = momentum * running + (1 - momentum) * batch,
default 0.9), not torch's; see `functional.batch_norm`.  A training
forward updates the statistics in place, so `TrainStep` carries them
from step to step as the JAX step threads its buffers through.

`SyncBatchNorm` is `BatchNorm` on one rank.  Under `torch.distributed`
it sums each channel's count, sum and sum of squares over the
data-parallel group (the mesh's "dp" axis when a mesh is built, else
the world) with a differentiable all-reduce, and normalises every rank
by those statistics; the JAX package gets the same from XLA's global
reductions over a sharded batch.

`LocalResponseNorm` divides by (k + alpha * sum)^beta over a window of
`size` channels, the sum not divided by `size`: the JAX layer's formula,
which differs from its `functional.local_response_norm` (that one
divides by `size`, as torch does).
"""
from __future__ import annotations

import torch

from . import functional as PF
from . import initializer as I
from .common import _attr_init, _kw
from .layer import Layer


def _affine(layer, shape, weight_attr, bias_attr):
    """The scale (ones) and shift (zeros) of a norm layer, each None when
    its attr is False."""
    layer.weight = None if weight_attr is False else layer.create_parameter(
        shape, attr=weight_attr,
        default_initializer=_attr_init(weight_attr) or I.Constant(1.0))
    layer.bias = None if bias_attr is False else layer.create_parameter(
        shape, attr=bias_attr, is_bias=True,
        default_initializer=_attr_init(bias_attr) or I.Constant(0.0))


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, device=None, dtype=None):
        super().__init__(**_kw(device, dtype, None))
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        _affine(self, self.normalized_shape, weight_attr, bias_attr)

    def forward(self, x):
        return PF.layer_norm(x, self.normalized_shape, self.weight,
                             self.bias, self.epsilon)

    def extra_repr(self):
        return f"{self.normalized_shape}, eps={self.epsilon}"


class RMSNorm(Layer):
    """`functional.rms_norm` with a learned scale (ones)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 device=None, dtype=None):
        super().__init__(**_kw(device, dtype, None))
        self.epsilon = float(epsilon)
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=_attr_init(weight_attr) or I.Constant(1.0))

    def forward(self, x):
        return PF.rms_norm(x, self.weight, self.epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, device=None, dtype=None):
        super().__init__(**_kw(device, dtype, None))
        self.num_groups = num_groups
        self.epsilon = epsilon
        _affine(self, [num_channels], weight_attr, bias_attr)

    def forward(self, x):
        return PF.group_norm(x, self.num_groups, self.weight, self.bias,
                             self.epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, device=None, dtype=None):
        super().__init__(**_kw(device, dtype, None))
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        _affine(self, [num_features], weight_attr, bias_attr)
        f32 = dict(device=self._resolved_device(), dtype=torch.float32)
        self.register_buffer("_mean", torch.zeros(num_features, **f32))
        self.register_buffer("_variance", torch.ones(num_features, **f32))

    def forward(self, x):
        training = self.training and not self.use_global_stats
        return PF.batch_norm(x, self._mean, self._variance, self.weight,
                             self.bias, training=training,
                             momentum=self.momentum, epsilon=self.epsilon,
                             data_format=self.data_format)

    def extra_repr(self):
        return (f"{self.num_features}, momentum={self.momentum}, "
                f"data_format={self.data_format}")


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class BatchNorm(_BatchNormBase):
    """dygraph-style BatchNorm (the same layer)."""


def _sync_group():
    """The process group SyncBatchNorm reduces over, or None for one
    rank."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        return None
    from ..distributed import mesh
    pg = mesh.axis_group("dp") if mesh.has_mesh() else dist.group.WORLD
    if pg is None or dist.get_world_size(pg) == 1:
        return None
    return pg


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group's ranks whose gradient is the sum of theirs."""

    @staticmethod
    def forward(ctx, t, pg):
        import torch.distributed as dist
        ctx.pg = pg
        t = t.clone()
        dist.all_reduce(t, group=pg)
        return t

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.pg)
        return g, None


class SyncBatchNorm(_BatchNormBase):
    def forward(self, x):
        pg = _sync_group()
        training = self.training and not self.use_global_stats
        if pg is None or not training:
            return super().forward(x)
        channels_last = self.data_format in ("NHWC", "NLC", "NDHWC") and \
            x.dim() > 2
        xc = (x.movedim(-1, 1) if channels_last else x).float()
        axes = [d for d in range(xc.dim()) if d != 1]
        n = torch.full((1,), xc.numel() // xc.shape[1], dtype=torch.float32,
                       device=x.device)
        stats = _AllReduceSum.apply(torch.cat([
            xc.sum(axes), xc.square().sum(axes), n]), pg)
        c = xc.shape[1]
        count = stats[-1]
        mean = stats[:c] / count
        var = stats[c:2 * c] / count - mean.square()
        shape = [1, c] + [1] * (xc.dim() - 2)
        out = (xc - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + self.epsilon)
        if self.weight is not None:
            out = out * self.weight.float().reshape(shape)
        if self.bias is not None:
            out = out + self.bias.float().reshape(shape)
        with torch.no_grad():
            m = self.momentum
            self._mean.mul_(m).add_((1 - m) * mean)
            self._variance.mul_(m).add_(
                (1 - m) * var * (count / (count - 1).clamp(min=1)))
        out = out.to(x.dtype)
        return out.movedim(1, -1) if channels_last else out

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Replace every batch norm under `layer` (not a SyncBatchNorm
        already) by a SyncBatchNorm holding its parameters and
        statistics; returns `layer`."""
        for parent in list(layer.modules()):
            for name, sub in list(parent.named_children()):
                if isinstance(sub, _BatchNormBase) and \
                        not isinstance(sub, SyncBatchNorm):
                    sync = SyncBatchNorm(
                        sub.num_features, sub.momentum, sub.epsilon,
                        weight_attr=False if sub.weight is None else None,
                        bias_attr=False if sub.bias is None else None,
                        data_format=sub.data_format,
                        use_global_stats=sub.use_global_stats,
                        device=sub._mean.device,
                        dtype=None if sub.weight is None
                        else sub.weight.dtype)
                    sync.load_state_dict(sub.state_dict())
                    setattr(parent, name, sync)
        return layer


class InstanceNorm2D(Layer):
    """Group norm with one group a channel."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, device=None, dtype=None):
        super().__init__(**_kw(device, dtype, None))
        self.epsilon = epsilon
        _affine(self, [num_features], weight_attr, bias_attr)

    def forward(self, x):
        return PF.group_norm(x, x.shape[1], self.weight, self.bias,
                             self.epsilon)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        # the functional form divides the window sum by `size`
        return PF.local_response_norm(x, self.size, self.alpha * self.size,
                                      self.beta, self.k)
