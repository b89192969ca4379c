"""Batch normalisation (counterpart: `paddle_tpu/nn/norm.py:66-113`).

`BatchNorm2D` / `BatchNorm` keep the running statistics in float32
buffers named as the JAX package names them (`_mean`, `_variance`), so
they carry across through `weights.load_paddle_tpu_state`, and
`amp.decorate` leaves them in float32 (it casts parameters only).  The
momentum convention is the JAX package's (running = momentum * running
+ (1 - momentum) * batch, default 0.9), not torch's; see
`functional.batch_norm`.  A training forward updates the statistics in
place, so `TrainStep` carries them from step to step as the JAX step
threads its buffers through.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as PF


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, device=None, dtype=None):
        super().__init__()
        if weight_attr not in (None, False) or bias_attr not in (None,
                                                                 False):
            raise NotImplementedError(
                "BatchNorm: only weight_attr / bias_attr False are ported")
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        kw = dict(device=device, dtype=dtype)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, **kw))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, **kw))
        f32 = dict(device=device, dtype=torch.float32)
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


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm(_BatchNormBase):
    """dygraph-style BatchNorm (the same layer)."""
