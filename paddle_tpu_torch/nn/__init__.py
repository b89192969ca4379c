"""Layers and functional ops of the port (counterpart: `paddle_tpu/nn`)."""
from __future__ import annotations

import torch
from torch import nn

from . import functional, quant
from .clip import ClipGradByGlobalNorm
from .conv import Conv2D
from .norm import BatchNorm, BatchNorm2D
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm", "BatchNorm2D",
           "ClipGradByGlobalNorm", "Conv2D", "Dropout", "MaxPool2D",
           "MultiHeadAttention", "RMSNorm", "TransformerEncoder",
           "TransformerEncoderLayer", "functional", "quant"]


class Dropout(nn.Module):
    """`functional.dropout` as a module (counterpart `paddle_tpu.nn.
    Dropout`), drawing from `self.generator` (None: the device's default
    generator); `GPTForCausalLM.set_dropout_generator` sets it."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        return functional.dropout(x, self.p, training=self.training,
                                  generator=self.generator)


class RMSNorm(nn.Module):
    """`functional.rms_norm` with a learned scale (counterpart
    `paddle_tpu.nn.RMSNorm`, `paddle_tpu/nn/norm.py:36-45`): the weight
    starts at ones."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return functional.rms_norm(x, self.weight, self.epsilon)


# after Dropout, which the transformer layers use
from .transformer import (MultiHeadAttention, TransformerEncoder,  # noqa: E402
                          TransformerEncoderLayer)
