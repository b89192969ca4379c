"""Layers and functional ops of the port (counterpart: `paddle_tpu/nn`)."""
from __future__ import annotations

from torch import nn

from . import functional
from .clip import ClipGradByGlobalNorm

__all__ = ["ClipGradByGlobalNorm", "Dropout", "functional"]


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
