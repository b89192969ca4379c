"""Optimizers of the port (counterpart: `paddle_tpu/optimizer`)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import Adafactor, Adam, AdamW, Momentum

__all__ = ["Adafactor", "Adam", "AdamW", "Momentum", "Optimizer", "lr"]
