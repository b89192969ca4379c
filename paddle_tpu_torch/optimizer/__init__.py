"""Optimizers of the port (counterpart: `paddle_tpu/optimizer`)."""
from .optimizer import Optimizer
from .optimizers import Adafactor, Adam, AdamW, Momentum

__all__ = ["Adafactor", "Adam", "AdamW", "Momentum", "Optimizer"]
