"""Optimizers of the port (counterpart: `paddle_tpu/optimizer`)."""
from . import lr
from ..regularizer import L1Decay, L2Decay
from .optimizer import Optimizer
from .optimizers import (ASGD, LBFGS, SGD, Adadelta, Adafactor, Adagrad,
                         Adam, Adamax, AdamW, Lamb, Momentum, NAdam, RAdam,
                         RMSProp, Rprop)

__all__ = ["ASGD", "Adadelta", "Adafactor", "Adagrad", "Adam", "AdamW",
           "Adamax", "L1Decay", "L2Decay", "LBFGS", "Lamb", "Momentum",
           "NAdam", "Optimizer", "RAdam", "RMSProp", "Rprop", "SGD", "lr"]
