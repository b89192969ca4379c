"""The incubate package of the port: MoE, the fused layers and functions,
LookAhead and ModelAverage (counterpart: `paddle_tpu/incubate`, which
exports the same names).  `group_sharded_parallel` lives with the
distributed slice (ROADMAP.md A11)."""
from . import nn  # noqa: F401
from . import optimizer  # noqa: F401
from .nn.moe import MoELayer, moe_aux_loss  # noqa: F401
from .optimizer import LookAhead, ModelAverage  # noqa: F401

__all__ = ["LookAhead", "MoELayer", "ModelAverage", "moe_aux_loss", "nn",
           "optimizer"]
