"""MoE, the fused transformer layers and the fused functions
(counterpart: `paddle_tpu/incubate/nn`)."""
from . import functional  # noqa: F401
from .fused_transformer import FusedFeedForward, FusedMultiHeadAttention
from .moe import MoELayer, moe_aux_loss, moe_ffn, moe_ffn_expert_choice

__all__ = ["FusedFeedForward", "FusedMultiHeadAttention", "MoELayer",
           "functional", "moe_aux_loss", "moe_ffn", "moe_ffn_expert_choice"]
