"""Qwen2 family: the LLaMA block with biased q/k/v projections.

Counterpart: `paddle_tpu/text/qwen.py`.  As there, the model classes ARE
the Llama classes specialised through the config (larger vocabulary,
higher rope theta, `attention_bias` on by default); the inner module
keeps the `llama` attribute name, so state dicts carry across unchanged.
"""
from __future__ import annotations

from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel


class Qwen2Config(LlamaConfig):
    PRESETS = {
        "qwen2-0.5b": dict(hidden_size=896, num_layers=24, num_heads=14,
                           num_kv_heads=2, intermediate_size=4864,
                           vocab_size=151936, rope_theta=1000000.0,
                           max_position_embeddings=32768),
        "qwen2-1.5b": dict(hidden_size=1536, num_layers=28, num_heads=12,
                           num_kv_heads=2, intermediate_size=8960,
                           vocab_size=151936, rope_theta=1000000.0,
                           max_position_embeddings=32768),
        "qwen2-7b": dict(hidden_size=3584, num_layers=28, num_heads=28,
                         num_kv_heads=4, intermediate_size=18944,
                         vocab_size=152064, rope_theta=1000000.0,
                         max_position_embeddings=32768),
        "qwen2-tiny": dict(hidden_size=128, num_layers=2, num_heads=4,
                           num_kv_heads=2, intermediate_size=256,
                           vocab_size=256, max_position_embeddings=128),
    }

    def __init__(self, **kw):
        kw.setdefault("attention_bias", True)   # the Qwen2 signature
        super().__init__(**kw)


class Qwen2Model(LlamaModel):
    pass


class Qwen2ForCausalLM(LlamaForCausalLM):
    """The LlamaForCausalLM graph; refuses any config but a Qwen2Config."""

    def __init__(self, cfg, **kw):
        if not isinstance(cfg, Qwen2Config):
            raise TypeError("Qwen2ForCausalLM expects a Qwen2Config")
        super().__init__(cfg, **kw)
