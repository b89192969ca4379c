"""Language models of the port (counterpart: `paddle_tpu/text`)."""
from .generation import BucketPolicy, filter_logits
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM, GPTMLP,
                  GPTModel)

__all__ = ["BucketPolicy", "GPTAttention", "GPTBlock", "GPTConfig",
           "GPTForCausalLM", "GPTMLP", "GPTModel", "filter_logits"]
