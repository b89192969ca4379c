"""Language models of the port (counterpart: `paddle_tpu/text`)."""
from .generation import BucketPolicy, filter_logits
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM, GPTMLP,
                  GPTModel, GPTPretrainingCriterion, gpt_loss_fn)

__all__ = ["BucketPolicy", "GPTAttention", "GPTBlock", "GPTConfig",
           "GPTForCausalLM", "GPTMLP", "GPTModel", "GPTPretrainingCriterion",
           "filter_logits", "gpt_loss_fn"]
