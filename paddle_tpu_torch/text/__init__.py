"""Language models of the port (counterpart: `paddle_tpu/text`)."""
from .generation import BucketPolicy, beam_search, filter_logits, generate
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM, GPTMLP,
                  GPTModel, GPTPretrainingCriterion, gpt_loss_fn)
from .llama import LlamaBlock, LlamaConfig, LlamaForCausalLM, LlamaModel
from .qwen import Qwen2Config, Qwen2ForCausalLM, Qwen2Model

__all__ = ["BucketPolicy", "GPTAttention", "GPTBlock", "GPTConfig",
           "GPTForCausalLM", "GPTMLP", "GPTModel", "GPTPretrainingCriterion",
           "LlamaBlock", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "Qwen2Config", "Qwen2ForCausalLM", "Qwen2Model", "beam_search",
           "filter_logits", "generate", "gpt_loss_fn"]
