"""Language models of the port (counterpart: `paddle_tpu/text`)."""
from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel, bert_loss_fn)
from .ernie import (ERNIE3_PRESETS, ErnieConfig, ErnieForMaskedLM,
                    ErnieForPretraining, ErnieForQuestionAnswering,
                    ErnieForSequenceClassification,
                    ErnieForTokenClassification, ErnieModel,
                    ernie_config_from_preset)
from .generation import BucketPolicy, beam_search, filter_logits, generate
from .gpt import (GPTAttention, GPTBlock, GPTConfig, GPTForCausalLM, GPTMLP,
                  GPTModel, GPTPretrainingCriterion, gpt_loss_fn)
from .llama import LlamaBlock, LlamaConfig, LlamaForCausalLM, LlamaModel
from .qwen import Qwen2Config, Qwen2ForCausalLM, Qwen2Model

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "BucketPolicy",
           "ERNIE3_PRESETS", "ErnieConfig", "ErnieForMaskedLM",
           "ErnieForPretraining", "ErnieForQuestionAnswering",
           "ErnieForSequenceClassification", "ErnieForTokenClassification",
           "ErnieModel", "GPTAttention", "GPTBlock", "GPTConfig",
           "GPTForCausalLM", "GPTMLP", "GPTModel", "GPTPretrainingCriterion",
           "LlamaBlock", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "Qwen2Config", "Qwen2ForCausalLM", "Qwen2Model", "beam_search",
           "bert_loss_fn", "ernie_config_from_preset", "filter_logits",
           "generate", "gpt_loss_fn"]
