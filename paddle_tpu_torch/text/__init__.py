"""Language models of the port (counterpart: `paddle_tpu/text`)."""
from .convert import (convert_hf_bert, convert_hf_ernie, convert_hf_gpt2,
                      convert_hf_llama, convert_hf_qwen2)
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
from .peft import LoRAConfig, LoRALinear, LoRAModel, get_peft_model
from .qwen import Qwen2Config, Qwen2ForCausalLM, Qwen2Model
from .transformer_mt import (TransformerModel, sinusoidal_positions,
                             transformer_mt_loss)

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "BucketPolicy",
           "ERNIE3_PRESETS", "ErnieConfig", "ErnieForMaskedLM",
           "ErnieForPretraining", "ErnieForQuestionAnswering",
           "ErnieForSequenceClassification", "ErnieForTokenClassification",
           "ErnieModel", "GPTAttention", "GPTBlock", "GPTConfig",
           "GPTForCausalLM", "GPTMLP", "GPTModel", "GPTPretrainingCriterion",
           "LlamaBlock", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LoRAConfig", "LoRALinear", "LoRAModel", "Qwen2Config",
           "Qwen2ForCausalLM", "Qwen2Model", "TransformerModel", "beam_search",
           "bert_loss_fn", "convert_hf_bert", "convert_hf_ernie",
           "convert_hf_gpt2", "convert_hf_llama", "convert_hf_qwen2",
           "ernie_config_from_preset", "filter_logits", "generate",
           "get_peft_model", "gpt_loss_fn", "sinusoidal_positions",
           "transformer_mt_loss"]
