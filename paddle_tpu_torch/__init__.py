"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package `paddle_tpu` stays the reference; this package keeps its
layouts and parameter names so weights carry across name for name
(`weights.load_paddle_tpu_state`).  It imports torch and numpy only.

It holds the GPT serving path: the model (`text`), the paged KV pool,
scheduler and continuous-batching engine (`serving`), and the paged
decode attention kernel written in CUDA for sm_90a (`ops`); and the GPT
training step: the flash-attention forward and backward kernels in CUDA
(`ops.flash_attention`), dropout, attention and cross entropy
(`nn.functional`), gradient clipping (`nn.clip`), recompute
(`distributed`), AMP O2 (`amp`), Adam, AdamW and Adafactor
(`optimizer`), and `TrainStep` (`jit`); and generation with the LLaMA
family: `text.decode.jit_generate` (the decode step captured as a CUDA
graph), eager `text.generate`, beam search and speculative decoding, and
`LlamaForCausalLM` / `Qwen2ForCausalLM` (LLaMA, Mistral, Qwen2); and the
training families: LoRA (`text.peft`), weight-only int8 / int4
(`nn.quant`), HF checkpoint conversion (`text.convert`), and ResNet
(`vision.models`) over `nn.Conv2D`, `nn.BatchNorm2D`, the pooling layers
and `optimizer.Momentum`; and the encoder family: the transformer encoder
layers (`nn.transformer`), BERT and ERNIE-3.0 (`text.bert`,
`text.ernie`), the LR schedulers (`optimizer.lr`), parameter groups,
float16 loss scaling (`amp.GradScaler`), and inference export and
deployment (`jit.save_inference`, `inference.create_predictor`); and
the training state: checkpoints and the random state (`framework`),
`ParamAttr`, the nonfinite-step guard, the checkpoint manager and fault
injection (`resilience`), `amp.auto_cast` (O1 and O2), gradient clipping
by value and by norm, and the other eleven optimizers of the JAX
package.
"""
from .device import generator, resolve_device
from .framework import (CheckpointError, ParamAttr, get_rng_state,
                        load_state, save_state, seed, set_rng_state)

__all__ = ["CheckpointError", "ParamAttr", "generator", "get_rng_state",
           "load_state", "resolve_device", "save_state", "seed",
           "set_rng_state"]
