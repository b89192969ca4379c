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
package; and the incubate package: the MoE layer and GPT-MoE
(`incubate.nn.MoELayer`, `GPTConfig(num_experts=...)`), the fused
transformer layers and functions (`incubate.nn`), LookAhead and
ModelAverage (`incubate.optimizer`); and the high-level API: `Model`
(`hapi`) with its callbacks, the metrics (`metric`), the DataLoader and
its worker processes over a shared-memory ring (`io`), the vision
datasets and transforms (`vision`), `LazyGuard`, the dtypes and the
Place API (`dtypes`, `device`), `to_tensor`, `create_parameter`,
`flops`, `summary` and `save` / `load`; and the compile path:
`jit.to_static` over `torch.compile` with dy2static control flow, the
static Program / Executor (`enable_static`, `static`), the public
autograd API (`grad`, `autograd`), `Tensor` (torch's own), `parameter`,
and the `base` / `fluid` aliases; and the tensor functions: the
top-level functions of `tensor_api` (`zeros`, `arange`, `matmul`,
`concat`, `where`, `topk`, `unique`, `einsum`, ...), `linalg`, `fft`,
`signal`, the `check_numerics` flag of the training steps
(`framework.debugging`), the metrics exports and `profiler` over
torch.profiler.
"""
import sys as _sys

from torch import enable_grad, no_grad, set_grad_enabled  # noqa: F401

from . import autograd, base, incubate  # noqa: F401
from .api import (create_parameter, flops, is_grad_enabled,  # noqa: F401
                  summary, to_tensor)
from .device import (CPUPlace, CUDAPlace, Place, TPUPlace,  # noqa: F401
                     device_count, generator, get_device,
                     is_compiled_with_cuda, is_compiled_with_tpu,
                     is_compiled_with_xpu, resolve_device, set_device)
from .dtypes import (bfloat16, complex64, complex128, finfo,  # noqa: F401
                     float16, float32, float64, get_default_dtype, iinfo,
                     int8, int16, int32, int64, set_default_dtype, uint8)
from .dtypes import bool_ as bool8  # noqa: F401
from .framework import (CheckpointError, ParamAttr, get_rng_state,
                        load_state, save_state, seed, set_rng_state)
from .framework.lazy import LazyGuard  # noqa: F401
from .framework.static_graph import (disable_static,  # noqa: F401
                                     enable_static)
from .autograd import grad  # noqa: F401
from .tensor import Tensor, parameter  # noqa: F401
from .tensor_api import *  # noqa: F401,F403,E402
# the names bound above stay the same objects (tensor_api re-exports them)
from .api import to_tensor  # noqa: F401,E402
from .dtypes import finfo, iinfo  # noqa: F401,E402
from .framework import checkpoint, seed  # noqa: F401,E402

__version__ = "0.1.0"

fluid = base  # legacy namespace alias (paddle.fluid)
# a real module entry, so `import paddle_tpu_torch.fluid` and
# `from paddle_tpu_torch.fluid import layers` work
_sys.modules[__name__ + ".fluid"] = base

__all__ = ["CheckpointError", "ParamAttr", "Tensor", "disable_static",
           "enable_static", "generator", "get_rng_state", "grad",
           "in_dynamic_mode", "load_state", "parameter", "resolve_device",
           "save_state", "seed", "set_rng_state"]


def in_dynamic_mode():
    """False while static mode (`enable_static`) is on."""
    from .framework import static_graph
    return not static_graph.enabled()


# subpackages (and DataParallel) bound on first use, as the JAX package
# binds them at import (`paddle_tpu/__init__.py:30-52`); importing them
# all here would load the serving tier and the inference stack with every
# `import paddle_tpu_torch`
_LAZY = {name: (f"paddle_tpu_torch.{name}", None) for name in (
    "amp", "callbacks", "device", "distributed", "dtypes", "framework",
    "hapi", "inference", "io", "jit", "metric", "nn", "observability",
    "ops", "optimizer", "regularizer", "resilience", "serving", "static",
    "text", "vision", "linalg", "fft", "signal", "profiler", "tensor_api")}
_LAZY["DataParallel"] = ("paddle_tpu_torch.distributed", "DataParallel")
_LAZY["Model"] = ("paddle_tpu_torch.hapi", "Model")
_LAZY["save"] = ("paddle_tpu_torch.jit", "save")
_LAZY["load"] = ("paddle_tpu_torch.jit", "load")


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'paddle_tpu_torch' has no attribute {name!r}") from None
    import importlib
    mod = importlib.import_module(mod_name)
    val = mod if attr is None else getattr(mod, attr)
    globals()[name] = val
    return val
