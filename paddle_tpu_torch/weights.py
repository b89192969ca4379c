"""Carry weights from the JAX package into the port.

`load_paddle_tpu_state(model, arrays)` takes the `{name: np.ndarray}`
that a `paddle_tpu` model's `state_dict()` gives (each value through
`np.asarray`) and copies it into the port's model of the same
architecture (GPT, GPT-MoE, LLaMA, Mistral, Qwen2, BERT, ERNIE, every
family of the vision zoo (ResNet, LeNet, AlexNet, VGG, SqueezeNet,
MobileNet v1 / v2 / v3, ShuffleNetV2, DenseNet, GoogLeNet, InceptionV3),
`vision.ops.DeformConv2D`, the incubate package's fused layers, and any
of them wrapped by LoRA, converted to weight-only, or quantized by
`quantization.QAT` / `PTQ` before or after `convert`), name for name.
The JAX package keeps a Linear weight as [in, out] (`paddle_tpu/nn/
common.py::Linear`); `torch.nn.Linear` keeps [out, in], so those weights
(every projection, LLaMA's untied `lm_head`, a vision model's `fc`,
`classifier` and aux heads, BERT's and ERNIE's `*_proj`, `linear1` /
`linear2`, `pooler` and `classifier`, the `*.base.weight` of a LoRA
layer and the `*.inner.weight` of a `QuantedLinear`) are transposed on
the way.  The rest keeps its layout: embeddings, norm weights and
biases, a routed block's stacked experts (`mlp.gate_weight` [d, E],
`mlp.w1` [E, d, f], `mlp.w2` [E, f, d] and their biases), the fused
layers' raw [in, out] weights (`qkv_weight`, `linear_weight`,
`linear1_weight`, ...), OIHW conv weights, batch-norm running
statistics, the quanters' and observers' scales, LoRA's `lora_A` [in,
r] and `lora_B` [r, out] (the port keeps the JAX layout for them), a
weight-only layer's int8 `quant_weight` [in, out] and `weight_scale`,
and an `Int8Linear`'s int8 `w_int8` [in, out], `w_scale` and
`act_scale`, which are copied bit for bit.

A tensor-parallel model (`distributed.parallel_layers`) takes the same
dense arrays: each parallel layer keeps its rank's piece, split along the
JAX package's axis (GPT's fused qkv per head, in each of q, k and v), so
one JAX state loads at any mp degree; its `state_dict()` gathers the
pieces back to the dense layout.

`load_paddle_tpu_optimizer_state(optimizer, model, state)` does the same
for the JAX optimizer's per-parameter slots.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _linear_weights(model):
    """The names of every nn.Linear weight of `model` (the model itself
    included)."""
    return {f"{name}.weight" if name else "weight"
            for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


@torch.no_grad()
def load_paddle_tpu_state(model, arrays):
    """Copy `arrays` into `model`'s parameters and buffers, converting to
    each tensor's dtype and device.  A tensor the model holds under two
    names (BERT's LM decoder tied to the word embeddings) is listed once
    by the JAX package, so it is loaded once, from whichever of its names
    `arrays` has.  Raises KeyError on a missing or an unexpected name and
    ValueError on a shape mismatch.  Returns model."""
    from .distributed.parallel_layers import parallel_parameters
    linear = _linear_weights(model)
    split = parallel_parameters(model)
    state = model.state_dict(keep_vars=True)
    names = {}                      # tensor id -> every name it goes by
    for name, t in state.items():
        names.setdefault(id(t), []).append(name)
    missing = sorted(n for group in names.values()
                     if not any(g in arrays for g in group) for n in group)
    unexpected = sorted(set(arrays) - set(state))
    if missing or unexpected:
        raise KeyError(f"state names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, dst in state.items():
        if name not in arrays:      # an alias of a tensor loaded by name
            continue
        src = np.asarray(arrays[name])
        if name in linear:
            src = src.T
        src = torch.from_numpy(np.array(src))        # a writable copy
        if name in split:
            layer, attr = split[name]
            want = layer.dense_shape(attr, dst.shape)
            if tuple(src.shape) != want:
                raise ValueError(f"{name}: shape {tuple(src.shape)} does "
                                 f"not fit {want}")
            src = layer.shard(attr, src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} does not "
                             f"fit {tuple(dst.shape)}")
        dst.copy_(src)
    return model


# slots with a Linear weight's own shape, transposed on the way (Adam's
# moments, the master copy, Adafactor's first moment)
_FULL_SLOTS = {"moment1", "moment2", "master", "m"}


@torch.no_grad()
def load_paddle_tpu_optimizer_state(optimizer, model, state):
    """Carry a JAX optimizer's per-parameter slots into the port's
    `optimizer`, whose parameters are `model`'s.

    `state` maps each parameter name of the model to its `{slot: array}`
    (the JAX TrainStep's `_opt_state` zipped with `named_parameters()`);
    an optional "step" sets the step counter.  For a Linear weight
    ([in, out] there, [out, in] here) the full-shape slots are transposed
    and Adafactor's factored `vr` / `vc` are swapped (see
    `optimizer.Adafactor`).  Raises KeyError
    on a missing or unexpected parameter or slot name and ValueError on a
    shape mismatch.  Returns optimizer."""
    linear = _linear_weights(model)
    names = {id(p): n for n, p in model.named_parameters()}
    if optimizer._state is None:
        optimizer.init_state()
    nested = {k: v for k, v in state.items() if k != "step"}
    ours = {names[id(p)]: slots for p, slots in
            zip(optimizer._parameters, optimizer._state) if slots}
    missing = sorted(set(ours) - set(nested))
    unexpected = sorted(set(nested) - set(ours))
    if missing or unexpected:
        raise KeyError(f"optimizer state names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, slots in ours.items():
        src = dict(nested[name])
        if set(src) != set(slots):
            raise KeyError(f"{name}: slots {sorted(src)} do not match "
                           f"{sorted(slots)}")
        if name in linear:
            if "vr" in src:
                src["vr"], src["vc"] = src["vc"], src["vr"]
            for s in _FULL_SLOTS & set(src):
                src[s] = np.asarray(src[s]).T
        for s, dst in slots.items():
            arr = np.asarray(src[s])
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{name}/{s}: shape {tuple(arr.shape)} "
                                 f"does not fit {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    if "step" in state:
        optimizer._step_count = int(state["step"])
    return optimizer
