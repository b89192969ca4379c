"""Inference export (counterpart: `paddle_tpu/jit/save_load.py:53-311`).

`save_inference(layer, path, input_spec)` traces the layer's eval-mode
forward with `torch.export` over the inputs `input_spec` describes and
writes the program (its weights inside) and a meta file to the directory
`path`; `load_inference(path)` returns a `TranslatedLayer` that runs the
loaded program, without the model's Python code.  The JAX package
exports StableHLO; the port's program is a `torch.export` archive whose
attention is the one operator `paddle_tpu_torch::flash_fwd` (on the
card: the flash forward kernels, their launches counted when the program
runs).  A `None` dim of an `InputSpec` becomes a `torch.export.Dim`, so
one program takes any size there.

The AOT artifacts of the JAX package (`aot=True`, a compiled executable
beside the portable program) belong to the serving tier's `serving/
aot.py`, which the port has not reached: `aot=True` raises.
"""
from __future__ import annotations

import json
import os

import torch

from ..ops import flash_attention as _flash  # noqa: F401  registers the op

_MODEL = "model.pt2"
_META = "inference_meta.json"
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int64": torch.int64,
           "int32": torch.int32, "bool": torch.bool}


class InputSpec:
    """A symbolic input: `shape` (None for a dim that may vary) and
    `dtype` (a name or a torch.dtype)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


def _dtype_name(dtype):
    return str(dtype).split(".")[1]


def _to_spec(s):
    if isinstance(s, InputSpec):
        return s
    if hasattr(s, "shape") and hasattr(s, "dtype"):
        return InputSpec(tuple(s.shape), s.dtype)
    raise TypeError(f"bad input_spec entry: {s!r}")


def _example_inputs(specs, device):
    """Zeros of each spec's shape on `device` (2 for a None dim), and the
    dynamic shapes: each None dim a `torch.export.Dim` of its own."""
    args, dynamic = [], []
    for i, s in enumerate(specs):
        shape = [2 if d is None else int(d) for d in s.shape]
        args.append(torch.zeros(shape, dtype=s.dtype, device=device))
        dims = {j: torch.export.Dim(f"d{i}_{j}") for j, d in
                enumerate(s.shape) if d is None}
        dynamic.append(dims or None)
    return tuple(args), tuple(dynamic)


def save_inference(layer, path, input_spec, aot=False):
    """Export `layer`'s eval-mode forward over `input_spec` to the
    directory `path` (the program with its weights, and the meta).  The
    example inputs lie on the device of the layer's parameters, so the
    program runs there.  Every sublayer's train / eval mode is restored
    afterwards."""
    if aot:
        raise NotImplementedError(
            "save_inference(aot=True): compiled deployment artifacts are "
            "the serving tier's serving/aot.py (ROADMAP A9), not ported yet")
    specs = [_to_spec(s) for s in input_spec]
    device = next(iter(layer.parameters())).device
    args, dynamic = _example_inputs(specs, device)
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    modes = [(m, m.training) for m in layer.modules()]
    layer.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(
                layer, args, dynamic_shapes=dynamic
                if any(d is not None for d in dynamic) else None)
    finally:
        for m, mode in modes:
            m.training = mode
    torch.export.save(program, os.path.join(path, _MODEL))
    meta = {"input_spec": [{"shape": [d if d is None else int(d)
                                      for d in s.shape],
                            "dtype": _dtype_name(s.dtype), "name": s.name}
                           for s in specs],
            "n_outputs": len(program.graph_signature.user_outputs)}
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f)


class TranslatedLayer:
    """Runs a loaded inference program (counterpart: `TranslatedLayer`,
    `:221-272`): inputs are tensors or numpy arrays (moved to the
    program's device), outputs tensors there; no gradient is kept."""

    def __init__(self, program, meta):
        self.program = program
        self.meta = meta
        self._module = program.module()
        self.device = next(iter(program.state_dict.values())).device

    def __call__(self, *inputs):
        args = [torch.as_tensor(x).to(self.device) for x in inputs]
        with torch.no_grad():
            return self._module(*args)

    forward = __call__

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is inference-only")


def load_inference(path):
    path = os.path.abspath(path)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    return TranslatedLayer(torch.export.load(os.path.join(path, _MODEL)),
                           meta)


def is_inference_dir(path):
    return os.path.isdir(path) and \
        os.path.exists(os.path.join(path, _MODEL))
