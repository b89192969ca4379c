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

AOT deployment artifacts (`save_inference(..., aot=True)`): beside the
portable program, the forward is compiled ahead of time for this host
into an AOTInductor package (`model_aot.pt2`, `jit.aoti`), stamped with
the host it compiled for and its sha256 (`meta["aot"]`).  The package
takes the weights as inputs and holds none: the loaded layer hands it
the portable program's.  A compatible host's `load_inference` runs the
package (`TranslatedLayer.is_aot`); a missing, stamp-mismatched or
damaged one is refused with its reason (a warning and
`aot_artifact_refused_total`) and the portable program serves, or
`strict_aot=True` raises `AOTIncompatible`.  The JAX stamp's mesh and
jax / jaxlib versions become the compute capability and the torch and
CUDA versions.
"""
from __future__ import annotations

import hashlib
import json
import os
import platform
import warnings

import torch

from ..observability import metrics as _metrics
from ..ops import flash_attention as _flash  # noqa: F401  registers the op
from .aoti import AOTProgram, AOTShapeMismatch, FunctionalProgram, \
    compile_packages, module_weights

_MODEL = "model.pt2"
_META = "inference_meta.json"
_AOT = "model_aot.pt2"
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int64": torch.int64,
           "int32": torch.int32, "bool": torch.bool}


class AOTIncompatible(RuntimeError):
    """An AOT artifact cannot run on this host; `.reason` says why."""

    def __init__(self, reason):
        super().__init__(reason)
        self.reason = reason


class InputSpec:
    """A symbolic input: `shape` (None for a dim that may vary) and
    `dtype` (a name or a torch.dtype)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.name = name

    @classmethod
    def from_tensor(cls, t, name=None):
        """The spec of tensor `t`: its shape and dtype."""
        return cls(tuple(t.shape), t.dtype, name)

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
    afterwards.

    `aot=True` also compiles the forward for this host into an
    AOTInductor package (`model_aot.pt2`) with the weights as inputs, and
    records its stamp, checksum, weight names and input signature in
    `meta["aot"]`.  A package is specialized to its shapes: a None dim
    raises ValueError (export one directory a shape instead)."""
    specs = [_to_spec(s) for s in input_spec]
    if aot and any(d is None for s in specs for d in s.shape):
        raise ValueError(
            "aot=True requires concrete input shapes: a compiled package "
            "is specialized to its shapes (use explicit batch sizes, one "
            "export a shape)")
    device = next(iter(layer.parameters())).device
    args, dynamic = _example_inputs(specs, device)
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    modes = [(m, m.training) for m in layer.modules()]
    layer.eval()
    aot_meta = None
    try:
        with torch.no_grad():
            program = torch.export.export(
                layer, args, dynamic_shapes=dynamic
                if any(d is not None for d in dynamic) else None)
        if aot:
            aot_meta = _write_aot(layer, args, path)
    finally:
        for m, mode in modes:
            m.training = mode
    torch.export.save(program, os.path.join(path, _MODEL))
    meta = {"input_spec": [{"shape": [d if d is None else int(d)
                                      for d in s.shape],
                            "dtype": _dtype_name(s.dtype), "name": s.name}
                           for s in specs],
            "n_outputs": len(program.graph_signature.user_outputs)}
    if aot_meta is not None:
        meta["aot"] = aot_meta
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f)


def _call(model, *inputs):
    return model(*inputs)


def _write_aot(layer, args, path):
    """Compile the forward, weights as inputs, into `path/model_aot.pt2`;
    -> the stamp, the package's sha256, the weight names and the input
    signature."""
    names, weights = module_weights(layer)
    [(signature, _, _)] = compile_packages([(
        FunctionalProgram(layer, _call, names), (weights,) + tuple(args),
        os.path.join(path, _AOT), None)])
    with open(os.path.join(path, _AOT), "rb") as f:
        payload = f.read()
    stamp = _env_stamp(args[0].device if args else None)
    stamp.update(sha256=hashlib.sha256(payload).hexdigest(),
                 weights=names, signature=signature)
    return stamp


def _env_stamp(device=None):
    """What a package compiled on `device` (default: the CUDA device when
    there is one, else the CPU) depends on: the platform, the device's
    name and count, its compute capability, and the torch and CUDA
    versions."""
    device = torch.device(device if device is not None else
                          "cuda" if torch.cuda.is_available() else "cpu")
    if device.type == "cuda":
        cap = torch.cuda.get_device_capability(device)
        plat, kind = "gpu", torch.cuda.get_device_name(device)
        n, capability = torch.cuda.device_count(), f"{cap[0]}.{cap[1]}"
    else:
        plat, kind, n, capability = "cpu", platform.machine(), 1, None
    return {"platform": plat, "device_kind": kind, "n_devices": n,
            "capability": capability, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def _aot_compatible(stamp):
    """(ok, reason): the stamp against this host.  Every refusal names
    the field that diverged and both values."""
    cur = _env_stamp("cpu" if stamp.get("platform") == "cpu" else None)
    for k, what in (("platform", "backend platform"),
                    ("device_kind", "device kind"),
                    ("n_devices", "device count"),
                    ("capability", "compute capability"),
                    ("torch", "torch version"),
                    ("cuda", "CUDA version")):
        if stamp.get(k) != cur[k]:
            return False, (f"{what} mismatch: artifact compiled for "
                           f"{stamp.get(k)!r}, this host is {cur[k]!r}")
    return True, ""


class TranslatedLayer:
    """Runs a loaded inference program (counterpart: `TranslatedLayer`,
    `:221-272`): inputs are tensors or numpy arrays (moved to the
    program's device), outputs tensors there; no gradient is kept.  With
    a loaded AOT package (`is_aot`) a call runs the package on the
    program's weights; a call whose inputs the package was not compiled
    for warns and drops to the exported program for good."""

    def __init__(self, program, meta, aot=None):
        self.program = program
        self.meta = meta
        self._module = program.module()
        self.device = next(iter(program.state_dict.values())).device
        self._aot = aot
        self._weights = None
        if aot is not None:
            state = {**program.state_dict, **program.constants}
            self._weights = [state[n] for n in meta["aot"]["weights"]]

    @property
    def is_aot(self):
        return self._aot is not None

    def __call__(self, *inputs):
        args = [torch.as_tensor(x).to(self.device) for x in inputs]
        if self._aot is not None:
            try:
                return self._aot(self._weights, *args)
            except AOTShapeMismatch as e:
                warnings.warn(
                    f"AOT package rejected this call ({e}); falling back "
                    f"to the exported program", UserWarning, stacklevel=2)
                self._aot = self._weights = None
        with torch.no_grad():
            return self._module(*args)

    forward = __call__

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is inference-only")


def _load_aot(path, meta, program):
    """(the loaded AOTProgram, "") or (None, the reason it is refused)."""
    stamp = meta.get("aot")
    aot_path = os.path.join(path, _AOT)
    if stamp is None or not os.path.exists(aot_path):
        return None, "no AOT artifact in this export"
    ok, reason = _aot_compatible(stamp)
    if not ok:
        return None, reason
    try:
        with open(aot_path, "rb") as f:
            payload = f.read()
        if hashlib.sha256(payload).hexdigest() != stamp.get("sha256"):
            return None, "artifact checksum mismatch (damaged file)"
        state = {**program.state_dict, **program.constants}
        missing = [n for n in stamp["weights"] if n not in state]
        if missing:
            return None, f"weights {missing[:3]} not in the program"
        return AOTProgram(aot_path, stamp["signature"]), ""
    except Exception as e:  # a damaged or foreign package
        return None, f"artifact failed to load: {e}"


def load_inference(path, prefer_aot=True, strict_aot=False):
    """Load an inference export.  When it carries an AOT package that is
    compatible with this host, the layer runs it (`is_aot`); an
    incompatible or damaged one is refused with the reason (a warning and
    `aot_artifact_refused_total`) and the exported program serves.
    `strict_aot=True` turns that refusal into AOTIncompatible."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    program = torch.export.load(os.path.join(path, _MODEL))
    aot = None
    if prefer_aot:
        aot, reason = _load_aot(path, meta, program)
        if aot is None and meta.get("aot") is not None:
            if strict_aot:
                raise AOTIncompatible(reason)
            warnings.warn(
                f"AOT artifact refused: {reason}; falling back to the "
                f"exported program", UserWarning, stacklevel=2)
            _metrics.registry().counter("aot_artifact_refused_total").inc()
    return TranslatedLayer(program, meta, aot=aot)


def is_inference_dir(path):
    return os.path.isdir(path) and \
        os.path.exists(os.path.join(path, _MODEL))
