"""The compile path, the training step, inference export and `save` /
`load` of the port (counterpart: `paddle_tpu/jit`).

`to_static(layer_or_fn)` is the dy2static + CINN layer of the reference:
the JAX package compiles the forward into one XLA program with
`jax.jit`; the port compiles it with `torch.compile` (Dynamo plays
dy2static's capture, Inductor plays CINN).  `full_graph=True` (the
reference's default) is `fullgraph=True`: a graph break raises.  Backward
works through `loss.backward()` with an eager `opt.step()`, as in the
reference: AOTAutograd compiles the backward graph at the first backward.
The hand kernels stay inside the graph as single nodes: the flash forward
`paddle_tpu_torch::flash_fwd` and its backward `paddle_tpu_torch::flash_bwd`
(`ops/flash_attention.py`), each launching its CUDA kernels on the card.
Tensor-dependent `if` / `while` / `for` in the forward (a Layer's
`forward` or the function itself) are rewritten by `dy2static`
(`torch.cond`, `while_loop`, a bounded masked loop with
`while_max_iters`); the compiled function calls that forward, so hooks
on the wrapped Layer itself do not run (its sublayers' do).  Bool, str and None arguments, and the training flag,
specialise the program, as `_is_static_leaf` does in the reference;
Dynamo guards on them, and on shapes (`dynamic=False`: one program per
signature, as `jax.jit` specialises).  Each call reports its signature to
`observability.compile_tracker`, with the graphs Dynamo's backend compiled
and the graph breaks it met.  Nothing falls back to eager execution: a
failed compile raises (and an error of the conversion is raised as the
reference raises it, see `dy2static`), and reaching Dynamo's recompile
limit raises.  `enable_to_static(False)` runs the original Python.
`check=True` needs the reference's `analysis/` (tracelint), which is not
ported: it raises NotImplementedError.

`save` / `load` (`paddle_tpu/jit/__init__.py:350-397`; the top-level
`paddle_tpu_torch.save` / `load` too): a Layer (a `torch.nn.Module`, or a
`StaticFunction` of one) with an `input_spec` goes to `save_inference`,
and without one raises ValueError, as in the reference; anything else is
pickled with every
tensor written as the reference writes its Tensors,
``{"__tensor__": True, "data": ndarray, "stop_gradient": bool}``, so a
file written by either package loads in the other.  A bfloat16 tensor's
array is an `ml_dtypes.bfloat16` array where that package is installed
(as JAX writes it); without it the array is float32 and the record
carries ``"dtype": "bfloat16"``, which `load` honours.  `load` puts the
tensors on `place` (default: `device.resolve_device(None)`), and loads an
inference directory with `load_inference`.
"""
import functools
import os
import pickle
import time
import types

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..nn.layer import Layer
from ..observability import compile_tracker as _ct
from ..tensor import Tensor
from . import dy2static
from .dy2static import convert_to_static
from .save_load import (InputSpec, TranslatedLayer, is_inference_dir,
                        load_inference, save_inference)
from .train_step import TrainStep, train_step

__all__ = ["InputSpec", "Layer", "StaticFunction", "Tensor", "TrainStep",
           "TranslatedLayer", "convert_to_static", "dy2static",
           "enable_to_static", "is_inference_dir", "load", "load_inference",
           "not_to_static", "save", "save_inference", "to_static",
           "train_step"]

_TO_STATIC_ENABLED = True
# the backend Dynamo hands each graph to; the CPU tests that check
# semantics alone set "aot_eager" (no Inductor code generation)
_BACKEND = "inductor"
# distinct programs a StaticFunction may compile before a call raises
# (Dynamo would otherwise run the frame eagerly past its limit)
_RECOMPILE_LIMIT = 64


def enable_to_static(flag: bool):
    """paddle.jit.enable_to_static parity: with False, to_static-wrapped
    callables run eagerly (useful for debugging converted control flow)."""
    global _TO_STATIC_ENABLED
    _TO_STATIC_ENABLED = bool(flag)


def _is_static_leaf(a):
    """Python values that gate control flow specialise the program (one
    compiled graph per distinct value) instead of being tensorized."""
    return a is None or isinstance(a, (bool, str, bytes))


def _own_code(fn):
    """fn with a code object of its own: Dynamo keeps its compiled graphs,
    and counts recompiles, per code object, so StaticFunctions built from
    one `def` must not share one."""
    g = types.FunctionType(fn.__code__.replace(), fn.__globals__,
                           fn.__name__, fn.__defaults__, fn.__closure__)
    g.__kwdefaults__ = fn.__kwdefaults__
    return g


def _graph_breaks():
    from torch._dynamo.utils import counters
    return sum(counters["graph_break"].values())


def _observed(err):
    """Did Dynamo stop because the traced code raised (an "observed"
    exception, which hides the user's own error)?  Other Dynamo errors
    (a graph break under fullgraph, the recompile limit) are raised as
    they are."""
    observed = torch._dynamo.exc.ObservedException
    return isinstance(err, observed) or isinstance(err.__cause__, observed)


class StaticFunction:
    """A Layer's forward (or a function) compiled by `torch.compile`.
    Attributes it does not have are read from the wrapped Layer
    (`parameters()`, `train()`, `eval()`, ...)."""

    def __init__(self, layer, fn=None, while_max_iters=None,
                 full_graph=True, input_spec=None):
        self._layer = layer
        self._fn = fn       # the function, when no Layer is wrapped
        self._while_max_iters = while_max_iters
        self._input_spec = input_spec
        self._graphs = 0
        if layer is not None:
            forward, _ = convert_to_static(type(layer).forward)

            def run(*args, **kwargs):
                return forward(layer, *args, **kwargs)

            self._label = f"to_static({type(layer).__name__})"
        else:
            run, _ = convert_to_static(fn)
            self._label = f"to_static_fn({getattr(fn, '__qualname__', '?')})"
            functools.update_wrapper(self, fn)
        self._target = run
        self._compiled = torch.compile(_own_code(run), backend=self._backend,
                                       fullgraph=bool(full_graph),
                                       dynamic=False)

    @property
    def layer(self):
        return self._layer

    def __getattr__(self, name):
        layer = self.__dict__.get("_layer")
        if layer is None or name.startswith("__"):
            raise AttributeError(name)
        return getattr(layer, name)

    def _backend(self, gm, example_inputs):
        self._graphs += 1
        from torch._dynamo import lookup_backend
        return lookup_backend(_BACKEND)(gm, example_inputs)

    def _signature(self, args, kwargs):
        flat, spec = pytree.tree_flatten((args, kwargs))
        tensors = [a for a in flat if isinstance(a, torch.Tensor)]
        static = tuple(a for a in flat if not isinstance(a, torch.Tensor))
        training = None if self._layer is None else self._layer.training
        return _ct.signature_of(tensors, static=(training, spec, static))

    def _eager(self, *args, **kwargs):
        if self._layer is not None:
            return self._layer(*args, **kwargs)
        return self._fn(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        if not _TO_STATIC_ENABLED:
            return self._eager(*args, **kwargs)
        tok = _ct.on_call(self._label, self._signature(args, kwargs),
                          owner=self)
        graphs, breaks, t0 = self._graphs, _graph_breaks(), \
            time.perf_counter()
        try:
            with dy2static.while_bound(self._while_max_iters), \
                    torch._dynamo.config.patch(
                        recompile_limit=_RECOMPILE_LIMIT,
                        fail_on_recompile_limit_hit=True):
                out = self._compiled(*args, **kwargs)
        except Exception as e:
            if tok is not None:
                _ct.abort(tok)
            if _observed(e):
                self._raise_conversion_error(e, args, kwargs)
            raise
        graphs, breaks = self._graphs - graphs, _graph_breaks() - breaks
        if tok is not None:
            _ct.finish(tok, cache_hit=graphs == 0, graphs=graphs,
                       graph_breaks=breaks)
        elif graphs:
            _ct.on_recompile(self._label, t0, graphs, breaks, owner=self)
        return out

    def _raise_conversion_error(self, err, args, kwargs):
        """Dynamo turned an exception of the traced code into its own:
        run the converted code once more in Python, its converters on the
        traced path (`dy2static.diagnosing`), so that an error of the
        conversion (a branch mismatch, an undefined name) is raised as
        the reference raises it.  Returns when that run raises nothing."""
        try:
            with dy2static.diagnosing(), \
                    dy2static.while_bound(self._while_max_iters), \
                    torch.no_grad():
                self._target(*args, **kwargs)
        except Exception as diag:
            raise diag from err


def to_static(function=None, input_spec=None, full_graph=True,
              while_max_iters=None, check=None, **kwargs):
    """Decorator/wrapper compiling a Layer or a function with
    `torch.compile` (see the module note).

    `while_max_iters`: bound converted tensor-dependent `while` loops to a
    fixed iteration count (a masked loop Dynamo unrolls), which makes them
    differentiable — unbounded `while_loop`s are forward-only.

    `check=True` runs the reference's tracelint analyzer, which the port
    does not have: it raises NotImplementedError."""
    if check:
        raise NotImplementedError(
            "to_static(check=True) runs tracelint (the reference's "
            "analysis/), which paddle_tpu_torch does not port; "
            "Dynamo's graph breaks are the port's findings "
            "(full_graph=True raises on one)")

    def wrap(target):
        if isinstance(target, torch.nn.Module):
            return StaticFunction(target, while_max_iters=while_max_iters,
                                  full_graph=full_graph,
                                  input_spec=input_spec)
        if callable(target):
            return StaticFunction(None, fn=target,
                                  while_max_iters=while_max_iters,
                                  full_graph=full_graph,
                                  input_spec=input_spec)
        raise TypeError(type(target))
    if function is not None:
        return wrap(function)
    return wrap


def not_to_static(fn):
    """Opt a function out of dy2static control-flow conversion
    (reference: paddle.jit.not_to_static)."""
    fn._paddle_not_to_static = True
    return fn


def _tensor_record(t):
    rec = {"__tensor__": True, "stop_gradient": not t.requires_grad}
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
            rec["data"] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        except ImportError:
            rec["data"] = t.float().numpy()
            rec["dtype"] = "bfloat16"
    else:
        rec["data"] = t.numpy()
    return rec


def _record_tensor(rec, device):
    data = np.asarray(rec["data"])
    if data.dtype.name == "bfloat16":      # an ml_dtypes array
        t = torch.from_numpy(data.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(data))
        if rec.get("dtype") == "bfloat16":
            t = t.to(torch.bfloat16)
    t = t.to(device)
    if not rec.get("stop_gradient", True) and t.is_floating_point():
        t.requires_grad_(True)
    return t


def save(obj, path, input_spec=None, **kwargs):
    """paddle.save / paddle.jit.save: a Layer with `input_spec` exports an
    inference program (`save_inference`; `aot=True` adds its AOTInductor
    package); anything else pickles as the reference does."""
    if isinstance(obj, StaticFunction):
        if obj.layer is None:
            raise TypeError("jit.save of a to_static function: wrap a Layer")
        obj = obj.layer
    if isinstance(obj, torch.nn.Module):
        if input_spec is None:
            raise ValueError("jit.save of a Layer requires input_spec")
        return save_inference(obj, path, input_spec,
                              aot=bool(kwargs.get("aot", False)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def conv(o):
        if isinstance(o, torch.Tensor):
            return _tensor_record(o)
        if isinstance(o, dict):
            return {k: conv(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(conv(v) for v in o)
        return o

    with open(path, "wb") as f:
        pickle.dump(conv(obj), f)


def load(path, **kwargs):
    """paddle.load / paddle.jit.load: an inference directory loads as a
    TranslatedLayer; a pickle comes back with its tensors on `place`."""
    if is_inference_dir(path):
        return load_inference(path)
    from ..device import resolve_device
    device = resolve_device(kwargs.get("place"))
    with open(path, "rb") as f:
        obj = pickle.load(f)

    def conv(o):
        if isinstance(o, dict):
            if o.get("__tensor__"):
                return _record_tensor(o, device)
            return {k: conv(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(conv(v) for v in o)
        return o

    return conv(obj)
