"""The Layer base class (counterpart: `paddle_tpu/nn/layer.py`).

`Layer` is a `torch.nn.Module` with the JAX package's methods beside
torch's own.  A layer made from it is a module in every respect
(`TrainStep`, the optimizers, `clip_grad_norm_`, `state_dict`,
`load_paddle_tpu_state` take it as they take any module), and it also
answers Paddle's calls:

* `create_parameter(shape, attr, dtype, is_bias, default_initializer)`
  makes a `torch.nn.Parameter`, filled by the attr's initializer, else
  `default_initializer`, else Constant(0) for a bias and XavierUniform
  otherwise; a `framework.ParamAttr` then stamps its name, `trainable`
  and learning rate on it.  `add_parameter` and `add_sublayer` register;
* `register_buffer(name, tensor, persistable=True)` (torch's
  `persistent=` too): a non-persistable buffer stays out of
  `state_dict`;
* `sublayers` / `named_sublayers`, `parameters(include_sublayers=)` and
  `buffers(include_sublayers=)` (lists, as the JAX package returns;
  torch's `recurse=` is taken too);
* `set_state_dict` (alias `load_dict`), `to(device=, dtype=)` with
  Paddle's dtype names, `astype`, `apply` (each layer before its
  sublayers), `clear_gradients`, `full_name`;
* `register_forward_pre_hook` / `register_forward_post_hook` (torch's
  forward hooks; the handle's `remove()` takes them off).

Parameters are made on `device` (a layer's `device=` argument; None:
`device.resolve_device(None)`, the current CUDA device, raising when
there is none) and drawn from `generator` (None: the device's default
generator), the two keyword arguments every port layer takes beside the
reference's.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import device as _device

_DTYPE_NAMES = {"float32": torch.float32, "float64": torch.float64,
                "float16": torch.float16, "bfloat16": torch.bfloat16,
                "int64": torch.int64, "int32": torch.int32,
                "int16": torch.int16, "int8": torch.int8,
                "uint8": torch.uint8, "bool": torch.bool,
                "complex64": torch.complex64,
                "complex128": torch.complex128}


def convert_dtype(dtype):
    """A torch dtype from a torch dtype or a Paddle dtype name."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("paddle.", "").replace("torch.", "")
    if name not in _DTYPE_NAMES:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _DTYPE_NAMES[name]


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32", device=None,
                 generator=None):
        super().__init__()
        self._dtype = convert_dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()
        self._place = device
        self._generator = generator

    # ------------------------------------------------------------- creation
    def _resolved_device(self, device=None):
        return _device.resolve_device(device if device is not None
                                      else self._place)

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, transposed=False,
                         device=None, generator=None):
        """A Parameter of `shape` (the JAX package's layout).  With
        `transposed` (a 2-D Linear weight) it is stored as shape[::-1]
        and marked, so that initializers fill its [in, out] view."""
        from . import initializer as I
        init = getattr(attr, "initializer", None) or default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierUniform()
        shape = [int(s) for s in shape]
        store = shape[::-1] if transposed else shape
        p = nn.Parameter(torch.empty(
            store, dtype=convert_dtype(dtype) or self._dtype,
            device=self._resolved_device(device)))
        if transposed:
            p._paddle_transposed = True
        init(p, generator if generator is not None else self._generator)
        if hasattr(attr, "apply_to"):
            attr.apply_to(p)
        return p

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    nn.Parameter):
            parameter = nn.Parameter(parameter)
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    # ------------------------------------------------------------ traversal
    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """(name, layer) of every sublayer, depth first, each once."""
        seen = set() if layers_set is None else layers_set
        for name, layer in self.named_modules(prefix=prefix):
            if id(layer) in seen or (layer is self and not include_self):
                continue
            seen.add(id(layer))
            yield name, layer

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(
            include_self=include_self)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def parameters(self, include_sublayers=True, recurse=None):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True,
                      recurse=None, remove_duplicate=True):
        return super().named_buffers(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    # ----------------------------------------------------------- state dict
    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy the values of `state_dict` (tensors or arrays, in this
        layer's layout) into the matching parameters and buffers, cast to
        their dtypes; returns (missing, unexpected) names."""
        own = self.state_dict(keep_vars=True)
        unexpected = [k for k in state_dict if k not in own]
        for k, v in state_dict.items():
            if k in own:
                src = v if isinstance(v, torch.Tensor) else \
                    torch.from_numpy(np.array(v))
                own[k].copy_(src.to(own[k].dtype).reshape(own[k].shape))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict

    # -------------------------------------------------------------- running
    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def to(self, device=None, dtype=None, blocking=None, *args, **kwargs):
        """torch's `to`, with Paddle's dtype names and `blocking`."""
        if isinstance(device, (str, torch.dtype)) and dtype is None and \
                (isinstance(device, torch.dtype)
                 or device.replace("paddle.", "") in _DTYPE_NAMES):
            device, dtype = None, device
        if dtype is not None:
            kwargs["dtype"] = convert_dtype(dtype)
        if blocking is not None:
            kwargs["non_blocking"] = not blocking
        args = ((device,) if device is not None else ()) + args
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def clear_gradients(self):
        self.zero_grad(set_to_none=True)

    def full_name(self):
        return self._name_scope

    # ---------------------------------------------------------------- hooks
    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, output) after each forward; a non-None
        return replaces the output."""
        return self.register_forward_hook(hook)
