"""The training step, inference export and `save` / `load` of the port
(counterpart: `paddle_tpu/jit`).

`save` / `load` (`paddle_tpu/jit/__init__.py:350-397`; the top-level
`paddle_tpu_torch.save` / `load` too): a Layer (a `torch.nn.Module`)
with an `input_spec` goes to `save_inference`, and without one raises
ValueError, as in the reference; anything else is pickled with every
tensor written as the reference writes its Tensors,
``{"__tensor__": True, "data": ndarray, "stop_gradient": bool}``, so a
file written by either package loads in the other.  A bfloat16 tensor's
array is an `ml_dtypes.bfloat16` array where that package is installed
(as JAX writes it); without it the array is float32 and the record
carries ``"dtype": "bfloat16"``, which `load` honours.  `load` puts the
tensors on `place` (default: `device.resolve_device(None)`), and loads an
inference directory with `load_inference`.
"""
import os
import pickle

import numpy as np
import torch

from .save_load import (InputSpec, TranslatedLayer, is_inference_dir,
                        load_inference, save_inference)
from .train_step import TrainStep, train_step

__all__ = ["InputSpec", "TrainStep", "TranslatedLayer", "is_inference_dir",
           "load", "load_inference", "save", "save_inference", "train_step"]


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
