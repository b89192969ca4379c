"""Carry weights from the JAX package into the port.

`load_paddle_tpu_state(model, arrays)` takes the `{name: np.ndarray}`
that a `paddle_tpu` model's `state_dict()` gives (each value through
`np.asarray`) and copies it into the port's model of the same
architecture, name for name.  The JAX package keeps a Linear weight as
[in, out] (`paddle_tpu/nn/common.py::Linear`); `torch.nn.Linear` keeps
[out, in], so those weights are transposed on the way.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def load_paddle_tpu_state(model, arrays):
    """Copy `arrays` into `model`'s parameters and buffers, converting to
    each tensor's dtype and device.  Raises KeyError on a missing or an
    unexpected name and ValueError on a shape mismatch.  Returns model."""
    linear = {f"{name}.weight" for name, mod in model.named_modules()
              if isinstance(mod, nn.Linear)}
    state = model.state_dict()
    missing = sorted(set(state) - set(arrays))
    unexpected = sorted(set(arrays) - set(state))
    if missing or unexpected:
        raise KeyError(f"state names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, dst in state.items():
        src = np.asarray(arrays[name])
        if name in linear:
            src = src.T
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} does not "
                             f"fit {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(src)))   # a writable copy
    return model
