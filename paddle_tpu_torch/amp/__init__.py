"""Automatic mixed precision: pure low-precision training (AMP O2).

Counterpart: `paddle_tpu/amp/__init__.py::decorate` (`:64-98`).  O2 casts
every floating parameter to the target dtype; the optimizer keeps float32
master copies unless `master_weight=False`.  `GradScaler` scales the loss
of float16 training (`amp/grad_scaler.py`).  `auto_cast` (O1, per-op
casting) needs a dispatch-time cast policy that matches the JAX allow
and deny lists, which the port does not have yet: it stays refused.
"""
from __future__ import annotations

import torch

from .grad_scaler import AmpScaler, GradScaler

__all__ = ["AmpScaler", "GradScaler", "decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


@torch.no_grad()
def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None):
    """Cast the floating parameters of `models` to `dtype` IN PLACE (each
    Parameter keeps its identity, so an optimizer built before keeps
    pointing at it).  `master_weight` None or True turns the optimizers'
    float32 master copies on (`:94-96`); only False leaves them off.
    Returns (models, optimizers) as given (a single model, or a list), or
    models alone when `optimizers` is None."""
    if level != "O2":
        raise NotImplementedError(
            f"amp.decorate level {level!r}: the port has O2 only (auto_cast "
            f"O1 is a later slice)")
    target = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for m in model_list:
        if m is None:
            continue
        for p in m.parameters():
            if p.is_floating_point():
                p.data = p.data.to(target)
    if optimizers is None:
        return models if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    for o in opt_list:
        if o is not None and master_weight is not False:
            o._use_master_weights = True
    return (models if single else model_list,
            optimizers if opt_single else opt_list)
