"""paddle.base / paddle.fluid compatibility aliases (counterpart:
`paddle_tpu/base.py`; reference: python/paddle/base/__init__.py — the
legacy namespace a decade of Paddle user code imports from).

Everything here is a re-export of the modern surface; dygraph guards are
no-ops because eager IS the default mode.  `is_compiled_with_cuda` is
torch's (True for a CUDA build), where the JAX package says False.
"""
from __future__ import annotations

import contextlib

from .device import CPUPlace, Place, TPUPlace  # noqa: F401
from .device import is_compiled_with_cuda as _compiled_with_cuda
from .framework.param_attr import ParamAttr  # noqa: F401
from .framework.static_graph import (  # noqa: F401
    Executor, Program, default_main_program, default_startup_program,
    program_guard,
)

CUDAPlace = TPUPlace      # the card's place
CUDAPinnedPlace = CPUPlace
XPUPlace = TPUPlace


def is_compiled_with_cuda():
    return _compiled_with_cuda()


class dygraph:
    """fluid.dygraph compatibility: eager mode is always on."""

    @staticmethod
    @contextlib.contextmanager
    def guard(place=None):
        yield

    @staticmethod
    def to_variable(value, name=None, zero_copy=None):
        from .api import to_tensor
        return to_tensor(value)


class layers:
    """fluid.layers compatibility: the handful of names old code reaches
    for, mapped onto nn.functional."""

    @staticmethod
    def fc(input, size, act=None, name=None):
        from .static import nn as static_nn
        return static_nn.fc(input, size, activation=act, name=name)

    @staticmethod
    def relu(x):
        from .nn import functional as F
        return F.relu(x)

    @staticmethod
    def softmax(x, axis=-1):
        from .nn import functional as F
        return F.softmax(x, axis=axis)

    @staticmethod
    def cross_entropy(input, label, soft_label=False, ignore_index=-100):
        from .nn import functional as F
        return F.cross_entropy(input, label, soft_label=soft_label,
                               ignore_index=ignore_index,
                               reduction="none")

    @staticmethod
    def reduce_mean(x, dim=None, keep_dim=False):
        return x.mean() if dim is None else x.mean(dim=dim,
                                                   keepdim=keep_dim)

    @staticmethod
    def data(name, shape, dtype="float32", lod_level=0):
        from .framework.static_graph import data as _data
        return _data(name, shape, dtype, lod_level)


def create_lod_tensor(*a, **kw):
    raise NotImplementedError(
        "LoD tensors are a legacy variable-length encoding; use padded "
        "tensors + sequence_mask (paddle_tpu_torch.nn.functional."
        "sequence_mask)")
