"""PyLayer: user-defined forward/backward (counterpart:
`paddle_tpu/autograd/py_layer.py:13-88`), over `torch.autograd.Function`.

`PyLayer.apply(*args)` runs the user's `forward(ctx, *args)` without
recording its ops and installs the user's `backward(ctx, *grads)` as the
node's backward, which returns one gradient per tensor input (Paddle's
convention: None for an input that gets none).  `ctx` is a
`PyLayerContext` with the reference's API — `save_for_backward(*t)`,
`saved_tensor()`, and `saved_extras` for anything else — plus Paddle's
`mark_non_differentiable(*t)`, `mark_dirty(*t)` and
`set_materialize_grads(v)`, passed on to torch's context.
"""
from __future__ import annotations

import torch


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.saved_extras = {}
        self._fn_ctx = None

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved

    def mark_non_differentiable(self, *tensors):
        self._fn_ctx.mark_non_differentiable(*tensors)

    def mark_dirty(self, *tensors):
        self._fn_ctx.mark_dirty(*tensors)

    def set_materialize_grads(self, value):
        self._fn_ctx.set_materialize_grads(value)


class PyLayerMeta(type):
    def __init__(cls, name, bases, ns):
        super().__init__(name, bases, ns)


class _Bridge(torch.autograd.Function):
    """One torch Function for every PyLayer: the user's class and context
    ride along as the first arguments."""

    @staticmethod
    def forward(fn_ctx, cls, ctx, n_args, *flat):
        ctx._fn_ctx = fn_ctx
        fn_ctx.pl_ctx, fn_ctx.cls = ctx, cls
        args, kwargs = flat[:n_args], dict(flat[n_args])
        fn_ctx.tensor_slots = [i for i, a in enumerate(flat)
                               if isinstance(a, torch.Tensor)]
        return cls.forward(ctx, *args, **kwargs)

    @staticmethod
    def backward(fn_ctx, *grads):
        g = fn_ctx.cls.backward(fn_ctx.pl_ctx, *grads)
        g = g if isinstance(g, (tuple, list)) else (g,)
        out = [None] * (len(fn_ctx.needs_input_grad) - 3)
        for slot, gi in zip(fn_ctx.tensor_slots, g):
            out[slot] = gi
        return (None, None, None) + tuple(out)


class PyLayer(metaclass=PyLayerMeta):
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        return _Bridge.apply(cls, ctx, len(args), *args,
                             tuple(kwargs.items()))
