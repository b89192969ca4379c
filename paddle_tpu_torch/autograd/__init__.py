"""Autograd public API (counterpart: `paddle_tpu/autograd/__init__.py`):
torch's autograd under the reference's names.  `grad_enabled` is
`torch.is_grad_enabled`, `saved_tensors_hooks` torch's
`autograd.graph.saved_tensors_hooks`, and `run_backward` the reference
engine's entry (roots, their seeds) over `torch.autograd`."""
import torch
from torch import enable_grad, no_grad, set_grad_enabled  # noqa: F401
from torch import is_grad_enabled as grad_enabled  # noqa: F401
from torch.autograd.graph import saved_tensors_hooks  # noqa: F401

from . import functional  # noqa: F401
from .functional import backward, grad  # noqa: F401
from .functional import hessian, jacobian, jvp, vjp  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401

__all__ = ["PyLayer", "PyLayerContext", "backward", "enable_grad",
           "functional", "grad", "grad_enabled", "hessian", "jacobian",
           "jvp", "no_grad", "run_backward", "saved_tensors_hooks",
           "set_grad_enabled", "vjp"]


def run_backward(roots, root_grads, retain_graph=False, create_graph=False,
                 accumulate_into_grad=True, wanted=None):
    """The reference engine's walk: with `accumulate_into_grad`, add the
    gradients of `roots` (seeded by `root_grads`) into the leaves'
    `.grad`; else return the gradients of `wanted` (None where unused)."""
    if accumulate_into_grad:
        torch.autograd.backward(list(roots), list(root_grads),
                                retain_graph=retain_graph,
                                create_graph=create_graph)
        return None
    return list(torch.autograd.grad(
        list(roots), list(wanted), list(root_grads),
        retain_graph=retain_graph, create_graph=create_graph,
        allow_unused=True))
