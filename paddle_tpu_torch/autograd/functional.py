"""paddle.grad / backward and the functional transforms (counterpart:
`paddle_tpu/autograd/functional.py:23-161`).

`backward` and `grad` run torch's autograd (`torch.autograd.backward`,
`torch.autograd.grad`) with the reference's defaults: a scalar output
gets an implicit ones seed (a non-scalar one raises), `None` inside
`grad_outputs` means that seed, `retain_graph` follows `create_graph`,
and an input the graph does not reach raises unless `allow_unused`.
`only_inputs` and `no_grad_vars` are taken and ignored, as the reference
takes and ignores them.  `jacobian`,
`hessian`, `jvp` and `vjp` are `torch.func`'s `jacrev`, `hessian`,
`jvp` and `vjp` over the function, returning detached results, with the
reference's argument handling (one input: no per-input tuple; `v`
defaults to ones).
"""
from __future__ import annotations

import torch
import torch.func


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _default_seed(t):
    if t.numel() != 1:
        raise RuntimeError(
            "grad can be implicitly created only for scalar outputs; "
            f"got shape {list(t.shape)}. Pass grad_outputs explicitly.")
    return torch.ones_like(t)


def _seeds(roots, grad_tensors):
    seeds = _as_list(grad_tensors)
    if not seeds:
        return [_default_seed(t) for t in roots]
    return [s if s is not None else _default_seed(r)
            for r, s in zip(roots, seeds)]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward — accumulate into .grad of leaves."""
    roots = _as_list(tensors)
    torch.autograd.backward(roots, _seeds(roots, grad_tensors),
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad — return grads of `outputs` wrt `inputs` without
    touching .grad."""
    roots = _as_list(outputs)
    wanted = _as_list(inputs)
    seeds = _seeds(roots, grad_outputs)
    if retain_graph is None:
        retain_graph = create_graph
    grads = torch.autograd.grad(
        roots, wanted, seeds, retain_graph=retain_graph,
        create_graph=create_graph, allow_unused=True)
    out = []
    for g in grads:
        if g is None and not allow_unused:
            raise RuntimeError(
                "one of the inputs was not used in the graph; "
                "set allow_unused=True to return None for it")
        out.append(g)
    return out


def _check_unsupported(create_graph, batch_axis):
    if create_graph:
        raise NotImplementedError(
            "create_graph=True is not supported: these transforms return "
            "detached results (compose torch.func transforms for higher "
            "order)")
    if batch_axis is not None:
        raise NotImplementedError(
            "batch_axis is not supported yet; vmap the function instead")


def _inputs(xs):
    return [x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(x)
            for x in _as_list(xs)]


def _detach(out):
    return torch.utils._pytree.tree_map(
        lambda t: t.detach() if isinstance(t, torch.Tensor) else t, out)


def _argnums(xs, n):
    return 0 if not isinstance(xs, (list, tuple)) else tuple(range(n))


def _fn(func):
    def f(*args):
        out = func(*args)
        return tuple(out) if isinstance(out, list) else out
    return f


def jacobian(func, xs, create_graph=False, batch_axis=None):
    """d func(xs) / d xs (reverse mode).  Returns a Tensor (single input &
    output) or a nested tuple matching (outputs, inputs)."""
    _check_unsupported(create_graph, batch_axis)
    args = _inputs(xs)
    jac = torch.func.jacrev(_fn(func), argnums=_argnums(xs, len(args)))(
        *args)
    return _detach(jac)


def hessian(func, xs, create_graph=False, batch_axis=None):
    """d^2 func(xs) / d xs^2 for scalar-output func."""
    _check_unsupported(create_graph, batch_axis)
    args = _inputs(xs)
    h = torch.func.hessian(_fn(func), argnums=_argnums(xs, len(args)))(
        *args)
    return _detach(h)


def jvp(func, xs, v=None):
    """Forward-mode: (func(xs), J @ v).  v defaults to ones."""
    args = _inputs(xs)
    tangents = [torch.ones_like(a) for a in args] if v is None else \
        _inputs(v)
    out, tan = torch.func.jvp(_fn(func), tuple(args), tuple(tangents))
    return _detach(out), _detach(tan)


def vjp(func, xs, v=None):
    """Reverse-mode: (func(xs), v^T @ J).  v defaults to ones."""
    args = _inputs(xs)
    out, pullback = torch.func.vjp(_fn(func), *args)
    if v is None:
        cot = torch.utils._pytree.tree_map(torch.ones_like, out)
    else:
        vs = _inputs(v)
        cot = vs[0] if not isinstance(out, tuple) else tuple(vs)
    grads = pullback(cot)
    if not isinstance(xs, (list, tuple)):
        grads = grads[0]
    return _detach(out), _detach(grads)
