"""nn.utils (counterpart: `paddle_tpu/nn/utils_mod.py`).

`clip_grad_norm_` clips by the float32 norm of every gradient, its
`norm_type` taken and unused (2-norm), as the JAX function does.
`weight_norm` reparameterises `name` as `name_g` * `name_v` / |`name_v`|
(the norm over every dim but `dim`, on the port's own tensor layout)
recomputed by a forward pre-hook; `remove_weight_norm` folds it back.
`spectral_norm` returns the layer unchanged, as the JAX function does
(`SpectralNorm` is the layer that normalises a weight).
"""
from __future__ import annotations

import torch
from torch import nn


def parameters_to_vector(parameters):
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters):
    offset = 0
    for p in parameters:
        n = p.numel()
        p.copy_(vec[offset:offset + n].reshape(p.shape).to(p.dtype))
        offset += n


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0):
    """Scale every gradient by min(max_norm / max(total, 1e-6), 1); returns
    the total norm (float32)."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    total = torch.stack([g.float().square().sum() for g in grads]).sum() \
        .sqrt()
    scale = torch.clamp(max_norm / total.clamp(min=1e-6), max=1.0)
    for g in grads:
        g.copy_(g * scale)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    for p in parameters:
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)


def _norm_except(v, dim):
    dims = [d for d in range(v.dim()) if d != dim]
    return torch.linalg.vector_norm(v, dim=dims, keepdim=True)


def weight_norm(layer, name="weight", dim=0):
    w = getattr(layer, name)
    del layer._parameters[name]
    layer.register_parameter(name + "_g", nn.Parameter(
        _norm_except(w.detach(), dim).reshape(-1).clone()))
    layer.register_parameter(name + "_v", nn.Parameter(w.detach().clone()))

    def hook(l, inputs):
        v, g = getattr(l, name + "_v"), getattr(l, name + "_g")
        shape = [1] * v.dim()
        shape[dim] = -1
        setattr(l, name, v / _norm_except(v, dim) * g.reshape(shape))

    hook(layer, None)
    layer._weight_norm = (name, dim, layer.register_forward_pre_hook(hook))
    return layer


def remove_weight_norm(layer, name="weight"):
    wn = getattr(layer, "_weight_norm", None)
    if wn is None or wn[0] != name:
        return layer
    _, dim, handle = wn
    handle.remove()
    v, g = getattr(layer, name + "_v"), getattr(layer, name + "_g")
    shape = [1] * v.dim()
    shape[dim] = -1
    w = (v / _norm_except(v, dim) * g.reshape(shape)).detach()
    del layer._parameters[name + "_g"], layer._parameters[name + "_v"]
    delattr(layer, name)
    layer.register_parameter(name, nn.Parameter(w))
    del layer._weight_norm
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12):
    return layer
