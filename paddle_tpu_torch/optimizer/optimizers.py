"""Momentum, Adam, AdamW and Adafactor.

Counterpart: `paddle_tpu/optimizer/optimizers.py` — `Momentum` (`:18-35`),
`Adam` (`:113-131`), `AdamW` (`:134-145`) and `Adafactor` (`:190-237`),
with the same rules on
float32 tensors.  Scalars that the JAX rules compute in float32 (the
bias corrections 1 - beta ** step, Adafactor's decay 1 - step ** -rate)
are rounded to float32 here too.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer, f32


class Momentum(Optimizer):
    """Heavy-ball momentum: v = momentum * v + g, then p - lr * v (or,
    with `use_nesterov`, p - lr * (g + momentum * v)); weight decay is
    coupled L2 (g + wd * p)."""
    SLOTS = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         **kw)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _rule(self, g, p, slots, lr, step):
        v = self._momentum * slots["velocity"] + g
        slots["velocity"] = v
        if self._nesterov:
            return p - lr * (g + self._momentum * v), slots
        return p - lr * v, slots


class Adam(Optimizer):
    """Adam; `lazy_mode` is taken and changes nothing (the JAX package's
    `:118` does the same: every gradient here is dense)."""
    SLOTS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision=multi_precision, **kw)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _rule(self, g, p, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g.square()
        mhat = m / f32(1 - np.float32(b1) ** np.float32(step))
        vhat = v / f32(1 - np.float32(b2) ** np.float32(step))
        slots["moment1"], slots["moment2"] = m, v
        return p - lr * mhat / (vhat.sqrt() + self._eps), slots


class AdamW(Adam):
    """Adam with decoupled weight decay (`new_p - lr * wd * p` after the
    rule, for the names `apply_decay_param_fun` accepts).  `lr_ratio` is
    taken and changes nothing, as in the JAX package (`:141`)."""
    _couple_decay = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, apply_decay_param_fun=None,
                 multi_precision=False, lr_ratio=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         apply_decay_param_fun=apply_decay_param_fun,
                         multi_precision=multi_precision, **kw)


class Adafactor(Optimizer):
    """Factored second moments: a matrix (or stack of matrices) keeps a row
    mean `vr` (over the last axis) and a column mean `vc` (over the one
    before) of g**2 instead of a full second moment.

    Layout trap: the JAX package keeps a Linear weight as [in, out] and
    torch as [out, in], so for a Linear weight the port's `vr` is the
    reference's `vc` and the other way round.  The update is the same in
    exact arithmetic, because it reads the two only through
    vr / mean(vr) times vc, and mean(vr) = mean(vc) = mean(g**2).
    `weights.load_paddle_tpu_optimizer_state` swaps them when it carries a
    JAX state across."""
    SLOTS = ()

    def __init__(self, learning_rate=0.001, beta1=None, decay_rate=0.8,
                 epsilon1=1e-30, epsilon2=1e-3, clip_threshold=1.0,
                 parameters=None, weight_decay=None, grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         **kw)
        self._beta1 = beta1
        self._decay_rate = decay_rate
        self._eps1, self._eps2 = epsilon1, epsilon2
        self._clip_t = clip_threshold

    def _init_state_for(self, p):
        kw = dict(dtype=torch.float32, device=p.device)
        slots = {}
        if p.dim() >= 2:
            slots["vr"] = torch.zeros(p.shape[:-1], **kw)
            slots["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)
        else:
            slots["v"] = torch.zeros(p.shape, **kw)
        if self._beta1 is not None:
            slots["m"] = torch.zeros(p.shape, **kw)
        return slots

    def _rule(self, g, p, slots, lr, step):
        rho = f32(1.0 - np.float32(step) ** np.float32(-self._decay_rate))
        g2 = g.square() + self._eps1
        if "vr" in slots:
            vr = rho * slots["vr"] + (1 - rho) * g2.mean(dim=-1)
            vc = rho * slots["vc"] + (1 - rho) * g2.mean(dim=-2)
            slots["vr"], slots["vc"] = vr, vc
            r = vr / vr.mean(dim=-1, keepdim=True).clamp(min=1e-30)
            update = g / (r.sqrt()[..., None] * vc.sqrt()[..., None, :])
        else:
            v = rho * slots["v"] + (1 - rho) * g2
            slots["v"] = v
            update = g / v.sqrt()
        rms = update.square().mean().sqrt()
        update = update / torch.clamp(rms / self._clip_t, min=1.0)
        if self._beta1 is not None:
            m = self._beta1 * slots["m"] + (1 - self._beta1) * update
            slots["m"] = m
            update = m
        scale = torch.clamp(p.square().mean().sqrt(), min=self._eps2)
        return p - lr * scale * update, slots
