"""The update rules: SGD, Momentum, Adagrad, RMSProp, Adadelta, Adam,
AdamW, Lamb, Adamax, Adafactor, NAdam, RAdam, ASGD, Rprop and LBFGS.

Counterpart: `paddle_tpu/optimizer/optimizers.py` (`SGD` `:11`,
`Momentum` `:18`, `Adagrad` `:39`, `RMSProp` `:60`, `Adadelta` `:92`,
`Adam` `:113`, `AdamW` `:134`, `Lamb` `:148`, `Adamax` `:172`,
`Adafactor` `:190`, `NAdam` `:240`, `RAdam` `:277`, `ASGD` `:315`,
`Rprop` `:349`, `LBFGS` `:384`), with the same rules, slot names and
state-dict keys, on float32 tensors.  Scalars that the JAX rules compute
in float32 from the float32 step (bias corrections 1 - beta ** step,
Adafactor's decay 1 - step ** -rate, NAdam's momentum schedule, RAdam's
rectification) are computed in float32 on the host here.  `lr` is a
float or a 0-dim float32 tensor (`Optimizer.update`); `_mul` / `_div`
keep a float rate's products in float32 as the JAX rules do.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer, f32


def _mul(lr, c):
    """lr * c in float32 (c a host float32 scalar)."""
    if isinstance(lr, torch.Tensor):
        return lr * f32(c)
    return f32(np.float32(lr) * np.float32(c))


def _div(lr, c):
    """lr / c in float32 (c a host float32 scalar)."""
    if isinstance(lr, torch.Tensor):
        return lr / f32(c)
    return f32(np.float32(lr) / np.float32(c))


def _loss(x):
    """A closure's loss as a float (detached first)."""
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


def _bias(beta, step):
    """1 - beta ** step in float32, as `1 - jnp.power(beta, step)`."""
    return f32(np.float32(1) - np.float32(beta) ** np.float32(step))


class SGD(Optimizer):
    """p - lr * g; weight decay coupled (g + wd * p)."""
    SLOTS = ()

    def _rule(self, g, p, slots, lr, step):
        return p - lr * g, slots


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
        mhat = m / _bias(b1, step)
        vhat = v / _bias(b2, step)
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


class Adagrad(Optimizer):
    """moment += g ** 2; p - lr * g / (sqrt(moment) + epsilon); the
    moment starts at `initial_accumulator_value`."""
    SLOTS = ("moment",)

    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         **kw)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state_for(self, p):
        return {"moment": torch.full(p.shape, float(self._init_acc),
                                     dtype=torch.float32, device=p.device)}

    def _rule(self, g, p, slots, lr, step):
        m = slots["moment"] + g.square()
        slots["moment"] = m
        return p - lr * g / (m.sqrt() + self._eps), slots


class RMSProp(Optimizer):
    """mean_square = rho * ms + (1 - rho) * g ** 2 (centered: minus the
    square of a mean gradient kept alike); moment = momentum * moment +
    lr * g / sqrt(denominator + epsilon); p - moment."""
    SLOTS = ("mean_square", "moment")

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         **kw)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state_for(self, p):
        slots = super()._init_state_for(p)
        if self._centered:
            slots["mean_grad"] = torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
        return slots

    def _rule(self, g, p, slots, lr, step):
        rho = self._rho
        ms = rho * slots["mean_square"] + (1 - rho) * g.square()
        slots["mean_square"] = ms
        denom = ms
        if self._centered:
            mg = rho * slots["mean_grad"] + (1 - rho) * g
            slots["mean_grad"] = mg
            denom = ms - mg.square()
        mom = self._momentum * slots["moment"] + \
            lr * g / (denom + self._eps).sqrt()
        slots["moment"] = mom
        return p - mom, slots


class Adadelta(Optimizer):
    """Update sqrt(avg_sq_update + eps) / sqrt(avg_sq_grad + eps) * g,
    both averages decayed by rho; p - lr * update."""
    SLOTS = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         **kw)
        self._rho, self._eps = rho, epsilon

    def _rule(self, g, p, slots, lr, step):
        rho = self._rho
        ag = rho * slots["avg_squared_grad"] + (1 - rho) * g.square()
        upd = (slots["avg_squared_update"] + self._eps).sqrt() / \
            (ag + self._eps).sqrt() * g
        au = rho * slots["avg_squared_update"] + (1 - rho) * upd.square()
        slots["avg_squared_grad"], slots["avg_squared_update"] = ag, au
        return p - lr * upd, slots


class Lamb(Optimizer):
    """Adam's direction plus `lamb_weight_decay` * p, scaled by the trust
    ratio ||p|| / ||r|| (1 where either norm is 0).  The global
    `weight_decay` is not taken: the decay is the rule's own."""
    SLOTS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, **kw)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_decay = lamb_weight_decay

    def _rule(self, g, p, slots, lr, step):
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment1"] + (1 - b1) * g
        v = b2 * slots["moment2"] + (1 - b2) * g.square()
        mhat = m / _bias(b1, step)
        vhat = v / _bias(b2, step)
        r = mhat / (vhat.sqrt() + self._eps) + self._lamb_decay * p
        w_norm = torch.linalg.vector_norm(p)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        slots["moment1"], slots["moment2"] = m, v
        return p - lr * trust * r, slots


class Adamax(Optimizer):
    """moment as Adam's first; inf_norm = max(beta2 * inf_norm, |g|);
    p - lr / (1 - beta1 ** step) * moment / (inf_norm + epsilon)."""
    SLOTS = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         **kw)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _rule(self, g, p, slots, lr, step):
        m = self._beta1 * slots["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * slots["inf_norm"], g.abs())
        slots["moment"], slots["inf_norm"] = m, u
        lr_t = _div(lr, _bias(self._beta1, step))
        return p - lr_t * m / (u + self._eps), slots


class NAdam(Optimizer):
    """Adam with Nesterov momentum under the mu-product schedule (Dozat
    2016): mu_t = beta1 * (1 - 0.5 * 0.96 ** (step * momentum_decay));
    `mu_product` is a 0-dim slot."""
    SLOTS = ("moment1", "moment2", "mu_product")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         **kw)
        self._b1, self._b2 = beta1, beta2
        self._eps = epsilon
        self._psi = momentum_decay

    def _init_state_for(self, p):
        kw = dict(dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros(p.shape, **kw),
                "moment2": torch.zeros(p.shape, **kw),
                "mu_product": torch.ones((), **kw)}

    def _rule(self, g, p, slots, lr, step):
        b1, b2 = self._b1, self._b2
        one, s = np.float32(1), np.float32(step)
        psi, half = np.float32(self._psi), np.float32(0.5)
        mu_t = np.float32(b1) * (one - half * np.float32(0.96) ** (s * psi))
        mu_t1 = np.float32(b1) * (
            one - half * np.float32(0.96) ** ((s + one) * psi))
        mu_prod = slots["mu_product"] * f32(mu_t)
        m = b1 * slots["moment1"] + (1.0 - b1) * g
        v = b2 * slots["moment2"] + (1.0 - b2) * g.square()
        m_hat = (f32(mu_t1) * m / (1.0 - mu_prod * f32(mu_t1))
                 + f32(one - mu_t) * g / (1.0 - mu_prod))
        v_hat = v / _bias(b2, step)
        slots["moment1"], slots["moment2"] = m, v
        slots["mu_product"] = mu_prod
        return p - lr * m_hat / (v_hat.sqrt() + self._eps), slots


class RAdam(Optimizer):
    """Rectified Adam (Liu et al. 2020): the adaptive update scaled by the
    variance rectification r where rho_t > 5, the bias-corrected
    momentum alone before."""
    SLOTS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         **kw)
        self._b1, self._b2 = beta1, beta2
        self._eps = epsilon

    def _rule(self, g, p, slots, lr, step):
        b1, b2 = self._b1, self._b2
        m = b1 * slots["moment1"] + (1.0 - b1) * g
        v = b2 * slots["moment2"] + (1.0 - b2) * g.square()
        slots["moment1"], slots["moment2"] = m, v
        m_hat = m / _bias(b1, step)
        # the JAX rule's scalars: rho_inf a Python float (rounded to
        # float32 where it meets the float32 step), the rest float32
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        s = np.float32(step)
        beta2_t = np.float32(b2) ** s
        rho_t = np.float32(rho_inf) - np.float32(2.0) * s * beta2_t / (
            np.float32(1.0) - beta2_t)
        num = (rho_t - np.float32(4.0)) * (rho_t - np.float32(2.0)) * \
            np.float32(rho_inf)
        den = max(np.float32((rho_inf - 4.0) * (rho_inf - 2.0)) * rho_t,
                  np.float32(1e-9))
        r = np.sqrt(max(num / den, np.float32(0.0)))
        if rho_t > 5.0:
            v_hat = (v / f32(np.float32(1.0) - beta2_t)).sqrt() + self._eps
            upd = _mul(lr, r) * m_hat / v_hat
        else:
            upd = lr * m_hat
        return p - upd, slots


class ASGD(Optimizer):
    """Averaged SGD: each step applies the average of the last
    `batch_num` gradients, kept in a ring buffer `grad_buffer` [batch_num,
    *shape] (batch_num copies of every parameter, as in the reference):
    d += g - buffer[idx]; p - lr * d / min(step, batch_num)."""
    SLOTS = ("d", "grad_buffer")

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         **kw)
        self._batch_num = int(batch_num)

    def _init_state_for(self, p):
        kw = dict(dtype=torch.float32, device=p.device)
        return {"d": torch.zeros(p.shape, **kw),
                "grad_buffer": torch.zeros((self._batch_num,) + p.shape,
                                           **kw)}

    def _rule(self, g, p, slots, lr, step):
        n = self._batch_num
        idx = (int(step) - 1) % n
        buf = slots["grad_buffer"]
        d = slots["d"] + g - buf[idx]
        slots["d"] = d
        buf[idx] = g      # in place: the ring slot is read above
        return p - lr * d / float(min(step, n)), slots


class Rprop(Optimizer):
    """Resilient backpropagation: per-weight step sizes grow by etas[1]
    while the gradient keeps its sign and shrink by etas[0] when it
    flips (that weight then rests a step), clipped to
    `learning_rate_range`; p - step * sign(g).  The step sizes start at
    `learning_rate` (0.001 when it is a scheduler)."""
    SLOTS = ("prev_grad", "learning_rate")

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, weight_decay=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         **kw)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_minus, self._eta_plus = etas

    def _init_state_for(self, p):
        lr0 = float(self._lr if isinstance(self._lr, (int, float))
                    else 0.001)
        kw = dict(dtype=torch.float32, device=p.device)
        return {"prev_grad": torch.zeros(p.shape, **kw),
                "learning_rate": torch.full(p.shape, lr0, **kw)}

    def _rule(self, g, p, slots, lr, step):
        sign = (g * slots["prev_grad"]).sign()
        one = torch.ones((), dtype=g.dtype, device=g.device)
        scale = torch.where(sign > 0, self._eta_plus * one,
                            torch.where(sign < 0, self._eta_minus * one,
                                        one))
        step_size = (slots["learning_rate"] * scale).clamp(self._lr_min,
                                                           self._lr_max)
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        slots["prev_grad"], slots["learning_rate"] = g_eff, step_size
        return p - step_size * g_eff.sign(), slots


class LBFGS(Optimizer):
    """Limited-memory BFGS with the optional strong-Wolfe line search,
    driven by a closure:

        def closure():
            opt.clear_grad()
            loss = loss_fn(model(x), y)
            loss.backward()
            return loss
        opt.step(closure)

    Eager only, as in the JAX package: the line search calls the closure
    a data-dependent number of times and reads each loss and directional
    derivative on the host.  The vectors stay on the parameters' device.
    The curvature history is the state: `state_dict` holds it under the
    reference's "__lbfgs__/..." keys."""
    SLOTS = ()

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         **kw)
        self._max_iter = max_iter
        self._max_eval = max_eval if max_eval is not None \
            else max_iter * 5 // 4
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._hist = history_size
        self._line_search = line_search_fn
        if any(w is not None for w in self._wd_overrides) or \
                any(s != 1.0 for s in self._lr_scales):
            raise ValueError(
                "LBFGS does not support parameter groups with per-group "
                "learning_rate/weight_decay (flat-vector optimizer)")
        self._state_lb = {"s": [], "y": [], "rho": [], "prev_loss": None}

    def state_dict(self):
        out = super().state_dict()
        lb = self._state_lb
        for i, (s, y, rho) in enumerate(zip(lb["s"], lb["y"], lb["rho"])):
            out[f"__lbfgs__/s{i}"] = s
            out[f"__lbfgs__/y{i}"] = y
            out[f"__lbfgs__/rho{i}"] = torch.tensor(rho, dtype=torch.float32)
        if lb["prev_loss"] is not None:
            out["__lbfgs__/prev_loss"] = torch.tensor(lb["prev_loss"],
                                                      dtype=torch.float32)
        return out

    def set_state_dict(self, state):
        def vec(k):
            v = state[k]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v, dtype=np.float32))
            return v.to(self._parameters[0].device, torch.float32)

        lb = {"s": [], "y": [], "rho": [], "prev_loss": None}
        i = 0
        while f"__lbfgs__/s{i}" in state:
            lb["s"].append(vec(f"__lbfgs__/s{i}"))
            lb["y"].append(vec(f"__lbfgs__/y{i}"))
            lb["rho"].append(float(np.asarray(state[f"__lbfgs__/rho{i}"])))
            i += 1
        if "__lbfgs__/prev_loss" in state:
            lb["prev_loss"] = float(np.asarray(state["__lbfgs__/prev_loss"]))
        self._state_lb = lb
        super().set_state_dict(
            {k: v for k, v in state.items() if "__lbfgs__/" not in k})

    def _gather_flat_grad(self):
        grads = [(p.grad.detach().clone() if p.grad is not None
                  else torch.zeros_like(p)) for p in self._parameters]
        if self._grad_clip is not None:
            self._grad_clip.clip_([g for g, c in zip(grads, self._need_clip)
                                   if c])
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        if self._weight_decay:  # coupled L2 on the flattened parameters
            flat = flat + float(self._weight_decay) * self._flat_params()
        return flat

    def _flat_params(self):
        return torch.cat([p.detach().reshape(-1).float()
                          for p in self._parameters])

    @torch.no_grad()
    def _set_flat_params(self, flat):
        off = 0
        for p in self._parameters:
            n = p.numel()
            p.copy_(flat[off:off + n].view_as(p))
            off += n

    def _directional(self, closure, x0, d, t):
        self._set_flat_params(x0 + t * d)
        loss = _loss(closure())
        g = self._gather_flat_grad()
        return loss, float(torch.dot(g, d)), g

    def step(self, closure=None):
        """Up to `max_iter` iterations on `closure`; returns the last
        loss as a float."""
        if closure is None:
            raise ValueError("LBFGS.step requires a closure that "
                             "recomputes loss and gradients")
        lb = self._state_lb
        lr = self.get_lr()
        loss = _loss(closure())
        flat_grad = self._gather_flat_grad()
        if float(flat_grad.abs().max()) <= self._tol_grad:
            return loss
        n_eval = 1
        for _ in range(self._max_iter):
            # two-loop recursion
            q = flat_grad
            alphas = []
            for s, y, rho in zip(reversed(lb["s"]), reversed(lb["y"]),
                                 reversed(lb["rho"])):
                a = rho * float(torch.dot(s, q))
                alphas.append(a)
                q = q - a * y
            if lb["y"]:
                y_last, s_last = lb["y"][-1], lb["s"][-1]
                gamma = float(torch.dot(s_last, y_last)
                              / torch.dot(y_last, y_last).clamp(min=1e-10))
                r = gamma * q
            else:
                r = q
            for (s, y, rho), a in zip(zip(lb["s"], lb["y"], lb["rho"]),
                                      reversed(alphas)):
                b = rho * float(torch.dot(y, r))
                r = r + (a - b) * s
            d = -r
            gtd = float(torch.dot(flat_grad, d))
            if gtd > -self._tol_change:
                break
            x0 = self._flat_params()
            t = lr if lb["prev_loss"] is not None else \
                min(1.0, 1.0 / float(flat_grad.abs().sum())) * lr
            if self._line_search == "strong_wolfe":
                t, loss_new, g_new, evals = _strong_wolfe(
                    lambda tt: self._directional(closure, x0, d, tt),
                    t, loss, gtd)
                n_eval += evals
                self._set_flat_params(x0 + t * d)
            else:
                self._set_flat_params(x0 + t * d)
                loss_new = _loss(closure())
                g_new = self._gather_flat_grad()
                n_eval += 1
            s_vec = t * d
            y_vec = g_new - flat_grad
            sy = float(torch.dot(s_vec, y_vec))
            if sy > 1e-10:
                if len(lb["s"]) >= self._hist:
                    lb["s"].pop(0)
                    lb["y"].pop(0)
                    lb["rho"].pop(0)
                lb["s"].append(s_vec)
                lb["y"].append(y_vec)
                lb["rho"].append(1.0 / sy)
            delta = abs(loss_new - loss)
            loss, flat_grad = loss_new, g_new
            lb["prev_loss"] = loss
            if (float(flat_grad.abs().max()) <= self._tol_grad
                    or delta < self._tol_change
                    or n_eval >= self._max_eval):
                break
        self._step_count += 1
        return loss


def _strong_wolfe(phi, t, f0, gtd0, c1=1e-4, c2=0.9, max_ls=25):
    """Strong-Wolfe line search on phi(t) -> (loss, directional
    derivative, gradient), the JAX package's (`:559`).  The returned
    (t, f, g) always come from ONE phi(t) evaluation: LBFGS pairs the
    gradient with x0 + t * d, and a mixed triple would corrupt the
    curvature history."""
    t_prev, f_prev = 0.0, f0
    evals = 0
    f_new, gtd_new, g_new = phi(t)
    evals += 1
    for _ in range(max_ls):
        if f_new > f0 + c1 * t * gtd0 or (evals > 1 and f_new >= f_prev):
            lo, hi = t_prev, t
            f_lo = f_prev
            best = (t, f_new, g_new)
            for _ in range(max_ls):
                tm = 0.5 * (lo + hi)
                f_m, gtd_m, g_m = phi(tm)
                evals += 1
                if f_m <= f0 + c1 * tm * gtd0 and f_m < best[1]:
                    best = (tm, f_m, g_m)
                if f_m > f0 + c1 * tm * gtd0 or f_m >= f_lo:
                    hi = tm
                else:
                    if abs(gtd_m) <= -c2 * gtd0:
                        return tm, f_m, g_m, evals
                    if gtd_m * (hi - lo) >= 0:
                        hi = lo
                    lo, f_lo = tm, f_m
            return best + (evals,)
        if abs(gtd_new) <= -c2 * gtd0:
            return t, f_new, g_new, evals
        if gtd_new >= 0:
            lo, hi = t, t_prev
            best = (t, f_new, g_new)
            for _ in range(max_ls):
                tm = 0.5 * (lo + hi)
                f_m, gtd_m, g_m = phi(tm)
                evals += 1
                if f_m <= f0 + c1 * tm * gtd0 and f_m < best[1]:
                    best = (tm, f_m, g_m)
                if f_m > f0 + c1 * tm * gtd0:
                    hi = tm
                elif abs(gtd_m) <= -c2 * gtd0:
                    return tm, f_m, g_m, evals
                else:
                    lo = tm
            return best + (evals,)
        t_prev, f_prev = t, f_new
        t = 2.0 * t
        f_new, gtd_new, g_new = phi(t)
        evals += 1
    return t, f_new, g_new, evals
