"""Loss scaling for float16 training (counterpart:
`paddle_tpu/amp/grad_scaler.py:13-131`).

The dynamic-scale algorithm of the JAX package: `scale` multiplies the
loss, `unscale_` divides an optimizer's grads by the scale and finds
whether any is not finite, `step` skips that optimizer's step when one
is not (so `optimizer._step_count` stays where it was), and `update`,
once an iteration, shrinks the scale by `decr_ratio` after
`decr_every_n_nan_or_inf` bad iterations (never below 1) or grows it by
`incr_ratio` after `incr_every_n_steps` good ones.  Each optimizer is
unscaled at most once an iteration (a user who unscales to clip is not
unscaled twice), and the scale's verdict is the OR of every optimizer's
this iteration.

Where the JAX package reads every grad's finiteness back to the host
(one wait per parameter, `:48-53`), `unscale_` here checks and unscales
all the grads of one device and dtype together (see `_unscale_grads`)
and waits for the device once.  Grads that are None are left alone.  The
JAX scaler's telemetry (a skipped-step counter and a scale gauge) is not
ported.
"""
from __future__ import annotations

import torch

from ..framework import debugging as _debugging
from ..resilience import guard as _guard


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # id(optimizer) -> its found_inf, for the optimizers unscaled this
        # iteration
        self._unscaled = {}
        # OR of every optimizer's verdict this iteration, read by update()
        self._iter_found_inf = False

    def is_enable(self):
        return self._enable

    def scale(self, loss):
        """loss * the current scale.  A new iteration starts here: the
        unscale marks of the last one are dropped (its found_inf is kept
        until update(), for iterations with several losses)."""
        if not self._enable:
            return loss
        self._unscaled.clear()
        return loss * self._scale

    @torch.no_grad()
    def _unscale_grads(self, optimizer):
        """Divide every grad of `optimizer` by the scale in place; True if
        any grad held an inf or a NaN (before the division).  The grads
        of each device and dtype go together: float32 and float16 through
        the fused `_amp_foreach_non_finite_check_and_unscale_`, bfloat16
        (a bf16 model, or `amp.decorate(dtype="bfloat16")`), which that
        kernel does not take on CUDA, judged by
        `framework.debugging.grad_flags` and divided by one
        `_foreach_mul_`."""
        found = {}
        for (device, dtype), grads in _guard._groups(
                [p.grad for p in optimizer._parameters]).items():
            if device not in found:
                found[device] = torch.zeros(1, device=device)
            if dtype == torch.bfloat16:
                bad = ~_debugging.grad_flags(grads, device).all()
                found[device] += bad.to(torch.float32)
                torch._foreach_mul_(grads, 1.0 / self._scale)
                continue
            inv = torch.full((1,), 1.0 / self._scale, device=device)
            torch._amp_foreach_non_finite_check_and_unscale_(
                grads, found[device], inv)
        return any(bool(f.item()) for f in found.values())

    def unscale_(self, optimizer):
        if not self._enable or id(optimizer) in self._unscaled:
            return
        self._found_inf = self._unscale_grads(optimizer)
        self._iter_found_inf = self._iter_found_inf or self._found_inf
        self._unscaled[id(optimizer)] = self._found_inf

    def step(self, optimizer):
        """Unscale (unless done this iteration) and step `optimizer`, or
        skip its step when a grad was not finite.  The scale itself
        changes in update()."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        self._found_inf = self._unscaled.pop(id(optimizer), self._found_inf)
        if not self._found_inf:
            optimizer.step()

    def minimize(self, optimizer, loss):
        self.step(optimizer)
        self.update()

    def update(self):
        """The once-an-iteration scale update from the OR of every
        optimizer's found_inf."""
        self._unscaled.clear()
        if self._dynamic:
            if self._iter_found_inf:
                self._bad_steps += 1
                self._good_steps = 0
                if self._bad_steps >= self._decr_every_n:
                    self._scale = max(self._scale * self._decr_ratio, 1.0)
                    self._bad_steps = 0
            else:
                self._good_steps += 1
                self._bad_steps = 0
                if self._good_steps >= self._incr_every_n_steps:
                    self._scale *= self._incr_ratio
                    self._good_steps = 0
        self._iter_found_inf = False

    def get_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, s):
        self._scale = float(s)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, st):
        self._scale = st["scale"]
        self._good_steps = st["good_steps"]
        self._bad_steps = st["bad_steps"]


AmpScaler = GradScaler
