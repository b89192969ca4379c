"""LookAhead and ModelAverage, the incubate package's wrapper optimizers.

Counterpart: `paddle_tpu/incubate/optimizer.py`.  Both keep float32
copies of the parameters on the parameters' device and work on the
parameters in place, after the inner optimizer's eager `step()`.
`LookAhead.state_dict` adds `__lookahead__/slow{i}` and
`__lookahead__/steps` to the inner optimizer's keys, as the JAX package
names them, so a state crosses between the packages.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["LookAhead", "ModelAverage"]


def _f32_copies(params):
    return [p.detach().float().clone() for p in params]


class LookAhead:
    """Wraps an inner optimizer: every k steps the slow weights move alpha
    of the way toward the fast weights, and the fast weights are set to
    them (Zhang et al. 2019).  The slow weights start at the parameters
    before the first step."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1]")
        if k < 1:
            raise ValueError("k must be >= 1")
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = int(k)
        self._slow = None
        self._steps = 0
        self._parameters = inner_optimizer._parameters

    @torch.no_grad()
    def step(self):
        if self._slow is None:
            self._slow = _f32_copies(self._parameters)
        self.inner_optimizer.step()
        self._steps += 1
        if self._steps % self.k == 0:
            for p, s in zip(self._parameters, self._slow):
                p.copy_((s + self.alpha * (p.float() - s)).to(p.dtype))
            self._slow = _f32_copies(self._parameters)

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def state_dict(self):
        out = self.inner_optimizer.state_dict()
        for i, s in enumerate(self._slow or ()):
            out[f"__lookahead__/slow{i}"] = s
        out["__lookahead__/steps"] = self._steps
        return out

    def set_state_dict(self, state):
        """Load `state_dict`'s keys; a slow weight may be a tensor or an
        array (a JAX state's, through np.asarray)."""
        self._steps = int(state.get("__lookahead__/steps", 0))
        slow = []
        while f"__lookahead__/slow{len(slow)}" in state:
            v = state[f"__lookahead__/slow{len(slow)}"]
            p = self._parameters[len(slow)]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v, dtype=np.float32))
            slow.append(v.to(device=p.device, dtype=torch.float32))
        self._slow = slow or None
        self.inner_optimizer.set_state_dict(
            {k: v for k, v in state.items()
             if not k.startswith("__lookahead__/")})


class ModelAverage:
    """The running mean of the parameters (counting their values when
    built and after each `step()`); `apply()` swaps the mean in,
    `restore()` swaps the parameters back."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._parameters = list(parameters)
        self._avg = _f32_copies(self._parameters)
        self._n = 1
        self._backup = None

    @torch.no_grad()
    def step(self):
        """Add the parameters' values to the mean (call after the
        optimizer's step)."""
        self._n += 1
        for i, p in enumerate(self._parameters):
            self._avg[i] = self._avg[i] + (p.float() - self._avg[i]) / self._n

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        """Swap the mean in, keeping the parameters for `restore()` when
        `need_restore`."""
        if need_restore:
            self._backup = [p.detach().clone() for p in self._parameters]
        for p, a in zip(self._parameters, self._avg):
            p.copy_(a.to(p.dtype))

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            raise RuntimeError("restore() without a prior apply()")
        for p, b in zip(self._parameters, self._backup):
            p.copy_(b)
        self._backup = None
