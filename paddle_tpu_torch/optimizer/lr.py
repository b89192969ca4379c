"""Learning-rate schedulers (counterpart: `paddle_tpu/optimizer/lr.py`).

Host arithmetic only, kept as the JAX package has it (the port may not
import that module, so it holds its own copy): a scheduler starts at
`last_epoch + 1` (the constructor steps once), `step()` advances it (or
jumps to `epoch`), `__call__` gives the current rate, and `state_dict`
holds its plain fields.  An optimizer given a scheduler reads it at every
update (`Optimizer.get_lr`); the caller steps it.  `LinearWarmup` wraps
a float or another scheduler, which it steps to `last_epoch -
warmup_steps` after the warm-up.
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
        self.verbose = verbose
        self.step()  # initialize to epoch 0 like the reference

    def __call__(self):
        return self.last_lr

    def get_lr(self):
        raise NotImplementedError

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, str, bool))}

    def set_state_dict(self, state):
        self.__dict__.update(state)

    set_dict = set_state_dict
    state_keys = state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return self.base_lr * (self.d_model ** -0.5) * min(
            step ** -0.5, step * self.warmup_steps ** -1.5)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        return (self.base_lr - self.end_lr) * (
            (1 - step / decay_steps) ** self.power) + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / self.warmup_steps) + self.start_lr
        if isinstance(self.lr, LRScheduler):
            self.lr.step(self.last_epoch - self.warmup_steps)
            return self.lr()
        return float(self.lr)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch //
                                              self.step_size))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        d = super().state_dict()
        d.pop("lr_lambda", None)
        return d


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0.0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.up_steps = int(total_steps * phase_pct)
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, a, b, pct):
        if self.anneal == "cos":
            return b + (a - b) * (1 + math.cos(math.pi * pct)) / 2
        return a + (b - a) * pct

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        if step <= self.up_steps and self.up_steps > 0:
            return self._interp(self.initial_lr, self.max_lr,
                                step / self.up_steps)
        down = self.total_steps - self.up_steps
        pct = (step - self.up_steps) / max(down, 1)
        return self._interp(self.max_lr, self.end_lr, pct)


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        current = float(metrics.item() if hasattr(metrics, "item")
                        else metrics)
        if self.best is None or self._better(current, self.best):
            self.best = current
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0

    def _better(self, a, b):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < b * (1 - self.threshold)
            return a < b - self.threshold
        if self.threshold_mode == "rel":
            return a > b * (1 + self.threshold)
        return a > b + self.threshold


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0.0,
                 last_epoch=-1, verbose=False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = self.last_epoch
        t_i = self.T_0
        while t >= t_i:
            t -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t / t_i)) / 2


class CyclicLR(LRScheduler):
    """reference: python/paddle/optimizer/lr.py CyclicLR (triangular /
    triangular2 / exp_range policies over a base↔max cycle)."""

    def __init__(self, base_learning_rate, max_learning_rate,
                 step_size_up, step_size_down=None, mode="triangular",
                 exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.base_lr = base_learning_rate
        self.max_lr = max_learning_rate
        self.up = int(step_size_up)
        self.down = int(step_size_down
                        if step_size_down is not None else step_size_up)
        if self.up <= 0 or self.down <= 0:
            raise ValueError("step_size_up/step_size_down must be positive")
        self.mode = mode
        self.exp_gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode if scale_fn is not None else {
            "triangular": "cycle", "triangular2": "cycle",
            "exp_range": "iterations"}.get(mode, "cycle")
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.up + self.down
        it = self.last_epoch
        cycle = it // total
        pos = it - cycle * total
        x = pos / self.up if pos <= self.up else \
            1.0 - (pos - self.up) / self.down
        if self.scale_fn is not None:
            scale = self.scale_fn(cycle + 1 if self.scale_mode == "cycle"
                                  else it)
        elif self.mode == "triangular":
            scale = 1.0
        elif self.mode == "triangular2":
            scale = 1.0 / (2.0 ** cycle)
        elif self.mode == "exp_range":
            scale = self.exp_gamma ** it
        else:
            raise ValueError(f"unknown CyclicLR mode {self.mode!r}")
        return self.base_lr + (self.max_lr - self.base_lr) * x * scale


class MultiplicativeDecay(LRScheduler):
    """lr_{t} = lr_{t-1} * lr_lambda(t) (reference:
    paddle.optimizer.lr.MultiplicativeDecay)."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        lr = self.base_lr
        for e in range(1, self.last_epoch + 1):
            lr = lr * self.lr_lambda(e)
        return lr

    def state_dict(self):
        d = super().state_dict()
        d.pop("lr_lambda", None)
        return d
