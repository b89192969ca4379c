"""Nonfinite-step guard: skip poisoned optimizer steps, roll runs back.

Counterpart: `paddle_tpu/resilience/guard.py:33-200`.  One NaN loss (a
poisoned batch, a float16 overflow past the GradScaler, an unstable
layer) must not end a run.  On the device, one scalar says whether the
loss and every gradient are finite, and a bad step is turned into a
no-op without the host waiting for that verdict; on the host, the guard
counts bad steps in a row and, after `max_consecutive`, rolls back to
the last checkpoint (`CheckpointManager.restore`), with the random
state folded (`framework.random.fold`) so that the replayed steps draw
other dropout masks.

`jit.TrainStep(..., guard=NonfiniteGuard(...))` arms it for one step
object; `PADDLE_TPU_GUARD=1` arms it for every TrainStep built after
(`PADDLE_TPU_GUARD_N` the threshold, `PADDLE_TPU_GUARD_EVERY` the
check interval, `PADDLE_TPU_GUARD_MODE` the mode).
"""
from __future__ import annotations

import os
import warnings

import torch

from ..framework import debugging as _debugging
from ..framework import random as _random
from ..observability import metrics as _metrics


@torch.no_grad()
def all_finite(loss, grads):
    """A 0-dim bool tensor on the loss's device: True when the loss and
    every gradient (None skipped) hold finite values only.  No host
    wait.  The JAX package sums g * 0 over every tensor; here the
    gradients of each device and dtype are judged together, the verdict
    the same: float32 and float16 groups by the fused
    `_amp_foreach_non_finite_check_and_unscale_` (with a scale of 1,
    which leaves every value as it is), bfloat16 groups, which that
    kernel does not take on CUDA, by `framework.debugging.grad_flags`
    (one multi-tensor infinity norm and one stack; its Python pass over
    the tensors makes it the slower of the two: 0.81 ms against 0.27 ms
    for this function over MobileNetV3-Large's float32 gradients on an
    H100: PERF.md)."""
    device = loss.device
    ok = torch.isfinite(loss.detach().float()).all()
    found = torch.zeros(1, dtype=torch.float32, device=device)
    for (dev, dtype), gs in _groups(grads).items():
        if dtype == torch.bfloat16:
            ok = ok & _debugging.grad_flags(gs, device).all()
            continue
        f = found if dev == device else torch.zeros(1, dtype=torch.float32,
                                                    device=dev)
        torch._amp_foreach_non_finite_check_and_unscale_(
            gs, f, torch.ones(1, dtype=torch.float32, device=dev))
        if f is not found:
            found += f.to(device)
    return ok.logical_and(found[0] == 0)


def _groups(grads):
    """{(device, dtype): [gradient, ...]} of the gradients not None."""
    groups = {}
    for g in grads:
        if g is not None:
            groups.setdefault((g.device, g.dtype), []).append(g)
    return groups


@torch.no_grad()
def gate_grads(ok, grads):
    """`mode="fused"`: every gradient zeroed in place when `ok` is False,
    by a fill and not `g * ok` (NaN times 0 is NaN).  Returns grads."""
    bad = ~ok
    for g in grads:
        if g is not None:
            g.masked_fill_(bad, 0)
    return grads


def gate_lr(ok, lr):
    """The rate (a float32 tensor), or 0 when `ok` is False: every update
    rule multiplies its parameter change by the rate, so with the
    gradients zeroed the parameters stay bit for bit."""
    return torch.where(ok, lr, torch.zeros_like(lr))


def env_guard():
    """A NonfiniteGuard when PADDLE_TPU_GUARD=1, else None (read when a
    TrainStep is built)."""
    if os.environ.get("PADDLE_TPU_GUARD", "0") != "1":
        return None
    return NonfiniteGuard(
        max_consecutive=int(os.environ.get("PADDLE_TPU_GUARD_N", "3")),
        check_every=int(os.environ.get("PADDLE_TPU_GUARD_EVERY", "1")),
        mode=os.environ.get("PADDLE_TPU_GUARD_MODE", "fused"))


class NonfiniteGuard:
    """The host half of the guard: bad steps in a row, and rollback.

    With a `manager` (a `resilience.CheckpointManager`) the guard rolls
    back after `max_consecutive` bad steps in a row; without one it
    raises FloatingPointError then.

    `mode` is how the train step turns a bad step into a no-op:

    ``"fused"`` (default)  the gradients and the rate are gated to zero:
        parameters and buffers stay bit for bit and the update still
        writes in place; adaptive moments take one decay step, exactly
        a zero-gradient batch's, as in the JAX package.
    ``"exact"``  parameters, buffers and every optimizer slot are copied
        before the update and selected back after it: "the step never
        happened", bit for bit, at the price of one copy of the state.

    `check_every=k` reads the verdicts only every k steps: reading one
    waits for that step's work on the device, which a deferred read of
    an older step does not.  A bad step is always a no-op on the device;
    skips and rollbacks are found up to k - 1 steps late.
    """

    def __init__(self, max_consecutive=3, manager=None, fold_rng=True,
                 check_every=1, mode="fused"):
        if mode not in ("fused", "exact"):
            raise ValueError(f"guard mode {mode!r}: want 'fused'|'exact'")
        self.max_consecutive = int(max_consecutive)
        self.manager = manager
        self.fold_rng = fold_rng
        self.mode = mode
        self.check_every = max(1, int(check_every))
        self.consecutive = 0
        self.total_skipped = 0
        self.rollbacks = 0
        self._pending = []      # deferred (ok tensor, train step) pairs

    def after_step(self, ok, train_step=None):
        """Record a step's verdict; True when a skip was found (with
        `check_every` > 1 it may be an earlier step's)."""
        if self.check_every == 1:
            return self._process(ok, train_step)
        self._pending.append((ok, train_step))
        if len(self._pending) >= self.check_every:
            return self.drain()
        return False

    def drain(self):
        """Process the deferred verdicts in step order; a rollback drops
        those queued after it (they belong to the abandoned timeline).
        True when a drained step was skipped."""
        pending, self._pending = self._pending, []
        if not pending:
            return False
        # one host read for the whole window
        oks = torch.stack([ok.reshape(()) for ok, _ in pending]).tolist()
        any_skipped = False
        for ok, (_, ts) in zip(oks, pending):
            before = self.rollbacks
            any_skipped |= self._process(ok, ts)
            if self.rollbacks != before:
                break
        return any_skipped

    def _process(self, ok, train_step):
        if bool(ok):
            self.consecutive = 0
            return False
        self.consecutive += 1
        self.total_skipped += 1
        reg = _metrics.registry()
        reg.counter("guard_nonfinite_steps_total", source="guard").inc()
        reg.gauge("guard_consecutive_bad_steps").set(self.consecutive)
        warnings.warn(
            f"nonfinite grads/loss: optimizer step skipped "
            f"({self.consecutive}/{self.max_consecutive} consecutive)",
            RuntimeWarning)
        if self.consecutive >= self.max_consecutive:
            self._rollback(train_step)
        return True

    def _rollback(self, train_step):
        if self.manager is None:
            raise FloatingPointError(
                f"{self.consecutive} consecutive nonfinite steps and no "
                f"CheckpointManager attached to the NonfiniteGuard: "
                f"cannot roll back (attach resilience.CheckpointManager "
                f"or fix the input pipeline)")
        meta = self.manager.restore(train_step=train_step)
        self.rollbacks += 1
        self.consecutive = 0
        _metrics.registry().counter("guard_rollbacks_total").inc()
        if self.fold_rng:
            _random.fold(self.rollbacks)
        warnings.warn(
            f"rolled back to checkpoint {meta.get('__path__')} at step "
            f"{meta.get('step')} after {self.max_consecutive} consecutive "
            f"nonfinite steps (rollback #{self.rollbacks}"
            + (", random state folded)" if self.fold_rng else ")"),
            RuntimeWarning)
        return meta
