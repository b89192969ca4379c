"""The training step: forward, backward, clip and update in one call.

Counterpart: `paddle_tpu/jit/train_step.py:24-251`, where one jitted XLA
program does the whole step with the parameters and optimizer state
donated.  PyTorch runs eagerly: the forward runs `loss_fn(model, *batch)`
under autograd, `backward()` leaves the grads on the parameters, the
optimizer's grad clip scales them in place, the update writes the new
parameters and slots in place (the port's stand-in for donation), and the
grads are reset to None so their memory returns before the next
forward.  The step follows the device of the model's parameters and
returns the loss as a 0-dim tensor there, without waiting for the card.

The step counter is the optimizer's (`optimizer._step_count`), so an
optimizer state carried in with its step resumes the bias corrections
where they were.  It advances on every call, a skipped step too, as the
JAX step's does.

`guard` (a `resilience.NonfiniteGuard`; by default `env_guard()`, None
unless PADDLE_TPU_GUARD=1) arms the nonfinite-step guard: one device
scalar says whether the loss and every gradient are finite; in "fused"
mode a bad step's gradients and rate are gated to zero (the rate goes to
the update as a float32 device tensor), in "exact" mode the parameters
and slots are copied before the update and selected back after it; the
model's buffers are selected back in both modes; then the guard counts
the verdict and may roll back through its CheckpointManager.  The
chaos site `step.nonfinite` poisons the batch before the forward
(`resilience.chaos.poison_batch`).  The persistent compile cache of the
JAX step has no counterpart in an eager step.

`check_numerics` (`framework.debugging`; the flag is read on the first
call, as the JAX step reads it when it is built): after the backward
the loss and every gradient are checked on the device and read once on
the host; a non-finite one raises FloatingPointError naming it, with
the step number, before the clip and the update, so the parameters and
the optimizer's slots are as they were; the step counter has advanced,
as the JAX step's has, and the gradients are dropped.  The JAX step has
already replaced its optimizer state with the step's outputs when it
raises (its slots then hold the bad step's moments): the intended
divergence of ROADMAP.md C.
"""
from __future__ import annotations

import torch

from ..framework import debugging as _dbg
from ..resilience import chaos as _chaos
from ..resilience import guard as _guard


class TrainStep:
    """step = TrainStep(model, loss_fn, optimizer); loss = step(*batch)

    `loss_fn(model, *batch)` returns a scalar loss tensor.  `donate` is
    taken in the JAX package's place and ignored: the eager step updates
    the parameters and slots in place, which is what donation buys
    there."""

    def __init__(self, model, loss_fn, optimizer, donate=True, guard=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        # name the optimizer's parameters as the model does, so that
        # apply_decay_param_fun sees "gpt.h.0.attn.qkv_proj.weight", ...
        optimizer._name_after(model)
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._guard = guard if guard is not None else _guard.env_guard()
        self._check_numerics = None      # read on the first call

    @property
    def step_count(self):
        return self.optimizer._step_count

    def __call__(self, *batch):
        opt, guard = self.optimizer, self._guard
        poison_loss = False
        if _chaos._PLAN is not None and _chaos.fire("step.nonfinite"):
            batch, rode = _chaos.poison_batch(batch)
            poison_loss = not rode    # a batch of integers only
        buffers = None
        if guard is not None:
            buffers = [(b, b.clone()) for b in self.model.buffers()]
        loss = self.loss_fn(self.model, *batch)
        if poison_loss:
            loss = _chaos.poison_loss(loss)
        loss.backward()
        opt._step_count += 1
        if self._check_numerics is None:
            self._check_numerics = _dbg.enabled()
        if self._check_numerics:
            check_step(self.model, loss, opt._step_count)
        lr = opt.get_lr()
        ok = saved = None
        if guard is not None:
            ok = _guard.all_finite(loss, [p.grad for p in self._params])
            if guard.mode == "fused":
                _guard.gate_grads(ok, [p.grad for p in self._params])
                # a fill on the device, not a copy from the host (which
                # would wait for the card)
                lr = _guard.gate_lr(ok, torch.full(
                    (), lr, dtype=torch.float32, device=ok.device))
            else:
                if opt._state is None:
                    opt.init_state()
                saved = [(t, t.clone()) for t in self._state_tensors()]
        opt._clip_grads()
        opt.update(lr, opt._step_count)
        for p in self._params:
            p.grad = None
        if guard is not None:
            with torch.no_grad():
                for t, old in (saved or []) + buffers:
                    t.copy_(torch.where(ok, t, old))
            # after the update: a rollback restores checkpoint state into
            # the model, which this step's writes must not overwrite
            guard.after_step(ok, self)
        return loss.detach()

    def _state_tensors(self):
        """Parameters and optimizer slots: what "exact" mode selects."""
        return list(self.optimizer._parameters) + [
            t for slots in self.optimizer._state for t in slots.values()]

    def state_dict(self):
        return {"opt_state": self.optimizer._state,
                "step": self.optimizer._step_count}

    # --------------------------------------------------------- resilience
    def sync_optimizer_state(self):
        """Hand the step's optimizer state back to the optimizer before a
        save.  The JAX step owns its state apart from the optimizer and
        copies it back here; this eager step updates the optimizer's own
        slots in place and counts on the optimizer's `_step_count`, so
        there is nothing to copy, and the call only exists so that
        `CheckpointManager.save(train_step=)` is the same in both."""

    def reload_from(self, step=None):
        """After a checkpoint was restored into (model, optimizer): set
        the step counter to the checkpoint's `step`.  The optimizer's
        slots were already loaded in place, so the next call uses them."""
        if step is not None:
            self.optimizer._step_count = int(step)


def check_step(model, loss, step, group=None):
    """`check_numerics` after the backward: raise FloatingPointError
    naming the loss and the parameters (`named_parameters` names) whose
    values are not finite, the gradients dropped first.  Under
    torch.distributed the flags are combined over `group` first (a MIN
    all-reduce), so every rank raises alike."""
    named = list(model.named_parameters())
    flags = _dbg.finite_flags(loss, [p.grad for _, p in named])
    if group is not None:
        import torch.distributed as dist
        f = flags.to(torch.int32)
        dist.all_reduce(f, op=dist.ReduceOp.MIN, group=group)
        flags = f.bool()
    ok = flags.tolist()                  # the step's one host read
    if all(ok):
        return
    for _, p in named:
        p.grad = None
    _dbg.raise_on_nonfinite(ok, [n for n, _ in named], step)


def train_step(model, loss_fn, optimizer, donate=True, guard=None):
    return TrainStep(model, loss_fn, optimizer, guard=guard)
