"""Optimizer base.

Counterpart: `paddle_tpu/optimizer/optimizer.py`.  The rule of each
optimizer is the JAX package's: `_rule(g, p, slots, lr, step)` on float32
tensors returns the new parameter and slots (`:133-173`), with coupled
decay before it (`_pre_grad`, `g + wd * p`) and decoupled decay after it
(`_post_param`, `new_p - lr * wd * p`), both limited to the names
`apply_decay_param_fun` accepts.

Where the JAX package jit-compiles the update and DONATES the old
parameters and state so XLA reuses their memory, the port writes the new
values IN PLACE into the same parameter and slot tensors (`copy_`): no
second copy of either is kept, and every tensor a caller holds stays
valid.  Slots are created at the first step on each parameter's device
(`init_state`, `:95-119`): float32, plus a float32 `master` copy of a
bfloat16 / float16 parameter when master weights are on (AMP O2), which
then carries the update while the parameter gets its rounded value.
Parameters that do not require grad get no slots; one unfrozen after
that raises at the next update until the state is rebuilt.  The learning rate is
a float (LR schedulers are a later slice); clipping runs on the `.grad`
tensors first.  Nothing waits for the card.
"""
from __future__ import annotations

import numpy as np
import torch

_LOW = (torch.bfloat16, torch.float16)


def f32(x):
    """x rounded to float32, as the JAX rules see a Python scalar beside a
    float32 array (bias corrections and decay rates)."""
    return float(np.float32(x))


class Optimizer:
    SLOTS: tuple = ()
    _couple_decay = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 apply_decay_param_fun=None):
        if parameters is None:
            raise ValueError(
                "parameters must be provided (dygraph-style optimizer)")
        self._parameters = list(parameters)
        if self._parameters and isinstance(self._parameters[0], dict):
            raise NotImplementedError(
                "parameter groups are not ported yet; pass a flat list")
        # TrainStep renames these after the model's named_parameters()
        self._param_names = [f"param_{i}"
                             for i in range(len(self._parameters))]
        self._lr = learning_rate
        self._grad_clip = grad_clip
        self._weight_decay = float(weight_decay or 0.0)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._use_master_weights = multi_precision
        self._state = None
        self._step_count = 0

    # ------------------------------------------------------------------- lr
    def get_lr(self):
        if not isinstance(self._lr, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet; pass a float")
        return float(self._lr)

    # ------------------------------------------------------------ state mgmt
    def _init_state_for(self, p):
        """{slot: initial float32 tensor} for one parameter."""
        return {s: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for s in self.SLOTS}

    @torch.no_grad()
    def init_state(self):
        """Create the slots of every parameter (empty for one that does
        not require grad)."""
        state = []
        for p in self._parameters:
            if not p.requires_grad:
                state.append({})
                continue
            slots = self._init_state_for(p)
            if self._use_master_weights and p.dtype in _LOW:
                slots["master"] = p.detach().float()
            state.append(slots)
        self._state = state
        return state

    # -------------------------------------------------------- functional core
    def _rule(self, g, p, slots, lr, step):
        """Single-parameter update on float32 tensors; returns (new_p,
        new_slots) as new tensors, leaving its inputs untouched."""
        raise NotImplementedError

    def _decayed(self, name):
        fn = self._apply_decay_param_fun
        return True if fn is None else bool(fn(name))

    def _pre_grad(self, g, p, decayed):
        # coupled L2 (Adam)
        wd = self._weight_decay
        if wd and self._couple_decay and decayed:
            return g + wd * p
        return g

    def _post_param(self, new_p, old_p, decayed, lr):
        # decoupled decay (AdamW)
        wd = self._weight_decay
        if wd and not self._couple_decay and decayed:
            return new_p - lr * wd * old_p
        return new_p

    @torch.no_grad()
    def update(self, lr, step):
        """Apply one update with learning rate `lr` at 1-based `step` to
        every parameter that has a grad, in place."""
        if self._state is None:
            self.init_state()
        for p, name, slots in zip(self._parameters, self._param_names,
                                  self._state):
            if p.grad is None or not p.requires_grad:
                continue
            if not slots:
                # every optimizer here gives a trainable parameter at least
                # one slot: an empty dict is a parameter that was frozen
                # when the slots were made (the reference raises a bare
                # KeyError from its rule here)
                raise RuntimeError(
                    f"parameter {name!r} has a grad but no optimizer "
                    f"state: it was frozen when the state was made. "
                    f"Rebuild the optimizer (or call init_state()) after "
                    f"unfreezing it")
            dec = self._decayed(name)
            gf = p.grad.float()
            pf = slots["master"] if "master" in slots else p.detach().float()
            gf = self._pre_grad(gf, pf, dec)
            new_p, new_slots = self._rule(gf, pf, dict(slots), lr, step)
            new_p = self._post_param(new_p, pf, dec, lr)
            for s, t in new_slots.items():
                if t is not slots[s]:
                    slots[s].copy_(t)
            if "master" in slots:
                slots["master"].copy_(new_p)
            p.copy_(new_p)

    # --------------------------------------------------------------- eager
    def _clip_grads(self):
        if self._grad_clip is not None:
            self._grad_clip.clip_([p.grad for p in self._parameters
                                   if p.grad is not None])

    def step(self):
        """One eager step on the parameters' `.grad` tensors: clip, then
        update in place."""
        if all(p.grad is None for p in self._parameters):
            return
        self._step_count += 1
        self._clip_grads()
        self.update(self.get_lr(), self._step_count)

    def clear_grad(self):
        for p in self._parameters:
            p.grad = None
