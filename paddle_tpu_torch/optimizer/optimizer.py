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
that raises at the next update until the state is rebuilt.  Clipping runs
on the `.grad` tensors first.  Nothing waits for the card.

The learning rate is a float or an `lr.LRScheduler`, read at every
update (`get_lr`, `:81-85`); the caller steps the scheduler.
`parameters` may be a list of groups (dicts with "params") as in the
JAX package (`:31-48`): a group's "learning_rate" is a COEFFICIENT on
the global rate, and its "weight_decay" overrides the global decay for
that group; both compose with `apply_decay_param_fun`.  A decay is a
float or a `regularizer.L2Decay` (`_decay_value`, `:281-289`; an
`L1Decay` raises NotImplementedError).  A parameter stamped by
`framework.ParamAttr` (`optimize_attr`) folds in as in the JAX package
(`:49-69`): its "learning_rate" multiplies its group's coefficient, its
"regularizer" overrides the global decay where its group sets none, and
"need_clip" False keeps its gradient out of the clip (`:192-199`).

`update(lr, step)` takes the rate as a float (the eager `step()`) or as
a 0-dim float32 tensor on the parameters' device (the guarded
`TrainStep`, whose nonfinite gate zeroes the rate without waiting for
the card); the rules multiply it in either way.

`state_dict` / `set_state_dict` (`:246-279`) use the JAX package's keys:
"step", "{param name}/{slot}" (the model's names once `TrainStep` or a
checkpoint has seen the model, `param_{i}` before) and "LR_Scheduler"
when the rate is a scheduler, so a state crosses between the packages
as numpy arrays of the same shapes; `minimize` is backward, step and clear_grad
(`:227-237`, the eager branch).  `name=`, and `clear_grad`'s
`set_to_zero`, are taken and change nothing, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..regularizer import L1Decay, L2Decay, _decay_value  # noqa: F401
from .lr import LRScheduler

_LOW = (torch.bfloat16, torch.float16)


def f32(x):
    """x rounded to float32, as the JAX rules see a Python scalar beside a
    float32 array (bias corrections and decay rates)."""
    return float(np.float32(x))


class Optimizer:
    SLOTS: tuple = ()
    _couple_decay = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, apply_decay_param_fun=None):
        if parameters is None:
            raise ValueError(
                "parameters must be provided (dygraph-style optimizer)")
        parameters = list(parameters)
        self._lr_scales, self._wd_overrides = [], []
        if parameters and isinstance(parameters[0], dict):
            self._parameters = []
            for group in parameters:
                ps = list(group["params"])
                wd = group.get("weight_decay")
                self._parameters.extend(ps)
                self._lr_scales.extend(
                    [float(group.get("learning_rate", 1.0))] * len(ps))
                self._wd_overrides.extend(
                    [None if wd is None else _decay_value(wd)] * len(ps))
        else:
            self._parameters = parameters
            self._lr_scales = [1.0] * len(parameters)
            self._wd_overrides = [None] * len(parameters)

        def _oa(p):
            return getattr(p, "optimize_attr", None) or {}

        self._lr_scales = [
            s * float(_oa(p).get("learning_rate", 1.0))
            for p, s in zip(self._parameters, self._lr_scales)]
        self._wd_overrides = [
            _decay_value(_oa(p)["regularizer"])
            if wd is None and "regularizer" in _oa(p) else wd
            for p, wd in zip(self._parameters, self._wd_overrides)]
        self._need_clip = [bool(_oa(p).get("need_clip", True))
                           for p in self._parameters]
        # TrainStep and the checkpoints rename these after the model
        # (`_name_after`)
        self._param_names = [getattr(p, "paddle_name", None) or f"param_{i}"
                             for i, p in enumerate(self._parameters)]
        self._lr = learning_rate
        self._grad_clip = grad_clip
        self._weight_decay = _decay_value(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._use_master_weights = multi_precision
        self._state = None
        self._step_count = 0

    def _name_after(self, model):
        """Name the parameters as `model.named_parameters()` does (a
        `ParamAttr` name stays first), so that decay masks and
        state-dict keys read "bert.pooler.weight", as the JAX package's
        parameters are named."""
        names = {id(p): n for n, p in model.named_parameters()}
        self._param_names = [
            old if getattr(p, "paddle_name", None) else names.get(id(p), old)
            for p, old in zip(self._parameters, self._param_names)]

    # ------------------------------------------------------------------- lr
    def get_lr(self):
        """The global rate: the scheduler's current value, or the float."""
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        self._lr = float(value)

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

    def _pre_grad(self, g, p, decayed, wd):
        # coupled L2 (Adam)
        if wd and self._couple_decay and decayed:
            return g + wd * p
        return g

    def _post_param(self, new_p, old_p, decayed, lr, wd):
        # decoupled decay (AdamW)
        if wd and not self._couple_decay and decayed:
            return new_p - lr * wd * old_p
        return new_p

    @torch.no_grad()
    def update(self, lr, step):
        """Apply one update with learning rate `lr` (a float or a 0-dim
        float32 tensor) at 1-based `step` to every parameter that has a
        grad, in place; a parameter group scales `lr` by its coefficient
        (in float32, as the JAX update multiplies its float32 rate) and
        may override the decay."""
        if self._state is None:
            self.init_state()
        for p, name, slots, scale, wd in zip(
                self._parameters, self._param_names, self._state,
                self._lr_scales, self._wd_overrides):
            if p.grad is None or not p.requires_grad:
                continue
            if not slots and self._init_state_for(p):
                # an optimizer with slots gives a trainable parameter at
                # least one: an empty dict is then a parameter that was
                # frozen when the slots were made (the reference raises a
                # bare KeyError from its rule here); SGD has none
                raise RuntimeError(
                    f"parameter {name!r} has a grad but no optimizer "
                    f"state: it was frozen when the state was made. "
                    f"Rebuild the optimizer (or call init_state()) after "
                    f"unfreezing it")
            dec = self._decayed(name)
            if scale == 1.0:
                lr_i = lr
            elif isinstance(lr, torch.Tensor):
                lr_i = lr * f32(scale)
            else:
                lr_i = f32(np.float32(lr) * np.float32(scale))
            wd_i = self._weight_decay if wd is None else wd
            gf = p.grad.float()
            pf = slots["master"] if "master" in slots else p.detach().float()
            gf = self._pre_grad(gf, pf, dec, wd_i)
            new_p, new_slots = self._rule(gf, pf, dict(slots), lr_i, step)
            new_p = self._post_param(new_p, pf, dec, lr_i, wd_i)
            for s, t in new_slots.items():
                if t is not slots[s]:
                    slots[s].copy_(t)
            if "master" in slots:
                slots["master"].copy_(new_p)
            p.copy_(new_p)

    # --------------------------------------------------------------- eager
    def _clip_grads(self):
        """Clip, in place, the grads of the parameters with need_clip."""
        if self._grad_clip is not None:
            self._grad_clip.clip_([p.grad for p, c in zip(
                self._parameters, self._need_clip)
                if c and p.grad is not None])

    def step(self):
        """One eager step on the parameters' `.grad` tensors: clip, then
        update in place."""
        if all(p.grad is None for p in self._parameters):
            return
        self._step_count += 1
        self._clip_grads()
        self.update(self.get_lr(), self._step_count)

    def clear_grad(self, set_to_zero=False):
        """Drop every parameter's gradient (`set_to_zero` is taken and
        changes nothing, as in the JAX package)."""
        for p in self._parameters:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """loss.backward(), then step() and clear_grad(); in static mode
        (`enable_static`), register the training op of the current
        Program instead (`static_graph.register_minimize`), which each
        `Executor.run` replays.  The other arguments are taken and
        ignored."""
        from ..framework import static_graph
        if static_graph.enabled():
            return static_graph.register_minimize(self, loss)
        loss.backward()
        self.step()
        self.clear_grad()

    # ----------------------------------------------------------- checkpoint
    def state_dict(self):
        """{"step": steps taken, "{param name}/{slot}": the slot tensor
        itself (no copy), "LR_Scheduler": the scheduler's state when the
        rate is one}.  Slots appear once they exist (the first step or
        `init_state`)."""
        out = {"step": self._step_count}
        if self._state is not None:
            for name, slots in zip(self._param_names, self._state):
                for s, t in slots.items():
                    out[f"{name}/{s}"] = t
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        """Load `state_dict`'s keys: the step count, every slot whose key
        is present (a tensor or an array of the slot's shape, copied into
        the slot in place; the slots are made first if needed) and the
        scheduler's state."""
        self._step_count = int(state.get("step", 0))
        if self._state is None:
            self.init_state()
        for name, slots in zip(self._param_names, self._state):
            for s, t in slots.items():
                v = state.get(f"{name}/{s}")
                if v is not None:
                    if not isinstance(v, torch.Tensor):
                        v = torch.from_numpy(np.array(v, dtype=np.float32))
                    t.copy_(v)
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
