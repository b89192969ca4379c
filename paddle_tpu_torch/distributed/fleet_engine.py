"""The hybrid-parallel training step (counterpart: `paddle_tpu/
distributed/fleet_engine.py`).

The JAX step is one pjit program over the global mesh, with GSPMD
inserting the collectives.  The port's runs eagerly on every rank, with
the collectives written out, reading the strategy as the reference does
(`:95-150`):

- dp: the step takes the global batch and keeps the rows of its dp rank
  (`batch_axis`, 0 by default); after the backward the gradients are
  averaged over dp, and the returned loss is the dp mean, the loss of
  the whole batch.
- mp: the model's parallel layers hold their shards and talk over the mp
  axis themselves (`parallel_layers`); the step all-reduces over mp the
  gradients that are partial sums over sequence shards: every gradient
  under context parallelism, the `sequence_parallel` parameters under
  Megatron-SP.  Each rank updates its own shards: the optimizer's rule
  must then be elementwise: Adafactor's factored moments and Lamb's
  trust ratio read a whole tensor, and raise at mp > 1 on a split
  parameter.
- ZeRO (`sharding_stage` 1-2, or `sharding_degree` > 1): each dp rank
  owns whole parameters, assigned greedily by size, and keeps the
  optimizer state of those alone, as `ZeroRedundancyOptimizer` does;
  this suits every rule, Adafactor's too, and gives the numbers of the
  reference's axis split.  Stage 1 all-reduces the gradients, stage 2
  reduces each one to its owner only; the owner updates the parameter
  and broadcasts it over dp.
- Gradient clipping by global norm (or by each tensor's norm) takes its
  norms over the whole parameters: split pieces are summed over mp, and
  owned pieces over dp.

`state_dict()` / `set_state_dict()` hold the optimizer's state as whole
tensors (gathered from the owners and the mp pieces), under the keys of
the optimizer's own `state_dict` ("step", "{param}/{slot}",
"LR_Scheduler"), so a state crosses between degrees and into a plain
`TrainStep`.  `pp_degree` > 1, ZeRO stage 3 and the nonfinite guard
raise NotImplementedError (ROADMAP.md A11).  With dp 1 and mp 1 the step
is `TrainStep`'s, op for op.  `check_numerics` checks the gradients
after their reduction and before the clip and the update, as
`TrainStep` does; the flags are combined over the world with a MIN
all-reduce, so every rank raises the same error (the JAX step checks
its global arrays).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..framework import debugging as _dbg
from ..jit.train_step import check_step
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm
from ..optimizer.optimizer import _LOW
from . import mesh as mesh_mod
from .parallel_layers import parallel_parameters


def _owners(params, n):
    """The dp rank owning each parameter: the largest first, each to the
    least loaded rank (the same on every rank)."""
    load, owner = [0] * n, [0] * len(params)
    for i in sorted(range(len(params)), key=lambda i: -params[i].numel()):
        r = min(range(n), key=lambda r: load[r])
        owner[i] = r
        load[r] += params[i].numel()
    return owner


class DistributedTrainStep:
    """step = DistributedTrainStep(model, loss_fn, optimizer, strategy);
    loss = step(*global_batch)"""

    def __init__(self, model, loss_fn, optimizer, strategy=None,
                 batch_axis=0, guard=None):
        from ..resilience import guard as _guard_mod
        if guard is not None or _guard_mod.env_guard() is not None:
            raise NotImplementedError(
                "the nonfinite guard under the fleet step is not ported "
                "yet (ROADMAP.md A11)")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.strategy = strategy
        self.batch_axis = batch_axis
        self._check_numerics = None      # read on the first call
        hc = strategy.hybrid_configs if strategy is not None else {}
        self.sharding_stage = int(hc.get("sharding_stage", 0) or 0)
        if int(hc.get("sharding_degree", 1) or 1) > 1 and \
                self.sharding_stage == 0:
            self.sharding_stage = 1
        if mesh_mod.degree("pp") > 1:
            raise NotImplementedError(
                "pp_degree > 1: pipeline parallelism is not ported yet "
                "(ROADMAP.md A11)")
        if self.sharding_stage >= 3:
            raise NotImplementedError(
                "sharding_stage 3 (ZeRO 3, parameters sharded) is not "
                "ported yet (ROADMAP.md A11)")
        self.dp, self.mp = mesh_mod.degree("dp"), mesh_mod.degree("mp")
        self._dp_rank = mesh_mod.axis_rank("dp")
        self._dp_pg = mesh_mod.axis_group("dp")
        self._mp_pg = mesh_mod.axis_group("mp")
        optimizer._name_after(model)
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._split = {id(getattr(m, a)): (m, a)
                       for m, a in parallel_parameters(model).values()}
        self._sp = [p for p in self._params
                    if getattr(p, "sequence_parallel", False)]
        cfg = getattr(model, "cfg", None)
        self._cp = self.mp > 1 and bool(getattr(cfg, "context_parallel",
                                                False))
        if self.mp > 1 and getattr(optimizer, "_whole_tensor_rule", False) \
                and any(id(p) in self._split for p in optimizer._parameters):
            raise NotImplementedError(
                f"{type(optimizer).__name__}'s rule reads whole tensors; "
                f"under mp > 1 the port updates each rank's pieces, which "
                f"needs an elementwise rule (ROADMAP.md A11)")
        self._zero = self.sharding_stage >= 1 and self.dp > 1
        self._owner = _owners(optimizer._parameters, self.dp) \
            if self._zero else None
        if optimizer._state is None:
            optimizer.init_state()
        if self._zero:
            for i, owner in enumerate(self._owner):
                if owner != self._dp_rank:
                    optimizer._state[i] = {}

    @property
    def step_count(self):
        return self.optimizer._step_count

    def _owner_rank(self, i):
        return dist.get_global_rank(self._dp_pg, self._owner[i])

    def _local_batch(self, batch):
        if self.dp == 1:
            return batch
        out = []
        for b in batch:
            if isinstance(b, torch.Tensor) and b.dim() > 0:
                if b.shape[self.batch_axis] % self.dp:
                    raise ValueError(
                        f"batch dim {b.shape[self.batch_axis]} is not "
                        f"divisible by the dp degree {self.dp}")
                b = b.chunk(self.dp, dim=self.batch_axis)[self._dp_rank]
            out.append(b)
        return out

    @torch.no_grad()
    def _reduce_grads(self):
        if self._cp:
            partial = self._params
        elif self._mp_pg is not None:
            partial = self._sp
        else:
            partial = ()
        for p in partial:
            if p.grad is not None:
                dist.all_reduce(p.grad, group=self._mp_pg)
        if self._dp_pg is None:
            return
        for i, p in enumerate(self.optimizer._parameters):
            if p.grad is None:
                continue
            mine = not self._zero or self._owner[i] == self._dp_rank
            if self.sharding_stage >= 2:
                dist.reduce(p.grad, dst=self._owner_rank(i),
                            group=self._dp_pg)
            else:
                dist.all_reduce(p.grad, group=self._dp_pg)
            if mine:
                p.grad.div_(self.dp)
            else:
                p.grad = None

    @torch.no_grad()
    def _clip(self):
        opt = self.optimizer
        clip = opt._grad_clip
        if clip is None:
            return
        if self._dp_pg is None and self._mp_pg is None:
            opt._clip_grads()
            return
        mp_rank = mesh_mod.axis_rank("mp")
        pairs = [(p, p.grad) for p, c in zip(opt._parameters, opt._need_clip)
                 if c and p.grad is not None]
        if isinstance(clip, ClipGradByGlobalNorm):
            dev = pairs[0][1].device if pairs else self._params[0].device
            # a replicated piece counts once, on mp rank 0
            total = torch.zeros((), dtype=torch.float32, device=dev)
            for p, g in pairs:
                if id(p) in self._split or mp_rank == 0:
                    total += g.float().square().sum()
            if self._mp_pg is not None:
                dist.all_reduce(total, group=self._mp_pg)
            if self._zero:
                dist.all_reduce(total, group=self._dp_pg)
            scale = torch.clamp(
                clip.clip_norm / total.sqrt().clamp(min=1e-12), max=1.0)
            for _, g in pairs:
                g.copy_(g.float() * scale)
        elif isinstance(clip, ClipGradByNorm):
            for p, g in pairs:
                n2 = g.square().sum()
                if id(p) in self._split:
                    dist.all_reduce(n2, group=self._mp_pg)
                g.mul_(torch.clamp(clip.clip_norm / n2.sqrt().clamp(
                    min=1e-12), max=1.0))
        else:
            clip.clip_([g for _, g in pairs])

    @torch.no_grad()
    def _sync_params(self):
        if not self._zero:
            return
        for i, p in enumerate(self.optimizer._parameters):
            if p.requires_grad:
                dist.broadcast(p.detach(), src=self._owner_rank(i),
                               group=self._dp_pg)

    def __call__(self, *batch):
        opt = self.optimizer
        loss = self.loss_fn(self.model, *self._local_batch(batch))
        loss.backward()
        self._reduce_grads()
        opt._step_count += 1
        if self._check_numerics is None:
            self._check_numerics = _dbg.enabled()
        if self._check_numerics:
            world = dist.group.WORLD if dist.is_initialized() and \
                dist.get_world_size() > 1 else None
            check_step(self.model, loss, opt._step_count, group=world)
        lr = opt.get_lr()
        self._clip()
        opt.update(lr, opt._step_count)
        self._sync_params()
        for p in self._params:
            p.grad = None
        loss = loss.detach()
        if self._dp_pg is not None:
            dist.all_reduce(loss, group=self._dp_pg)
            loss.div_(self.dp)
        return loss

    def sync_model(self):
        """The JAX step's pipeline sync; the port's parameters are always
        current."""

    # ------------------------------------------------------- checkpoints
    def _slot_templates(self, p):
        opt = self.optimizer
        slots = opt._init_state_for(p)
        if opt._use_master_weights and p.dtype in _LOW:
            slots["master"] = p.detach().float()
        return slots

    @torch.no_grad()
    def state_dict(self):
        """The optimizer state as whole tensors (collective: every rank
        calls it)."""
        from ..optimizer.lr import LRScheduler
        opt = self.optimizer
        out = {"step": opt._step_count}
        if isinstance(opt._lr, LRScheduler):
            out["LR_Scheduler"] = opt._lr.state_dict()
        for i, (p, name) in enumerate(zip(opt._parameters,
                                          opt._param_names)):
            if not p.requires_grad:
                continue
            own = opt._state[i]
            for s, t in self._slot_templates(p).items():
                if self._zero:
                    t = own[s].clone() if s in own else t
                    dist.broadcast(t, src=self._owner_rank(i),
                                   group=self._dp_pg)
                else:
                    t = own[s]
                if id(p) in self._split and t.shape == p.shape:
                    layer, attr = self._split[id(p)]
                    t = layer.unshard(attr, t)
                out[f"{name}/{s}"] = t.detach().clone()
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        """Load `state_dict`'s keys: each rank keeps its own pieces of the
        slots it owns."""
        from ..optimizer.lr import LRScheduler
        opt = self.optimizer
        opt._step_count = int(state.get("step", 0))
        if "LR_Scheduler" in state and isinstance(opt._lr, LRScheduler):
            opt._lr.set_state_dict(state["LR_Scheduler"])
        for p, name, slots in zip(opt._parameters, opt._param_names,
                                  opt._state):
            for s, t in slots.items():
                v = state.get(f"{name}/{s}")
                if v is None:
                    continue
                v = torch.as_tensor(v).to(t.device, torch.float32)
                if id(p) in self._split and v.shape != t.shape:
                    layer, attr = self._split[id(p)]
                    v = layer.shard(attr, v)
                t.copy_(v)
