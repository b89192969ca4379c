"""`group_sharded_parallel` (counterpart: `paddle_tpu/distributed/
sharding.py`): ZeRO levels "os" (stage 1) and "os_g" (stage 2) set the
fleet strategy's `sharding_stage`, which `fleet.build_train_step` then
applies; "p_g_os" (stage 3) and `offload` raise NotImplementedError
(ROADMAP.md A11)."""
from __future__ import annotations

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=None, segment_size=None,
                           sync_comm=False):
    """Returns (model, optimizer, scaler), the strategy updated in place
    (`fleet.init` with a dp-only strategy first when none is)."""
    if level not in _LEVELS:
        raise ValueError(
            f"level must be one of {sorted(_LEVELS)} (os = optimizer "
            f"state, os_g = + gradients, p_g_os = + parameters)")
    if _LEVELS[level] >= 3:
        raise NotImplementedError(
            "level 'p_g_os' (ZeRO 3) is not ported yet (ROADMAP.md A11)")
    if offload:
        raise NotImplementedError("offload=True (host paging) is not "
                                  "supported")
    from . import fleet as fleet_mod
    from . import mesh as mesh_mod
    strategy = fleet_mod.fleet.strategy
    if strategy is None:
        strategy = fleet_mod.DistributedStrategy()
        dp = mesh_mod.degree("dp") if mesh_mod.has_mesh() else \
            mesh_mod._world()
        strategy.hybrid_configs["dp_degree"] = dp
        fleet_mod.fleet.init(is_collective=True, strategy=strategy)
    hc = strategy.hybrid_configs
    hc["sharding_stage"] = _LEVELS[level]
    if int(hc.get("sharding_degree", 1) or 1) <= 1:
        hc["sharding_degree"] = hc.get("dp_degree", 1)
    model._fleet_strategy = strategy
    optimizer._fleet_strategy = strategy
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Save the model (whole tensors: the parallel layers gather) with
    `framework.save_state`; `optimizer` may be the fleet step, whose
    `state_dict` gathers the owners' slots.  Every rank calls it; rank 0
    writes."""
    import torch.distributed as dist

    from ..framework import checkpoint
    model_sd = model.state_dict()
    opt_sd = optimizer.state_dict() if optimizer is not None else None
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    checkpoint.save_state(output, model=_Frozen(model_sd),
                          optimizer=None if opt_sd is None
                          else _Frozen(opt_sd))


class _Frozen:
    """A gathered state dict in the shape `save_state` reads."""

    def __init__(self, sd):
        self._sd = sd

    def state_dict(self):
        return self._sd

    def _name_after(self, model):
        """The names are the gathered state's already."""
