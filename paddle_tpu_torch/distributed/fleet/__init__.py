"""Fleet (counterpart: `paddle_tpu/distributed/fleet/__init__.py`).

`fleet.init(strategy=)` builds the global mesh from `hybrid_configs`
(dp, pp, mp, ep degrees; their product may not exceed the world size)
and sets the `mesh_axis_degree{axis}` gauges; `build_train_step` returns
the `DistributedTrainStep` for the strategy.  `HybridCommunicateGroup`
answers with this rank's real coordinates and the axes' process groups.
"""
from __future__ import annotations

from .. import mesh as mesh_mod
from ..fleet_engine import DistributedTrainStep
from ..recompute import recompute


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sharding_stage": 0,
            "sep_degree": 1, "ep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.pipeline_configs = {"accumulate_steps": 1}
        self.sharding = False
        self.sharding_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}


class _Fleet:
    def __init__(self):
        self._strategy = None
        self._initialized = False

    def init(self, role_maker=None, is_collective=True, strategy=None):
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        mesh_mod.build_mesh(dp=int(hc.get("dp_degree", 1) or 1),
                            pp=int(hc.get("pp_degree", 1) or 1),
                            mp=int(hc.get("mp_degree", 1) or 1),
                            ep=int(hc.get("ep_degree", 1) or 1))
        from ...observability import metrics
        reg = metrics.registry()
        for ax in ("dp", "mp", "pp", "ep"):
            reg.gauge("mesh_axis_degree", axis=ax).set(mesh_mod.degree(ax))
        self._initialized = True
        return self

    @property
    def strategy(self):
        return self._strategy

    def distributed_model(self, model):
        model._fleet_strategy = self._strategy
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        optimizer._fleet_strategy = strategy or self._strategy
        return optimizer

    def build_train_step(self, model, loss_fn, optimizer, guard=None):
        return DistributedTrainStep(model, loss_fn, optimizer,
                                    strategy=self._strategy, guard=guard)

    def worker_num(self):
        from .. import get_world_size
        return get_world_size()

    def worker_index(self):
        from .. import get_rank
        return get_rank()

    def get_hybrid_communicate_group(self):
        return HybridCommunicateGroup(self._strategy)


class HybridCommunicateGroup:
    """This rank's place on the mesh (`:17-149`)."""

    def __init__(self, strategy):
        self._s = strategy

    def get_data_parallel_world_size(self):
        return mesh_mod.degree("dp")

    def get_model_parallel_world_size(self):
        return mesh_mod.degree("mp")

    def get_pipe_parallel_world_size(self):
        return mesh_mod.degree("pp")

    def get_expert_parallel_world_size(self):
        return mesh_mod.degree("ep")

    def get_data_parallel_rank(self):
        return mesh_mod.axis_rank("dp")

    def get_model_parallel_rank(self):
        return mesh_mod.axis_rank("mp")

    def get_stage_id(self):
        return mesh_mod.axis_rank("pp")

    def get_data_parallel_group(self):
        return _AxisGroup("dp")

    def get_model_parallel_group(self):
        return _AxisGroup("mp")

    def get_pipe_parallel_group(self):
        return _AxisGroup("pp")

    def get_expert_parallel_group(self):
        return _AxisGroup("ep")


class _AxisGroup:
    """One mesh axis as a group: the collectives take it as `group=`."""

    def __init__(self, axis_name):
        self.axis_name = axis_name

    @property
    def nranks(self):
        return mesh_mod.degree(self.axis_name)

    @property
    def rank(self):
        return mesh_mod.axis_rank(self.axis_name)

    @property
    def pg(self):
        return mesh_mod.axis_group(self.axis_name)


fleet = _Fleet()
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
build_train_step = fleet.build_train_step
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group
worker_num = fleet.worker_num
worker_index = fleet.worker_index


class utils:
    recompute = staticmethod(recompute)


from .. import parallel_layers as meta_parallel  # noqa: E402,F401
from ..parallel_layers import (  # noqa: E402,F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding)
