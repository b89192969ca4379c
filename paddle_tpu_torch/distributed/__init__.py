"""Distributed training of the port: one process a rank over
`torch.distributed` (counterpart: `paddle_tpu/distributed`).

The JAX package is single-controller: one process drives every chip and
the ranks live inside XLA programs.  The port is multi-controller, as
torch is: `python -m paddle_tpu_torch.distributed.launch
--nproc_per_node N script.py` (or `spawn`) starts a process a rank, and
each calls `init_parallel_env()`, which reads the launcher's MASTER_ADDR,
MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK and joins the process group:
NCCL on the card, gloo only when asked (`backend="gloo"`, as the CPU
tests do).  Without a CUDA device and without `backend="gloo"` it
raises.  It also starts the heartbeat the launcher watches (`:59-64`).

  collective       the collectives, their timeout / retry policy, the
                   chaos sites and the payload accounting
  mesh             the ("dp", "pp", "mp") DeviceMesh and its axis groups
  parallel_layers  column-, row- and vocab-parallel layers,
                   ParallelCrossEntropy, the Megatron f / g pair
  parallel         DataParallel
  fleet            DistributedStrategy, fleet.init, build_train_step,
                   HybridCommunicateGroup
  fleet_engine     DistributedTrainStep: dp x mp x sp x cp, ZeRO 1-2
  sharding         group_sharded_parallel, save_group_sharded_model
  ring_attention   context parallelism over the flash blocks
  launch           the process launcher and the heartbeat
  recompute        activation recomputation

`spawn(func, args, nprocs)` starts `nprocs` processes, each running
`func(*args)` as one rank; the JAX package runs `func` once inline (an
intended divergence: the port has no single controller).  Pipeline
parallelism, ZeRO 3 and `auto_parallel` are not ported yet (ROADMAP.md
A11).
"""
from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from . import collective, mesh  # noqa: F401
from .collective import (CollectivePolicy, CollectiveTimeout, ReduceOp,
                         all_gather, all_gather_object, all_reduce, alltoall,
                         alltoall_single, barrier, broadcast,
                         broadcast_object_list, collective_policy,
                         configure_collectives, destroy_process_group,
                         get_group, irecv, isend, ppermute, recv, reduce,
                         reduce_scatter, scatter, scatter_object_list, send,
                         split, stream_synchronize)
from .mesh import build_mesh, get_mesh, set_mesh
from .parallel import DataParallel
from .parallel_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                              RowParallelLinear, VocabParallelEmbedding,
                              shard_activation)
from .recompute import recompute
from .ring_attention import ring_attention, ring_attention_local

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_parallel_env(backend=None, timeout=None):
    """Join the process group the launcher described (world size 1, rank
    0, a free local port when launched without one).  `backend` None is
    NCCL, which needs a CUDA device; "gloo" runs on the CPU.  `timeout`
    (seconds) bounds every collective of the group (torch's default when
    None)."""
    if is_initialized():
        return
    from .launch.heartbeat import start_heartbeat
    start_heartbeat()
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_parallel_env: no CUDA device for NCCL; pass "
                "backend='gloo' to run the ranks on the CPU")
        backend = "nccl"
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT") or str(_free_port())
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {} if timeout is None else \
        {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank, **kw)


def get_rank():
    return dist.get_rank() if is_initialized() else 0


def get_world_size():
    return dist.get_world_size() if is_initialized() else 1


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def new_group(ranks=None, backend=None):
    """A group of global `ranks` (every rank when None); every rank of
    the world calls it, as torch's `new_group` requires."""
    ranks = list(range(get_world_size())) if ranks is None else list(ranks)
    pg = dist.new_group(ranks, backend=backend) if is_initialized() \
        else None
    return collective._Group(ranks, pg=pg)


def _spawn_entry(index, func, args, nprocs, port, backend):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(index), LOCAL_RANK=str(index),
                      WORLD_SIZE=str(nprocs))
    if backend is not None:
        init_parallel_env(backend)
    func(*args)


def spawn(func, args=(), nprocs=1, join=True, backend=None, **options):
    """Start `nprocs` processes (the card count when < 1), rank i running
    `func(*args)` with the launcher's environment; with `backend` each
    joins the process group first.  `func` must be importable (a
    module-level function).  Returns the process context (joined when
    `join`)."""
    import torch.multiprocessing as tmp
    if nprocs < 1:
        nprocs = max(torch.cuda.device_count(), 1)
    return tmp.start_processes(
        _spawn_entry, args=(func, tuple(args), nprocs, _free_port(),
                            backend),
        nprocs=nprocs, join=join, start_method="spawn")


class ParallelEnv:
    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return int(os.environ.get("LOCAL_RANK", "0"))

    local_rank = device_id
    nranks = world_size


from . import fleet, launch, sharding  # noqa: E402,F401
from .fleet_engine import DistributedTrainStep  # noqa: E402,F401
