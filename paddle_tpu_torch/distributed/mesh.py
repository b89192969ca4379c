"""The global device mesh: ranks laid out over the axes ("dp", "pp", "mp"),
plus "ep" when an expert axis is asked for.

Counterpart: `paddle_tpu/distributed/mesh.py`, where one
`jax.sharding.Mesh` over the devices of one controller names the axes.
The port runs a process a rank: the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the global ranks
0 .. dp*pp*mp*ep - 1 in the same order (mp varies fastest), and an axis'
process group (`axis_group`) is what the collectives and the parallel
layers talk over.  The product may not exceed the world size
(`mesh.py:27-30`).  With one rank in the world, or no process group at
all, the mesh is a `LocalMesh`, which needs none: every axis has
degree 1 and rank 0.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

AXES = ("dp", "pp", "mp")

_state = {"mesh": None, "degrees": None}


class LocalMesh:
    """A mesh of one rank, for a process without a process group."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.mesh_dim_names = tuple(axes)

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def build_mesh(dp=1, pp=1, mp=1, ep=1, devices=None):
    """Lay the first dp*pp*mp*ep ranks out as [dp, pp, mp(, ep)] and
    install the mesh.  `devices` is taken for the JAX package's signature:
    the ranks are the devices here.  Raises ValueError when the product
    exceeds the world size."""
    n = dp * pp * mp * ep
    world = _world()
    if n > world:
        raise ValueError(f"hybrid degrees dp{dp}*pp{pp}*mp{mp}*ep{ep}={n} "
                         f"> {world} ranks")
    shape = (dp, pp, mp) + ((ep,) if ep > 1 else ())
    axes = AXES + (("ep",) if ep > 1 else ())
    if world == 1:
        mesh = LocalMesh(shape, axes)
    else:
        from torch.distributed.device_mesh import DeviceMesh
        backend = dist.get_backend()
        device_type = "cuda" if backend == "nccl" else "cpu"
        mesh = DeviceMesh(device_type, torch.arange(n).reshape(shape),
                          mesh_dim_names=axes)
    _state["mesh"] = mesh
    _state["degrees"] = {"dp": dp, "pp": pp, "mp": mp, "ep": ep}
    return mesh


def get_mesh():
    """The installed mesh; a data-parallel mesh over every rank when none
    is (`mesh.py:43-46`)."""
    if _state["mesh"] is None:
        build_mesh(dp=_world())
    return _state["mesh"]


def set_mesh(mesh):
    _state["mesh"] = mesh
    names = mesh.mesh_dim_names
    shape = mesh.shape if isinstance(mesh, LocalMesh) else \
        dict(zip(names, mesh.mesh.shape))
    _state["degrees"] = {a: int(shape[a]) for a in names}


def clear_mesh():
    _state["mesh"] = None
    _state["degrees"] = None


def degree(axis) -> int:
    if _state["degrees"] is None:
        return 1
    return _state["degrees"].get(axis, 1)


def has_mesh() -> bool:
    return _state["mesh"] is not None


def axis_group(axis):
    """The process group of this rank's line along `axis`; None when the
    axis has degree 1 or there is no mesh."""
    if degree(axis) <= 1:
        return None
    return _state["mesh"].get_group(axis)


def axis_rank(axis) -> int:
    """This rank's index along `axis` (0 when the axis has degree 1)."""
    if degree(axis) <= 1:
        return 0
    return _state["mesh"].get_local_rank(axis)
