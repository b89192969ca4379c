"""Distributed training pieces of the port (counterpart:
`paddle_tpu/distributed`).  This slice holds activation recomputation;
collectives, meshes and ring attention are later slices."""
from .recompute import recompute

__all__ = ["recompute"]
