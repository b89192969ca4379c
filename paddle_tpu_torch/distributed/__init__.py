"""Distributed training pieces of the port (counterpart:
`paddle_tpu/distributed`).  It holds activation recomputation and, in
`launch.heartbeat`, the liveness beat of the serving tier; collectives,
meshes and ring attention are later slices."""
from .recompute import recompute

__all__ = ["recompute"]
