"""Process supervision helpers (counterpart: `paddle_tpu/distributed/
launch`).  This slice holds the heartbeat that the serving router's
replicas beat and watch; the multi-host process runner comes with the
distributed slice (ROADMAP.md, A11)."""
from .heartbeat import BeatWatch, Heartbeat

__all__ = ["BeatWatch", "Heartbeat"]
