"""Telemetry of the port (counterpart: `paddle_tpu/observability`)."""
from . import metrics
from .metrics import registry

__all__ = ["metrics", "registry"]
