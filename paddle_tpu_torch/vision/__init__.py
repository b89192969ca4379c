"""Vision models of the port (counterpart: `paddle_tpu/vision`)."""
from . import models

__all__ = ["models"]
