"""Vision of the port (counterpart: `paddle_tpu/vision`): the models,
the datasets and the transforms."""
from . import datasets, models, transforms

__all__ = ["datasets", "models", "transforms"]
