"""Vision of the port (counterpart: `paddle_tpu/vision`): the models,
the datasets and the transforms; the models are also bound here, as the
reference star-imports them (`paddle_tpu/vision/__init__.py:2`)."""
from . import datasets, models, transforms
from .models import *  # noqa: F401,F403
from .models import __all__ as _models_all

__all__ = ["datasets", "models", "transforms"] + list(_models_all)
