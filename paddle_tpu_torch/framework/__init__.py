"""Training-state plumbing of the port (counterpart:
`paddle_tpu/framework`): the random state, checkpoints and `ParamAttr`."""
from . import checkpoint, random
from .checkpoint import (CheckpointError, async_save, load_state, probe,
                         save_state)
from .param_attr import ParamAttr
from .random import get_rng_state, seed, set_rng_state

__all__ = ["CheckpointError", "ParamAttr", "async_save", "checkpoint",
           "get_rng_state", "load_state", "probe", "random", "save_state",
           "seed", "set_rng_state"]
