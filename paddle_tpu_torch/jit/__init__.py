"""The training step of the port (counterpart: `paddle_tpu/jit`)."""
from .train_step import TrainStep, train_step

__all__ = ["TrainStep", "train_step"]
