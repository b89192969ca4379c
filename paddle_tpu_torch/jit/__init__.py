"""The training step and inference export of the port (counterpart:
`paddle_tpu/jit`)."""
from .save_load import (InputSpec, TranslatedLayer, is_inference_dir,
                        load_inference, save_inference)
from .train_step import TrainStep, train_step

__all__ = ["InputSpec", "TrainStep", "TranslatedLayer", "is_inference_dir",
           "load_inference", "save_inference", "train_step"]
