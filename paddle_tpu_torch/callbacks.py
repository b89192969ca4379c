"""paddle.callbacks: `hapi.callbacks` re-exported (counterpart:
`paddle_tpu/callbacks.py`)."""
from .hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler"]
