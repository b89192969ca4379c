"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package `paddle_tpu` stays the reference; this package keeps its
layouts and parameter names so weights carry across name for name
(`weights.load_paddle_tpu_state`).  It imports torch and numpy only.

This slice holds the GPT serving path: the model (`text`), the paged KV
pool, scheduler and continuous-batching engine (`serving`), and the
paged decode attention kernel written in CUDA for sm_90a (`ops`).
"""
from .device import generator, resolve_device, seed

__all__ = ["generator", "resolve_device", "seed"]
