"""Device resolution and random generators.

Counterparts: `paddle_tpu/device.py` (where the JAX package finds its
accelerator) and `paddle_tpu/framework/random.py` (its seeded key
stream).  The port runs on the card unless the caller names the CPU:
with no device given and no CUDA device present, `resolve_device`
raises instead of quietly running on the CPU.  Randomness goes through
explicit `torch.Generator`s, one per call site that wants it.
"""
from __future__ import annotations

import torch


def resolve_device(device=None):
    """`device` as a torch.device; None means the current CUDA device,
    and raises RuntimeError when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def generator(seed, device=None):
    """A torch.Generator on `device`, seeded with `seed`."""
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))


def seed(s):
    """Seed PyTorch's global generators (CPU and every CUDA device), as
    `paddle_tpu.seed` reseeds the JAX package's key stream.  Returns s."""
    torch.manual_seed(int(s))
    return s
