"""The global random state: seed, save and restore.

Counterpart: `paddle_tpu/framework/random.py:20-59`, whose state is one
threefry key and the seed it came from.  Here the state is PyTorch's
default CPU generator, the default CUDA generator of every device once
CUDA is in use, and the seed: `seed` reseeds them all, as
`paddle_tpu.seed` resets the key stream.  Code that takes an explicit
`torch.Generator` (model initialisation, `generator=` arguments) is
outside this state; dropout with no generator draws from it.  Threefry
and Philox never give the same numbers, so a state does not cross
between the packages.
"""
from __future__ import annotations

import hashlib

import torch

_state = {"seed": 0}


def seed(s):
    """Seed the CPU generator and every CUDA device's; returns s."""
    torch.manual_seed(int(s))
    _state["seed"] = int(s)
    return s


def get_rng_state():
    """{"cpu": the CPU generator's state, "cuda": [each CUDA device's
    state] (empty while CUDA is not initialised), "seed": the last seed}.
    The states are uint8 CPU tensors, copies that later draws leave
    alone."""
    cuda = (torch.cuda.get_rng_state_all() if torch.cuda.is_initialized()
            else [])
    return {"cpu": torch.get_rng_state(), "cuda": list(cuda),
            "seed": _state["seed"]}


def set_rng_state(st):
    """Restore a `get_rng_state()`: the CPU generator, each CUDA device's
    that the state holds and this process has, and the seed."""
    torch.set_rng_state(st["cpu"])
    if st.get("cuda") and torch.cuda.is_available():
        for i, s in enumerate(st["cuda"][:torch.cuda.device_count()]):
            torch.cuda.set_rng_state(s, i)
    _state["seed"] = int(st.get("seed", 0))


def fold(n):
    """Reseed every generator from the current CPU state and the ordinal
    `n`: the analog of `jax.random.fold_in(key, n)`, deterministic in
    both, different for every n.  The seed `get_rng_state` reports stays
    as it was, as the JAX package keeps it."""
    digest = hashlib.blake2b(
        torch.get_rng_state().numpy().tobytes()
        + int(n).to_bytes(8, "little", signed=True), digest_size=8).digest()
    torch.manual_seed(int.from_bytes(digest, "little") >> 1)
