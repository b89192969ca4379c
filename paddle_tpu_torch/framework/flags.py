"""Global config flags (counterpart: `paddle_tpu/framework/flags.py`;
reference: paddle/phi/core/flags + FLAGS_* env vars).

The same store with the same keys and environment variables.
`check_numerics` is read by `framework.debugging` and, on their first
call, by `jit.TrainStep` and the fleet's `DistributedTrainStep`;
`matmul_precision` is the JAX package's TPU matmul setting, which the
port does not read (torch's own is
`torch.set_float32_matmul_precision`).
"""
from __future__ import annotations

import os

_FLAGS = {
    # inject finite-checks on losses/grads (failure detection subsystem)
    "check_numerics": os.environ.get("PT_CHECK_NUMERICS", "0") == "1",
    # the JAX package's matmul precision ("default" | "high" | "highest")
    "matmul_precision": os.environ.get("PT_MATMUL_PRECISION", "default"),
}


def set_flags(d: dict):
    _FLAGS.update(d)


def get_flags(name: str):
    return _FLAGS.get(name)
