"""Fault injection and recovery for training runs (counterpart:
`paddle_tpu/resilience`, limited to what the port has):

  chaos     deterministic fault injection at named sites (seeded plans,
            PADDLE_TPU_CHAOS)
  guard     the nonfinite-step guard: a bad step becomes a no-op on the
            device; N bad steps in a row roll back to a checkpoint
  manager   CheckpointManager: step-numbered retention and GC, fall-back
            past torn checkpoints, the SIGTERM preemption flush
  backoff   exponential backoff and crash-loop detection (the serving
            router's respawns, the transport's retries)

The reference's `reshard` (a restore onto another mesh) comes with the
distributed slice.  `guard`, `manager` and `backoff` load when first used:
`framework.checkpoint` imports `chaos` from here.
"""
from __future__ import annotations

from . import chaos
from .chaos import ChaosInterrupt, ChaosPlan

chaos.plan_from_env()   # honour PADDLE_TPU_CHAOS=<spec> from the environment

__all__ = ["chaos", "guard", "manager", "backoff", "ChaosPlan",
           "ChaosInterrupt", "NonfiniteGuard", "CheckpointManager",
           "CheckpointError", "Backoff", "CrashLoopDetector"]

_LAZY = {
    "guard": ("paddle_tpu_torch.resilience.guard", None),
    "manager": ("paddle_tpu_torch.resilience.manager", None),
    "NonfiniteGuard": ("paddle_tpu_torch.resilience.guard",
                       "NonfiniteGuard"),
    "CheckpointManager": ("paddle_tpu_torch.resilience.manager",
                          "CheckpointManager"),
    "CheckpointError": ("paddle_tpu_torch.framework.checkpoint",
                        "CheckpointError"),
    "backoff": ("paddle_tpu_torch.resilience.backoff", None),
    "Backoff": ("paddle_tpu_torch.resilience.backoff", "Backoff"),
    "CrashLoopDetector": ("paddle_tpu_torch.resilience.backoff",
                          "CrashLoopDetector"),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib
    mod = importlib.import_module(mod_name)
    val = mod if attr is None else getattr(mod, attr)
    globals()[name] = val
    return val
