"""Activation recomputation.

Counterpart: `paddle_tpu/distributed/recompute.py:27-75`, which wraps the
call in `jax.checkpoint` and threads a saved RNG key into the re-run.
Here it is `torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`:
the forward keeps only the inputs, and the backward runs the forward
again.  The re-run must draw the same dropout masks: the global CPU and
CUDA generators are restored by checkpoint's `preserve_rng_state`, and
the explicit `torch.Generator`s that the port's dropout draws from
(`Dropout.generator`, `GPTAttention.generator`) are set back to their
state at the forward for the re-run and returned to where they were after
it.  Keyword arguments go to the function (`recompute(block, x,
return_aux=True)` carries a routed block's aux loss out of the
checkpoint); the re-run routes the same tokens the same way, since the
MoE router draws nothing at random.
"""
from __future__ import annotations

import contextlib

from torch import nn
from torch.utils.checkpoint import checkpoint


def _generators(function):
    """The explicit generators the modules of an nn.Module draw from."""
    found = {}
    if isinstance(function, nn.Module):
        for mod in function.modules():
            g = getattr(mod, "generator", None)
            if g is not None:
                found[id(g)] = g
    return list(found.values())


def recompute(function, *args, **kwargs):
    """recompute(layer_or_fn, *args, **kwargs) — run `function(*args,
    **kwargs)` without keeping its intermediates for the backward, which
    re-runs it under the random state of the forward (with
    `preserve_rng_state=False`: under the state it finds then).
    `use_reentrant` is taken and changes nothing, as in the JAX
    package."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    gens = _generators(function) if preserve else []
    at_forward = [g.get_state() for g in gens]

    @contextlib.contextmanager
    def rerun_rng():
        after = [g.get_state() for g in gens]
        for g, s in zip(gens, at_forward):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(gens, after):
                g.set_state(s)

    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          rerun_rng()), **kwargs)
