"""Failure detection: finite checks on the loss and the gradients.

Counterpart: `paddle_tpu/framework/debugging.py:17-54` (reference
surface: paddle.amp.debugging.check_numerics and FLAGS_check_nan_inf).
Turn it on with ``PT_CHECK_NUMERICS=1`` or
``set_flags({"check_numerics": True})``; the training steps read the
flag on their first call, as the JAX step reads it when it is built.
A step then builds one bool vector on the device (`finite_flags`: the
loss, then each gradient), reads it once on the host and raises
FloatingPointError with the names of what is not finite before any
weight is written (`raise_on_nonfinite`).  With the flag off a step
makes no extra launch and no host wait.
"""
from __future__ import annotations

import torch

from . import flags


def enabled() -> bool:
    return bool(flags.get_flags("check_numerics"))


@torch.no_grad()
def grad_flags(grads, device):
    """[len(grads)] bool vector on `device`: each gradient all-finite
    (None counts as finite).  Each run of consecutive gradients of one
    device and dtype goes through one multi-tensor infinity norm
    (`torch._foreach_norm`), which is NaN or inf exactly when a tensor
    holds a NaN or an inf, and one stack: a few launches for a whole
    model, whatever its number of tensors, in every floating dtype the
    card has (bfloat16 included)."""
    out = []
    run, key = [], None

    def flush():
        if run:
            norms = torch._foreach_norm(run, float("inf"))
            out.append(torch.isfinite(torch.stack(norms)).to(device))
            run.clear()

    nones = 0
    for g in grads:
        if g is None:
            flush()
            nones += 1
            continue
        if nones:
            out.append(torch.ones(nones, dtype=torch.bool, device=device))
            nones = 0
        if (g.device, g.dtype) != key:
            flush()
            key = (g.device, g.dtype)
        run.append(g.detach())
    flush()
    if nones:
        out.append(torch.ones(nones, dtype=torch.bool, device=device))
    return torch.cat(out) if out else torch.ones(0, dtype=torch.bool,
                                                 device=device)


@torch.no_grad()
def finite_flags(loss, grads):
    """[1 + len(grads)] bool vector on the loss's device: the loss
    all-finite, then each gradient (`grad_flags`)."""
    return torch.cat([torch.isfinite(loss.detach().float()).all().reshape(1),
                      grad_flags(grads, loss.device)])


def raise_on_nonfinite(flags_arr, names, step):
    """Read the flags once on the host; raise FloatingPointError naming
    the offenders (at most 8, then "(+k more)")."""
    ok = flags_arr.tolist() if isinstance(flags_arr, torch.Tensor) \
        else list(flags_arr)
    if all(ok):
        return
    labels = ["loss"] + list(names)
    bad = [labels[i] for i, f in enumerate(ok) if not f]
    raise FloatingPointError(
        f"check_numerics: non-finite values at step {step} in: "
        + ", ".join(bad[:8])
        + (f" (+{len(bad) - 8} more)" if len(bad) > 8 else ""))


def check_numerics(tensor, name="tensor"):
    """Eager check (the paddle.amp.debugging.check_numerics surface):
    raises FloatingPointError if `tensor` holds a NaN or an inf; a no-op
    returning `tensor` while the flag is off."""
    if not enabled():
        return tensor
    if not bool(torch.isfinite(tensor.detach()).all()):
        raise FloatingPointError(
            f"check_numerics: non-finite values in {name}")
    return tensor
