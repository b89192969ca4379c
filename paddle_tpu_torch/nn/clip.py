"""Gradient clipping: by value, by each tensor's norm, by the global norm.

Counterpart: `paddle_tpu/nn/clip.py:26-60`, which the optimizer applies
right before its update.  The port clips the `.grad` tensors in place
(`clip_`), in each gradient's own dtype where the JAX classes compute in
it (by value, by norm) and in float32 for the global norm, as they do.
The optimizer hands over only the gradients whose parameter has
`need_clip` (a `ParamAttr` field).  Norms stay device tensors, so
clipping never waits for the card.
"""
from __future__ import annotations

import torch


class ClipGradByValue:
    """Clamp every element to [min, max]; `min` defaults to -max."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    @torch.no_grad()
    def clip_(self, grads):
        grads = [g for g in grads if g is not None]
        for g in grads:
            g.clamp_(self.min, self.max)
        return grads


class ClipGradByNorm:
    """Scale each gradient by min(clip_norm / max(||g||, 1e-12), 1), its
    norm taken in its own dtype (no float32 cast), as `jnp.sqrt(jnp.sum(
    jnp.square(g)))` takes it."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def clip_(self, grads):
        grads = [g for g in grads if g is not None]
        for g in grads:
            n = g.square().sum().sqrt()
            g.mul_(torch.clamp(self.clip_norm / n.clamp(min=1e-12),
                               max=1.0))
        return grads


class ClipGradByGlobalNorm:
    """Clip by the norm over every gradient; `group_name` is taken and
    changes nothing, as in the JAX package (one group)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def clip_(self, grads):
        """Scale `grads` (a list of tensors) in place by min(clip_norm /
        max(||grads||, 1e-12), 1), the norm taken in float32 over every
        gradient; returns them."""
        grads = [g for g in grads if g is not None]
        if grads:
            total = torch.stack([g.float().square().sum()
                                 for g in grads]).sum().sqrt()
            scale = torch.clamp(self.clip_norm / total.clamp(min=1e-12),
                                max=1.0)
            for g in grads:
                g.copy_(g.float() * scale)
        return grads
