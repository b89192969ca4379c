"""Gradient clipping by global norm.

Counterpart: `paddle_tpu/nn/clip.py::ClipGradByGlobalNorm` (`:48`), which
the optimizer applies right before its update.  The port clips the
`.grad` tensors in place; the norm stays a device tensor, so clipping
never waits for the card.
"""
from __future__ import annotations

import torch


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
