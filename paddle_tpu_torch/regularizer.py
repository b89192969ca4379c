"""Weight-decay regularizers the optimizers take as `weight_decay`.

Counterpart: `paddle_tpu/regularizer.py`, which re-exports `L2Decay` and
`L1Decay` from `paddle_tpu/optimizer/optimizer.py` (`:292-301`), and
`_decay_value` there (`:281-289`).  `L2Decay(coeff)` holds the decay
coefficient the optimizers apply (coupled, g + coeff * p, in Adam and
Momentum; decoupled in AdamW); `L1Decay` is accepted as a class and
raises NotImplementedError where an optimizer reads it, as in the JAX
package, since no update rule applies L1 decay.
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    """L2 weight decay with coefficient `coeff`."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)


class L1Decay:
    """L1 weight decay: accepted, and refused by every optimizer."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)


def _decay_value(weight_decay):
    """The decay coefficient of a `weight_decay` argument: None -> 0.0, a
    float as it is, an L2Decay its coefficient; an L1Decay raises."""
    if weight_decay is None:
        return 0.0
    if isinstance(weight_decay, L1Decay):
        raise NotImplementedError(
            "L1Decay regularization is not implemented (the optimizers "
            "apply L2-style decay); use L2Decay")
    coeff = getattr(weight_decay, "_coeff", None)
    return float(coeff if coeff is not None else weight_decay)
