"""Per-parameter attributes (counterpart: `paddle_tpu/framework/param_attr.py:12-37`).

`ParamAttr.apply_to(param)` stamps the fields the optimizer reads onto a
torch `Parameter`: `optimize_attr` holds a learning-rate factor, a
regularizer and `need_clip` (each only when it differs from the
default), `trainable=False` turns `requires_grad` off, and `name`
(stored as `paddle_name`: a torch tensor's `name` is read-only) names the
parameter in the optimizer's state dict.  `Optimizer` folds them in
when it is built (`optimizer/optimizer.py`).  The layers'
`weight_attr=` / `bias_attr=` arguments are not ported yet; the
initializer is kept and not applied, as it is only read there.
"""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = float(learning_rate)
        self.regularizer = regularizer
        self.trainable = bool(trainable)
        self.need_clip = need_clip

    def apply_to(self, param):
        """Stamp this attr's fields onto `param`; returns it."""
        if self.name:
            param.paddle_name = self.name
        param.requires_grad_(self.trainable)
        oa = {}
        if self.learning_rate != 1.0:
            oa["learning_rate"] = self.learning_rate
        if self.regularizer is not None:
            oa["regularizer"] = self.regularizer
        if self.need_clip is False:
            oa["need_clip"] = False
        if oa:
            param.optimize_attr = oa
        return param
