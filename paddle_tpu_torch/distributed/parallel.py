"""Eager data parallelism (counterpart: `paddle_tpu/distributed/
parallel.py:18-77`).

    model = DataParallel(model)
    loss = loss_fn(model(x), y)
    loss.backward()
    model.apply_collective_grads()   # average the grads over the ranks
    opt.step()

Each rank feeds its own rows; `apply_collective_grads` averages every
gradient over the group (the world by default) with one all-reduce a
parameter.  With one rank it does nothing.  `no_sync` and `scale_loss`
keep the reference's surface and change nothing (the averaging is
explicit), and `state_dict` / `set_state_dict` pass through to the
wrapped model, whose names stay unprefixed.
"""
from __future__ import annotations

import contextlib

from torch import nn

from . import collective


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._group = group
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict

    def scale_loss(self, loss):
        """The loss as it is: the gradients are averaged, not summed."""
        return loss

    def apply_collective_grads(self):
        """Average every gradient over the group, in place."""
        for p in self._layers.parameters():
            if p.grad is not None:
                collective.all_reduce(p.grad, op=collective.ReduceOp.AVG,
                                      group=self._group)

    def no_sync(self):
        return contextlib.nullcontext()
