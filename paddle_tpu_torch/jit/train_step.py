"""The training step: forward, backward, clip and update in one call.

Counterpart: `paddle_tpu/jit/train_step.py:24-251`, where one jitted XLA
program does the whole step with the parameters and optimizer state
donated.  PyTorch runs eagerly: the forward runs `loss_fn(model, *batch)`
under autograd, `backward()` leaves the grads on the parameters, the
optimizer's grad clip scales them in place, the update writes the new
parameters and slots in place (the port's stand-in for donation), and the
grads are reset to None so their memory returns before the next
forward.  The step follows the device of the model's parameters and
returns the loss as a 0-dim tensor there, without waiting for the card.

The step counter is the optimizer's (`optimizer._step_count`), so an
optimizer state carried in with its step resumes the bias corrections
where they were.  The nonfinite guard, the persistent compile cache and
the chaos sites of the JAX step are later slices of the port.
"""
from __future__ import annotations


class TrainStep:
    """step = TrainStep(model, loss_fn, optimizer); loss = step(*batch)

    `loss_fn(model, *batch)` returns a scalar loss tensor."""

    def __init__(self, model, loss_fn, optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        # name the optimizer's parameters as the model does, so that
        # apply_decay_param_fun sees "gpt.h.0.attn.qkv_proj.weight", ...
        names = {id(p): n for n, p in model.named_parameters()}
        optimizer._param_names = [
            names.get(id(p), old) for p, old in zip(optimizer._parameters,
                                                    optimizer._param_names)]
        self._params = [p for p in model.parameters() if p.requires_grad]

    @property
    def step_count(self):
        return self.optimizer._step_count

    def __call__(self, *batch):
        opt = self.optimizer
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        opt._step_count += 1
        opt._clip_grads()
        opt.update(opt.get_lr(), opt._step_count)
        for p in self._params:
            p.grad = None
        return loss.detach()

    def state_dict(self):
        return {"opt_state": self.optimizer._state,
                "step": self.optimizer._step_count}


def train_step(model, loss_fn, optimizer):
    return TrainStep(model, loss_fn, optimizer)
