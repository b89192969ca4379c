"""The high-level training API (counterpart: `paddle_tpu/hapi/__init__.py`):
``Model(network).prepare(optimizer, loss, metrics)`` then `fit`,
`evaluate`, `predict`, `save` and `load`.

`fit` drives the port's `jit.train_step` (forward, backward, clip and
update in one call) over an `io.DataLoader`, which stages each batch on
the device ahead of the step.  Each loss stays on the device and is
read only at log boundaries (`log_freq`) and once at the end of the
epoch (`paddle_tpu/hapi/__init__.py:240-250`), so the host does not wait
for the card every step.  `evaluate` and `predict` run the forward
eagerly under `torch.no_grad()` in eval mode (the reference jits it);
the metrics follow the reference's split: `Metric.compute` on the
device, `update` and `accumulate` on the host.

The model's device is its network's (its first parameter's), else
`device.resolve_device(None)`; a dataset given to `fit` / `evaluate` /
`predict` gets a DataLoader that stages there, and a batch that arrives
elsewhere is moved there.

Reference behaviours kept: `prepare` stores `amp_configs` and ignores
them (decorate the model with `amp.decorate` yourself), and
`save(training=False)` calls `jit.save` without an `input_spec`, which
raises ValueError, as the reference's does.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import io as _io
from ..device import resolve_device
from ..metric import Metric
from ..tensor import Tensor  # noqa: F401  (the reference's name)
from . import callbacks as callbacks_mod  # noqa: F401  (re-exported)
from .callbacks import (Callback, CallbackList,  # noqa: F401
                        MetricsLogger, ModelCheckpoint, ProgBarLogger,
                        ResilienceCallback)

__all__ = ["Model"]


def _listify(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:      # numpy has no bfloat16
        t = t.float()
    return t.cpu().numpy()


class Model:
    """model = Model(network); model.prepare(opt, loss, metrics);
    model.fit(train_data, eval_data, epochs=E, batch_size=B)."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp_configs = None
        self._train_step = None
        self.stop_training = False
        self._save_dir = None
        param = next(iter(network.parameters()), None)
        self._device = param.device if param is not None \
            else resolve_device(None)

    # ------------------------------------------------------------- prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            ms = _listify(metrics)
            for m in ms:
                if not isinstance(m, Metric):
                    raise TypeError(f"metric {m!r} is not a Metric")
            self._metrics = ms
        self._amp_configs = amp_configs      # kept, not applied
        self._train_step = None              # rebuilt when needed
        return self

    # ----------------------------------------------------------- internals
    def _split_batch(self, batch):
        """(inputs, labels): one trailing label by default, as the
        reference; more with a `labels` spec."""
        batch = tuple(batch)
        n_lab = len(self._labels) if self._labels else 1
        if self._loss is None and not self._metrics:
            return batch, ()
        return batch[:-n_lab], batch[-n_lab:]

    def _to_device(self, batch):
        """The batch as a list, its tensors on the model's device."""
        out = []
        for b in _listify(batch) if not isinstance(batch, torch.Tensor) \
                else [batch]:
            if not isinstance(b, torch.Tensor):
                b = torch.as_tensor(np.asarray(b))
            if b.device != self._device:
                b = b.to(self._device, non_blocking=True)
            out.append(b)
        return out

    def _ensure_train_step(self):
        if self._train_step is not None:
            return
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer=..., loss=...) "
                               "before training")
        from ..jit.train_step import train_step as _make_train_step

        def loss_fn(network, *batch):
            inputs, labels = self._split_batch(batch)
            return self._loss(network(*inputs), *labels)

        self._train_step = _make_train_step(self.network, loss_fn,
                                            self._optimizer)

    @torch.no_grad()
    def _eval_outputs(self, batch):
        """{"loss": 0-d tensor, "m<i>": metric i's compute()} on the
        device."""
        inputs, labels = self._split_batch(batch)
        pred = self.network(*inputs)
        outs = {}
        if self._loss is not None:
            outs["loss"] = self._loss(pred, *labels)
        for i, m in enumerate(self._metrics):
            outs[f"m{i}"] = m.compute(pred, *labels)
        return outs

    def _update_metrics(self, outs):
        for i, m in enumerate(self._metrics):
            res = outs[f"m{i}"]
            m.update(*(res if isinstance(res, tuple) else (res,)))

    @torch.no_grad()
    def _predict_outputs(self, batch):
        out = self.network(*batch)
        if isinstance(out, (list, tuple)):
            return [_numpy(o) for o in out]
        return _numpy(out)

    def _as_loader(self, data, batch_size, shuffle, num_workers, drop_last):
        if data is None or isinstance(data, _io.DataLoader):
            return data
        return _io.DataLoader(data, places=self._device,
                              batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last)

    # ------------------------------------------------------------ batch API
    def train_batch(self, inputs, labels=None):
        self._ensure_train_step()
        self.network.train()
        loss = self._train_step(*self._to_device(
            _listify(inputs) + _listify(labels)))
        return float(loss)

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        outs = self._eval_outputs(self._to_device(
            _listify(inputs) + _listify(labels)))
        logs = {}
        if "loss" in outs:
            logs["loss"] = float(outs["loss"])
        self._update_metrics(outs)
        return logs

    def predict_batch(self, inputs):
        self.network.eval()
        return self._predict_outputs(self._to_device(inputs))

    # ------------------------------------------------------------------ fit
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None):
        assert train_data is not None, "train_data is required"
        loader = self._as_loader(train_data, batch_size, shuffle,
                                 num_workers, drop_last)
        eval_loader = self._as_loader(eval_data, batch_size, False,
                                      num_workers, False)
        self._ensure_train_step()
        self._save_dir = save_dir
        self.stop_training = False

        cbs = list(callbacks or [])
        if not any(isinstance(c, ProgBarLogger) for c in cbs):
            cbs.insert(0, ProgBarLogger(log_freq, verbose))
        if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbs):
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cblist = CallbackList(cbs, self, {
            "epochs": epochs, "steps": steps, "verbose": verbose})

        history = []
        try:
            cblist.call("on_train_begin", {})
            for epoch in range(epochs):
                if self.stop_training:
                    break
                cblist.call("on_epoch_begin", epoch, {})
                self.network.train()
                losses = []
                for step, batch in enumerate(loader):
                    if self.stop_training:
                        break   # early stop or preemption: at a batch
                    batch = self._to_device(batch)
                    cblist.call("on_train_batch_begin", step, {})
                    loss = self._train_step(*batch)
                    # the loss stays on the device; a log boundary reads
                    # it, the epoch's mean reads them all once
                    losses.append(loss)
                    logs = {"loss": float(loss)} \
                        if (step + 1) % log_freq == 0 else {}
                    cblist.call("on_train_batch_end", step, logs)
                epoch_logs = {"loss": float(torch.stack(losses).float()
                                            .mean()) if losses else 0.0}
                if eval_loader is not None and not self.stop_training \
                        and (epoch + 1) % eval_freq == 0:
                    eval_logs = self.evaluate(eval_loader,
                                              batch_size=batch_size,
                                              verbose=0, callbacks=cbs,
                                              _cblist=cblist)
                    epoch_logs.update({f"eval_{k}": v
                                       for k, v in eval_logs.items()})
                cblist.call("on_epoch_end", epoch, epoch_logs)
                history.append(epoch_logs)
        except BaseException:
            # telemetry and profiler callbacks release their state even
            # when a step raises
            cblist.call_safe("on_train_error", {})
            raise
        cblist.call("on_train_end", {})
        return history

    # ------------------------------------------------------------- evaluate
    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, _cblist=None):
        loader = self._as_loader(eval_data, batch_size, False,
                                 num_workers, False)
        cblist = _cblist or CallbackList(
            list(callbacks or [ProgBarLogger(log_freq, verbose)]), self,
            {"epochs": 0, "steps": None, "verbose": verbose})
        for m in self._metrics:
            m.reset()
        cblist.call("on_eval_begin", {})
        self.network.eval()
        losses = []
        for step, batch in enumerate(loader):
            batch = self._to_device(batch)
            cblist.call("on_eval_batch_begin", step, {})
            outs = self._eval_outputs(batch)
            logs = {}
            if "loss" in outs:
                logs["loss"] = float(outs["loss"])
                losses.append(logs["loss"])
            self._update_metrics(outs)
            cblist.call("on_eval_batch_end", step, logs)
        result = {}
        if losses:
            result["loss"] = float(np.mean(losses))
        for m in self._metrics:
            vals = m.accumulate()
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            result.update(dict(zip(m.name(), vals)))
        cblist.call("on_eval_end", result)
        return result

    # -------------------------------------------------------------- predict
    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._as_loader(test_data, batch_size, False,
                                 num_workers, False)
        self.network.eval()
        outputs = []
        cblist = CallbackList(list(callbacks or []), self,
                              {"epochs": 0, "steps": None,
                               "verbose": verbose})
        cblist.call("on_predict_begin", {})
        for step, batch in enumerate(loader):
            outputs.append(self._predict_outputs(self._to_device(batch)))
            cblist.call("on_predict_batch_end", step, {})
        cblist.call("on_predict_end", {})
        if stack_outputs and outputs:
            if isinstance(outputs[0], list):
                # several outputs: each field across the batches
                return [np.concatenate([o[i] for o in outputs], 0)
                        for i in range(len(outputs[0]))]
            return [np.concatenate(outputs, 0)]
        return outputs

    # ------------------------------------------------------------ save/load
    def save(self, path, training=True):
        """training: the network, optimizer and random state through
        `framework.save_state` (a directory); else `jit.save` of the
        network, which needs an `input_spec` and raises without one, as
        the reference's does."""
        if training:
            from ..framework import checkpoint as ckpt
            ckpt.save_state(path, model=self.network,
                            optimizer=self._optimizer)
        else:
            from .. import jit as _jit
            _jit.save(self.network, path)

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework import checkpoint as ckpt
        target = _SkipMismatchShim(self.network, path) if skip_mismatch \
            else self.network
        ckpt.load_state(path, model=target,
                        optimizer=None if reset_optimizer
                        else self._optimizer)

    def parameters(self):
        return list(self.network.parameters())

    def summary(self, input_size=None, dtype=None):
        n_params = sum(p.numel() for p in self.network.parameters())
        lines = [f"{type(self.network).__name__}: {n_params:,} parameters"]
        for name, layer in self.network.named_modules():
            if not name:
                continue
            ps = sum(p.numel() for p in layer.parameters(recurse=False))
            if ps:
                lines.append(f"  {name} ({type(layer).__name__}): {ps:,}")
        print("\n".join(lines))
        return {"total_params": n_params}


class _SkipMismatchShim:
    """The `load_state` target of `Model.load(skip_mismatch=True)`: it
    answers for every tensor of the checkpoint, and loads only those
    whose name and shape match the network."""

    def __init__(self, network, path):
        from ..framework import checkpoint as ckpt
        meta = ckpt.probe(path)
        arrays = torch.load(f"{path}/{ckpt._ARRAYS}", map_location="cpu",
                            weights_only=True)
        saved = ckpt._merge_state_dict(arrays.get("model", {}),
                                       meta.get("model"))
        self._network = network
        own = network.state_dict()
        self._keep = {k for k, v in saved.items() if k in own
                      and tuple(own[k].shape) == tuple(v.shape)}
        self._saved = saved

    def named_parameters(self, *a, **k):
        return self._network.named_parameters(*a, **k)

    def state_dict(self):
        own = self._network.state_dict()
        return {k: own[k] if k in self._keep else v
                for k, v in self._saved.items()}

    def load_state_dict(self, state_dict):
        self._network.load_state_dict(
            {k: v for k, v in state_dict.items() if k in self._keep},
            strict=False)
