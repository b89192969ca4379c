"""Training callbacks (counterpart: `paddle_tpu/hapi/callbacks.py`):
`Callback`, `CallbackList`, `ProgBarLogger`, `ModelCheckpoint`,
`EarlyStopping`, `MetricsLogger`, `ResilienceCallback` and
`LRScheduler`, with the reference's hooks and logs.

`MetricsLogger` keeps the reference's step-time histogram, step spans,
percentiles and throughput, and its memory gauge reads
`torch.cuda.memory_allocated()` on the card where the reference sums
`jax.live_arrays()`.  It also records how long the trainer waited for
each batch (from the end of one train batch to the begin of the next,
the first batch from the epoch's begin): `fit_data_wait_seconds`, and
the epoch's `data_wait_share`, the share of the epoch's wall time spent
waiting for the loader.  `fit` leaves the loss on the device between log
boundaries, so a step's host time is what it took to queue the step,
and the card's pace shows over an epoch (`samples_per_s`) more than in
one step.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "MetricsLogger", "ResilienceCallback"]


class Callback:
    """No-op base; fit / evaluate / predict drive these hooks."""

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_train_error(self, logs=None): ...   # fit() raised mid-training
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks, model, params):
        self.callbacks = list(callbacks)
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def call(self, hook, *args):
        for c in self.callbacks:
            getattr(c, hook)(*args)

    def call_safe(self, hook, *args):
        """Best-effort dispatch on the error path: one callback's failure
        neither masks the training error nor starves later callbacks of
        their cleanup."""
        for c in self.callbacks:
            try:
                getattr(c, hook)(*args)
            except Exception:
                pass


def _items(logs):
    return " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                      else f"{k}: {v}" for k, v in (logs or {}).items())


class ProgBarLogger(Callback):
    """Line logs of each epoch (the reference prints a progress bar)."""

    def __init__(self, log_freq=10, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._t0 = time.time()
        if self.verbose >= 1:
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose >= 2 and (step + 1) % self.log_freq == 0:
            print(f"  step {step + 1}/{self.params.get('steps', '?')}"
                  f" - {_items(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose >= 1:
            print(f"  epoch {epoch + 1} done in "
                  f"{time.time() - self._t0:.1f}s - {_items(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose >= 1:
            print(f"  eval - {_items(logs)}")


class ModelCheckpoint(Callback):
    """Save `{save_dir}/{epoch}` every save_freq epochs and `final` at
    the end."""

    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """Stop fit() when a monitored metric stops improving."""

    def __init__(self, monitor="loss", mode="auto", patience=0,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.stopped_epoch = -1

    def _better(self, cur, ref):
        if self.mode == "min":
            return cur < ref - self.min_delta
        return cur > ref + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0]) \
            if not isinstance(cur, (int, float)) else float(cur)
        ref = self.best if self.best is not None else self.baseline
        if ref is None or self._better(cur, ref):
            self.best = cur
            self.wait = 0
            if self.save_best_model and getattr(self.model, "_save_dir",
                                                None):
                self.model.save(os.path.join(self.model._save_dir,
                                             "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class MetricsLogger(Callback):
    """The telemetry bridge of Model.fit: step-time histogram and spans,
    per-epoch step-time percentiles (p50 / p90 / p99), throughput (steps
    and, given `batch_size`, samples a second), the loader wait and the
    card's allocated memory in the epoch logs (so in fit()'s history);
    at the end of training the run's Chrome trace goes to `trace_path`.
    Telemetry is switched on for the fit unless it already is.  An
    optional `profiler` (a `torch.profiler.profile`) is started, stepped
    each batch and stopped with the run."""

    def __init__(self, registry=None, trace_path=None, batch_size=None,
                 profiler=None):
        self._registry = registry
        self.trace_path = trace_path
        self.batch_size = batch_size
        self.profiler = profiler
        self._owns_telemetry = False

    def on_train_begin(self, logs=None):
        from .. import observability as obs
        self._obs = obs
        if not obs.enabled():
            obs.enable(self._registry)
            self._owns_telemetry = True
        self._reg = self._registry or obs.metrics.registry()
        self._hist = self._reg.histogram("fit_step_seconds")
        self._wait_hist = self._reg.histogram("fit_data_wait_seconds")
        self._steps = self._reg.counter("fit_steps_total")
        self._mem = self._reg.gauge("live_array_bytes")
        self._t0 = None
        # this run's spans only: a second fit in the process must not
        # replay the first one's timeline
        self._trace_mark = obs.trace.mark()
        if self.profiler is not None:
            self.profiler.start()

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch_t0 = time.perf_counter()
        self._epoch_last_t = self._epoch_t0
        self._epoch_steps = 0
        self._epoch_wait = 0.0
        # fresh histograms an epoch: the logged percentiles describe THIS
        # epoch (the registry's stay cumulative)
        self._epoch_hist = self._obs.metrics.Histogram()
        self._epoch_wait_hist = self._obs.metrics.Histogram()

    def on_train_batch_begin(self, step, logs=None):
        self._t0 = time.perf_counter()
        wait = self._t0 - self._epoch_last_t
        self._wait_hist.observe(wait)
        self._epoch_wait_hist.observe(wait)
        self._epoch_wait += wait

    def on_train_batch_end(self, step, logs=None):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._hist.observe(dt)
        self._epoch_hist.observe(dt)
        self._steps.inc()
        self._epoch_steps += 1
        self._epoch_last_t = time.perf_counter()
        self._obs.trace.add_complete("train_step", "step", self._t0, dt,
                                     args={"step": step})
        if self.profiler is not None:
            self.profiler.step()

    def on_epoch_end(self, epoch, logs=None):
        if logs is None:
            return
        for name, h in (("step_time", self._epoch_hist),
                        ("data_wait", self._epoch_wait_hist)):
            for p in (50, 90, 99):
                v = h.percentile(p)
                if v is not None:
                    logs[f"{name}_p{p}"] = v
                    self._reg.gauge(f"fit_{name}_p{p}_seconds").set(v)
        # up to the LAST train batch: fit runs evaluate() and the epoch's
        # host sync before this hook, which must not deflate throughput
        dt_epoch = self._epoch_last_t - self._epoch_t0
        if self._epoch_steps and dt_epoch > 0:
            logs["steps_per_s"] = self._epoch_steps / dt_epoch
            logs["data_wait_share"] = self._epoch_wait / dt_epoch
            if self.batch_size:
                logs["samples_per_s"] = (self._epoch_steps *
                                         self.batch_size / dt_epoch)
        device = getattr(self.model, "_device", None)
        if device is not None and device.type == "cuda":
            mem = torch.cuda.memory_allocated(device)
            self._mem.set(mem)
            logs["live_array_bytes"] = mem

    def on_train_end(self, logs=None):
        if getattr(self, "_obs", None) is None:
            return   # on_train_begin never ran: nothing to release
        if self.profiler is not None:
            self.profiler.stop()
        if self.trace_path:
            self._obs.trace.export_chrome_trace(self.trace_path,
                                                since=self._trace_mark)
        if self._owns_telemetry:
            self._obs.disable()
            self._owns_telemetry = False

    # a crash mid-fit must not leave telemetry switched on or a profiler
    # open; the partial trace is what diagnoses the crash
    on_train_error = on_train_end


class ResilienceCallback(Callback):
    """The resilience layer in Model.fit:

    - step-numbered, retained checkpoints through a
      `resilience.CheckpointManager` (every `save_every_steps` train
      steps, else every `save_freq` epochs), asynchronous by default;
    - resume: on_train_begin restores the newest checkpoint that loads,
      when there is one (falling back past torn ones);
    - arms `guard` (a `resilience.NonfiniteGuard`) on the fit's train
      step, its rollbacks aimed at this callback's manager;
    - preemption: SIGTERM flushes the pending save, writes one final
      checkpoint and stops fit at the next batch boundary."""

    def __init__(self, manager=None, checkpoint_dir=None, max_to_keep=3,
                 save_every_steps=0, save_freq=1, guard=None,
                 restore_on_start=True, handle_sigterm=True,
                 async_save=True):
        from ..resilience.manager import CheckpointManager
        if manager is None:
            if checkpoint_dir is None:
                raise ValueError(
                    "ResilienceCallback needs manager= or checkpoint_dir=")
            manager = CheckpointManager(checkpoint_dir,
                                        max_to_keep=max_to_keep)
        self.manager = manager
        self.save_every_steps = int(save_every_steps)
        self.save_freq = int(save_freq)
        self.guard = guard
        self.restore_on_start = restore_on_start
        self.handle_sigterm = handle_sigterm
        self.async_save = async_save

    def _train_step_obj(self):
        return getattr(self.model, "_train_step", None)

    def on_train_begin(self, logs=None):
        from ..framework.checkpoint import CheckpointError
        ts = self._train_step_obj()
        if self.guard is not None and ts is not None:
            if self.guard.manager is None:
                self.guard.manager = self.manager
            ts._guard = self.guard
        if self.handle_sigterm:
            self.manager.install_preemption_handler()
        if self.restore_on_start and ts is not None and \
                self.manager.latest() is not None:
            try:
                meta = self.manager.restore(train_step=ts)
                print(f"[resilience] resumed from "
                      f"{meta.get('__path__')} at step "
                      f"{meta.get('step')}")
            except CheckpointError as e:
                import warnings
                warnings.warn(f"auto-resume skipped: {e}", RuntimeWarning)

    def _maybe_stop_preempted(self):
        if self.manager.preempted and not self.model.stop_training:
            self._drain_guard()
            ts = self._train_step_obj()
            if self.manager.final_save() is None and ts is not None:
                # preempted before the first periodic save
                self.manager.save(ts.step_count, train_step=ts)
            self.model.stop_training = True

    def _drain_guard(self):
        # deferred verdicts settle before a save: a pending rollback would
        # otherwise checkpoint a step it is about to rewind
        if self.guard is not None:
            self.guard.drain()

    def on_train_batch_end(self, step, logs=None):
        ts = self._train_step_obj()
        if ts is None:
            return
        if self.save_every_steps and \
                ts.step_count % self.save_every_steps == 0:
            self._drain_guard()
            self.manager.save(ts.step_count, train_step=ts,
                              async_save=self.async_save)
        self._maybe_stop_preempted()

    def on_epoch_end(self, epoch, logs=None):
        ts = self._train_step_obj()
        if ts is None:
            return
        self._drain_guard()
        if not self.save_every_steps and \
                (epoch + 1) % self.save_freq == 0:
            self.manager.save(ts.step_count, train_step=ts,
                              async_save=self.async_save)
        self._maybe_stop_preempted()

    def on_train_end(self, logs=None):
        self._drain_guard()
        self.manager.flush()

    # a crash must not leave a half-published async save behind
    on_train_error = on_train_end


class LRScheduler(Callback):
    """Step the optimizer's LR scheduler each epoch (or each batch)."""

    def __init__(self, by_step=False, by_epoch=True):
        self.by_step = by_step
        self.by_epoch = by_epoch and not by_step

    def _sched(self):
        opt = self.model._optimizer
        lr = getattr(opt, "_lr", None) or getattr(opt, "_learning_rate",
                                                  None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()
