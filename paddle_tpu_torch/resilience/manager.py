"""Checkpoint manager: retention and GC, torn-checkpoint fall-back,
preemption flush.

Counterpart: `paddle_tpu/resilience/manager.py:87-375`, on the port's
`framework/checkpoint.py`, which owns the single-directory save and load
protocol.  The manager owns a root of step-numbered checkpoints
``<root>/ckpt-<step>``, keeps the newest `max_to_keep`, resolves
`latest()` to the newest one that passes the light probe, and, since the
probe is weaker than a full load, `restore()` walks back past every
checkpoint whose load raises `CheckpointError` until one loads.

Preemption: `install_preemption_handler()` turns SIGTERM into the
`preempted` flag and a flush of the pending async save; the training
loop sees the flag, calls `final_save()` and stops.

Left out until the distributed slice of the port: the reference records
the mesh with every save and, on a restart under another world size,
reshards the arrays as it restores (`_plan_restore`, the mesh half of
`_after_restore`).  A port process drives one device, so there is no
mesh to record or compare.
"""
from __future__ import annotations

import os
import re
import shutil
import signal as _signal
import sys
import warnings

from ..framework import checkpoint as _ckpt
from ..framework.checkpoint import CheckpointError  # noqa: F401
from ..observability import metrics as _metrics


def restart_count():
    """This process's restart ordinal, as a launcher exports it in
    PT_RESTART_COUNT (0 on the first attempt)."""
    try:
        return int(os.environ.get("PT_RESTART_COUNT", "0"))
    except ValueError:
        return 0


def _optimizer_of(train_step, optimizer):
    return optimizer if optimizer is not None or train_step is None \
        else train_step.optimizer


class CheckpointManager:
    """mgr = CheckpointManager(root, max_to_keep=3)

    ``mgr.save(step, model=..., optimizer=...)`` writes
    ``<root>/ckpt-<step>`` and drops checkpoints beyond the newest
    `max_to_keep`; ``mgr.restore(model=..., optimizer=...)`` loads the
    newest checkpoint that loads, falling back past torn ones."""

    _DIR_RE = re.compile(r"^(?P<prefix>.+)-(?P<step>\d{8})$")

    def __init__(self, root, max_to_keep=3, prefix="ckpt"):
        self.root = os.path.abspath(root)
        self.max_to_keep = int(max_to_keep)
        self.prefix = prefix
        os.makedirs(self.root, exist_ok=True)
        self._pending = None        # outstanding async save handle
        self._pending_path = None
        self._last_save_args = None  # the last save's arguments (flush)
        self.preempted = False
        self._prev_handlers = {}

    # ----------------------------------------------------------- directory
    def path_for(self, step):
        return os.path.join(self.root, f"{self.prefix}-{int(step):08d}")

    def all_steps(self):
        """Step numbers present under root, ascending."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        steps = []
        for n in names:
            m = self._DIR_RE.match(n)
            if m and m.group("prefix") == self.prefix:
                steps.append(int(m.group("step")))
        return sorted(steps)

    # -------------------------------------------------------- verification
    def verify(self, path):
        """The light probe of `framework.checkpoint.probe`; raises
        CheckpointError.  Deep damage (a truncated arrays file, a token
        mismatch) shows when `restore()` loads."""
        _ckpt.probe(path)

    def latest(self):
        """Path of the newest checkpoint that passes the probe, or None.
        A torn one is skipped, counted and warned about."""
        for step in reversed(self.all_steps()):
            path = self.path_for(step)
            try:
                self.verify(path)
                return path
            except _ckpt.CheckpointError as e:
                _metrics.registry().counter(
                    "resilience_ckpt_torn_total").inc()
                warnings.warn(f"skipping torn checkpoint: {e}",
                              RuntimeWarning)
        return None

    # ---------------------------------------------------------------- save
    def save(self, step, model=None, optimizer=None, scaler=None,
             extra=None, async_save=False, train_step=None):
        """Write ``<root>/ckpt-<step>``, then drop old checkpoints.  With
        `train_step=` (a `jit.TrainStep`) its model and optimizer are
        saved unless given.  With `async_save` the write runs in the
        background until `flush()` (or the next save) publishes it."""
        if train_step is not None:
            train_step.sync_optimizer_state()
            model = model if model is not None else train_step.model
        optimizer = _optimizer_of(train_step, optimizer)
        self.flush()  # a pending save publishes before the next starts
        extra = dict(extra or {})
        extra.setdefault("restart_count", restart_count())
        path = self.path_for(step)
        self._last_save_args = dict(step=step, model=model,
                                    optimizer=optimizer, scaler=scaler,
                                    train_step=train_step)
        handle = _ckpt.save_state(path, model=model, optimizer=optimizer,
                                  scaler=scaler, step=step, extra=extra,
                                  async_save=True)
        _metrics.registry().counter("resilience_ckpt_saves_total").inc()
        if async_save:
            self._pending, self._pending_path = handle, path
            return handle
        handle.wait_until_finished()
        self._gc()
        return None

    def flush(self):
        """Wait until a pending async save has published."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            try:
                pending.wait_until_finished()
            finally:
                self._pending_path = None
            self._gc()

    def _gc(self):
        steps = self.all_steps()
        if self.max_to_keep <= 0 or len(steps) <= self.max_to_keep:
            return
        for step in steps[:-self.max_to_keep]:
            path = self.path_for(step)
            if path == self._pending_path:
                continue  # never drop a checkpoint still being written
            shutil.rmtree(path, ignore_errors=True)
            _metrics.registry().counter("resilience_ckpt_gc_total").inc()

    # ------------------------------------------------------------- restore
    def restore(self, model=None, optimizer=None, scaler=None,
                train_step=None):
        """Load the newest checkpoint that loads, walking back past torn
        or damaged ones (each fall-back counted and warned).  Returns its
        meta dict with ``__path__`` added; raises CheckpointError when no
        checkpoint under root loads.  A `train_step` given has its step
        counter set to the checkpoint's (`reload_from`)."""
        if train_step is not None and model is None:
            model = train_step.model
        optimizer = _optimizer_of(train_step, optimizer)
        steps = self.all_steps()
        last_exc = None
        for step in reversed(steps):
            path = self.path_for(step)
            try:
                meta = _ckpt.load_state(path, model=model,
                                        optimizer=optimizer, scaler=scaler)
            except _ckpt.CheckpointError as e:
                last_exc = e
                _metrics.registry().counter(
                    "resilience_ckpt_fallback_total").inc()
                warnings.warn(
                    f"checkpoint fallback: {e}; trying the previous "
                    f"checkpoint", RuntimeWarning)
                continue
            if train_step is not None:
                train_step.reload_from(step=meta.get("step"))
            meta["__path__"] = path
            _metrics.registry().counter(
                "resilience_ckpt_restores_total").inc()
            return meta
        raise _ckpt.CheckpointError(
            f"no loadable checkpoint under {self.root} "
            f"({len(steps)} candidates)" +
            (f"; last error: {last_exc}" if last_exc else ""),
            path=self.root)

    # ------------------------------------------------------- preemption
    def install_preemption_handler(self, signals=(_signal.SIGTERM,),
                                   exit_process=False, exit_code=143):
        """Route SIGTERM (a preemption notice) into a drain: flush the
        pending async save, set `preempted` (the loop then calls
        `final_save()` and stops), and exit when `exit_process`."""
        def _handler(signum, frame):
            self.preempted = True
            _metrics.registry().counter(
                "resilience_preemptions_total").inc()
            try:
                self.flush()
            except Exception as e:  # the final save still runs
                warnings.warn(f"preemption flush failed: {e}",
                              RuntimeWarning)
            if exit_process:
                sys.exit(exit_code)

        for sig in signals:
            if sig in self._prev_handlers:
                continue   # installed already: keep the ORIGINAL handler
            try:
                self._prev_handlers[sig] = _signal.signal(sig, _handler)
            except ValueError:
                warnings.warn(
                    "install_preemption_handler: not in the main thread; "
                    "SIGTERM handler not installed", RuntimeWarning)
        return self

    def uninstall_preemption_handler(self):
        for sig, prev in self._prev_handlers.items():
            try:
                _signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev_handlers.clear()

    def final_save(self):
        """The preemption save: one synchronous save with the last
        save()'s arguments, at the train step's current step when one was
        given (an existing directory of that step is overwritten, which
        the commit token keeps safe).  Returns its path, or None when
        nothing was saved before."""
        args = self._last_save_args
        if not args:
            return None
        ts = args.get("train_step")
        step = int(ts.step_count if ts is not None else args["step"])
        self.save(step, model=args["model"], optimizer=args["optimizer"],
                  scaler=args["scaler"], train_step=ts)
        return self.path_for(step)
