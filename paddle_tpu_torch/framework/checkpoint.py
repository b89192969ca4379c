"""Checkpoint and resume: the whole training state in one directory.

Counterpart: `paddle_tpu/framework/checkpoint.py:31-295`.  A checkpoint
holds what a deterministic resume needs: the model's state dict, the
optimizer's (slots, step, the LR scheduler's state), the `GradScaler`'s
state, the random state (`framework.random`) and the step, plus the
caller's `extra`; given the model beside the optimizer, the slots are
keyed by the model's parameter names on both sides
(`Optimizer._name_after`), however the optimizer was built.  Tensors go
to `<path>/arrays.pt` (`torch.save`; the
JAX package writes them with orbax, which is JAX-only), scalars to the
JSON sidecar `<path>/meta.json` with the reference's keys: "step",
"model" / "optimizer" (the scalars of those state dicts, "LR_Scheduler"
among the optimizer's), "scaler", "rng_seed", "extra" and
"commit_token".

The protocol, as in the reference (`:105-171`):
1. every tensor is copied to the host, so that the caller may go on
   updating its parameters and slots in place (`Optimizer.state_dict`
   hands out the slot tensors themselves);
2. meta.json.tmp is staged;
3. the tensors are written to arrays.pt.tmp, flushed to disk and moved
   over arrays.pt (`os.replace`);
4. meta.json.tmp is moved over meta.json: the commit.
A fresh commit token goes into both halves, so that a crash while a
checkpoint is overwritten leaves a mismatch `load_state` detects.  With
`async_save=True` only step 3 runs in a background thread, and the
returned handle's `wait_until_finished()` runs step 4.

`load_state` validates both halves (meta published and parseable, the
arrays readable, the token equal in both, every model key present with
its shape, the optimizer's slots and the scaler's fields present) before
it changes anything, and raises `CheckpointError` naming the path and
the failing half.  Then it copies into the existing parameters, buffers
and slots in place, on their devices, so every `Parameter` keeps its
identity and an optimizer's references stay valid.  The reference's
`layouts` and resharder (a restore onto another mesh) belong to the
distributed slice of the port and are left out.
"""
from __future__ import annotations

import json
import os
import threading
import uuid

import numpy as np
import torch

from ..resilience import chaos as _chaos
from . import random as _random

_ARRAYS = "arrays.pt"
_META = "meta.json"


class CheckpointError(RuntimeError):
    """A checkpoint directory is missing, partial, torn or does not fit.

    `path` names the checkpoint; `missing` says which half failed
    ("arrays" | "meta" | None for a mismatch between the halves), so that
    `resilience.CheckpointManager` can fall back to the previous
    checkpoint."""

    def __init__(self, msg, path=None, missing=None):
        super().__init__(msg)
        self.path = path
        self.missing = missing


def _host(v):
    """A host copy of a tensor or array that later in-place updates of the
    original leave alone."""
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.copy())
    return v.detach().to("cpu", copy=True)


def _split_state_dict(sd):
    """(tensors, scalars) of a possibly nested state dict: tensors copied
    to the host, everything else for the JSON sidecar."""
    arrays, meta = {}, {}
    for k, v in sd.items():
        name = str(k)
        if isinstance(v, (torch.Tensor, np.ndarray)):
            arrays[name] = _host(v)
        elif isinstance(v, dict):
            a, m = _split_state_dict(v)
            if a:
                arrays[name] = a
            if m:
                meta[name] = m
        else:
            meta[name] = v
    return arrays, meta


def _merge_state_dict(arrays, meta):
    out = {}
    for k, v in (arrays or {}).items():
        out[k] = _merge_state_dict(v, (meta or {}).get(k)) \
            if isinstance(v, dict) else v
    for k, v in (meta or {}).items():
        if k not in out:
            out[k] = v
    return out


def _write_arrays(arrays, path):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(arrays, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_state(path, model=None, optimizer=None, scaler=None, step=0,
               extra=None, async_save=False):
    """Save a training state that resumes deterministically into the
    directory `path`.  With `async_save=True` the file write runs in the
    background and the returned handle's `wait_until_finished()` must be
    called to publish the checkpoint; the host copies are made before
    this returns either way.  Returns the handle, or None."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    if model is not None and optimizer is not None:
        optimizer._name_after(model)
    arrays, meta = {}, {"step": int(step)}
    if model is not None:
        a, m = _split_state_dict(model.state_dict())
        arrays["model"] = a
        if m:
            meta["model"] = m
    if optimizer is not None:
        a, m = _split_state_dict(optimizer.state_dict())
        if a:
            arrays["optimizer"] = a
        if m:
            meta["optimizer"] = m
    if scaler is not None:
        meta["scaler"] = scaler.state_dict()
    rng = _random.get_rng_state()
    arrays["rng"] = {"cpu": rng["cpu"], "cuda": rng["cuda"]}
    meta["rng_seed"] = rng["seed"]
    if extra is not None:
        meta["extra"] = extra
    # pairs this meta with exactly these arrays: a crash while a
    # checkpoint is overwritten leaves a mismatch load_state detects
    token = uuid.uuid4().hex
    arrays["commit_token"] = torch.tensor(list(bytes.fromhex(token)),
                                          dtype=torch.uint8)
    meta["commit_token"] = token

    # meta.json is the commit marker: staged now, published only after
    # the arrays are on disk
    tmp = os.path.join(path, _META + ".tmp")
    if os.path.exists(tmp):
        # a stage left by an earlier crashed save pairs with no arrays
        # of this save
        os.unlink(tmp)
    with open(tmp, "w") as f:
        json.dump(meta, f)
    if _chaos.active() is not None:
        _chaos.crash("ckpt.crash_after_meta_stage")
        if _chaos.fire("save.sigterm"):
            import signal
            os.kill(os.getpid(), signal.SIGTERM)
    handle = _SaveHandle(arrays, os.path.join(path, _ARRAYS), tmp,
                         os.path.join(path, _META), background=async_save)
    if async_save:
        return handle
    handle.wait_until_finished()
    return None


class _SaveHandle:
    """The arrays write of one save (in a background thread when
    `background`) and its commit."""

    def __init__(self, arrays, arrays_path, tmp_meta, meta, background):
        self._tmp_meta = tmp_meta
        self._meta = meta
        self._error = None
        self._thread = None
        if background:
            self._thread = threading.Thread(
                target=self._run, args=(arrays, arrays_path),
                name="paddle_tpu_torch-save")
            self._thread.start()
        else:
            _write_arrays(arrays, arrays_path)

    def _run(self, arrays, arrays_path):
        try:
            _write_arrays(arrays, arrays_path)
        except BaseException as e:  # re-raised in wait_until_finished
            self._error = e

    def wait_until_finished(self):
        """Wait for the arrays write, then publish meta.json.  A failed
        write raises here and publishes nothing."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        # fault site: arrays committed, meta not yet published
        _chaos.crash("ckpt.crash_after_arrays")
        if os.path.exists(self._tmp_meta):
            os.replace(self._tmp_meta, self._meta)


def probe(path):
    """The light consistency check, no tensor read: meta.json published
    and parseable, arrays.pt present.  Returns the parsed meta; raises
    CheckpointError naming the path and the failing half.  `load_state`
    and the CheckpointManager share it."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, _META)
    if not os.path.exists(meta_path):
        orphan = os.path.exists(meta_path + ".tmp")
        raise CheckpointError(
            f"checkpoint {path}: meta.json is missing" + (
                " (an orphaned meta.json.tmp is present: the save "
                "crashed between the array commit and the meta publish)"
                if orphan else " (empty or partial checkpoint)"),
            path=path, missing="meta")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (ValueError, OSError) as e:
        raise CheckpointError(
            f"checkpoint {path}: meta.json is unreadable ({e})",
            path=path, missing="meta") from e
    if not isinstance(meta, dict):
        raise CheckpointError(
            f"checkpoint {path}: meta.json holds no mapping", path=path,
            missing="meta")
    if not os.path.isfile(os.path.join(path, _ARRAYS)):
        raise CheckpointError(
            f"checkpoint {path}: {_ARRAYS} is missing (empty or partial "
            f"checkpoint)", path=path, missing="arrays")
    return meta


def _fit_errors(want, got):
    """What keeps the tensors `got` ({key: tensor}) from loading into
    `want` ({key: tensor}): missing and unexpected keys, other shapes."""
    errs = []
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing:
        errs.append(f"missing {missing[:5]}"
                    + (f" and {len(missing) - 5} more" if len(missing) > 5
                       else ""))
    if extra:
        errs.append(f"unexpected {extra[:5]}"
                    + (f" and {len(extra) - 5} more" if len(extra) > 5
                       else ""))
    errs += [f"{k}: shape {tuple(got[k].shape)} where the target has "
             f"{tuple(want[k].shape)}" for k in sorted(set(want) & set(got))
             if tuple(got[k].shape) != tuple(want[k].shape)]
    return errs


def _slots(optimizer):
    """{"{param name}/{slot}": tensor} of an optimizer's slots, made
    first (zeros, as a fresh optimizer has them) when it has none."""
    if optimizer._state is None:
        optimizer.init_state()
    return {f"{n}/{s}": t for n, slots in zip(optimizer._param_names,
                                              optimizer._state)
            for s, t in slots.items()}


def load_state(path, model=None, optimizer=None, scaler=None, meta=None):
    """Restore a `save_state` checkpoint in place; returns its meta dict
    (step, extra, ...).  Raises CheckpointError before it changes
    anything when the checkpoint is partial, torn, or does not fit the
    model, optimizer or scaler given.  `meta` skips the probe when the
    caller has just parsed this path's meta (the manager does)."""
    path = os.path.abspath(path)
    if meta is None:
        meta = probe(path)
    orphan = os.path.exists(os.path.join(path, _META) + ".tmp")
    try:
        arrays = torch.load(os.path.join(path, _ARRAYS), map_location="cpu",
                            weights_only=True)
    except Exception as e:  # a torn file raises from several layers
        raise CheckpointError(
            f"checkpoint {path}: {_ARRAYS} failed to load "
            f"({type(e).__name__}: {e})", path=path, missing="arrays") \
            from e
    want = meta.get("commit_token")
    got = arrays.get("commit_token") if isinstance(arrays, dict) else None
    if want is not None and (
            got is None or bytes(got.tolist()).hex() != want):
        raise CheckpointError(
            f"checkpoint {path} is inconsistent (meta and arrays from "
            f"different saves: an interrupted overwrite?)" + (
                "; an orphaned meta.json.tmp is present from the "
                "interrupted save" if orphan else ""), path=path)

    def refuse(what, errs):
        raise CheckpointError(
            f"checkpoint {path} does not fit the {what}: "
            + "; ".join(errs), path=path, missing="arrays")

    model_sd = opt_sd = None
    if model is not None:
        if "model" not in arrays:
            refuse("model", ["it holds no model state"])
        model_sd = _merge_state_dict(arrays["model"], meta.get("model"))
        errs = _fit_errors(model.state_dict(), model_sd)
        if errs:
            refuse("model", errs)
    if optimizer is not None:
        if model is not None:
            optimizer._name_after(model)
        opt_sd = _merge_state_dict(arrays.get("optimizer", {}),
                                   meta.get("optimizer"))
        opt_sd.setdefault("step", meta.get("step", 0))
        saved = {k: v for k, v in opt_sd.items()
                 if isinstance(v, torch.Tensor)
                 and not k.startswith("__lbfgs__/")}
        if saved:
            errs = _fit_errors(_slots(optimizer), saved)
            if errs:
                refuse("optimizer", errs)
    if scaler is not None:
        st = meta.get("scaler")
        if not isinstance(st, dict) or not {
                "scale", "good_steps", "bad_steps"} <= set(st):
            refuse("scaler", ["it holds no GradScaler state"])

    with torch.no_grad():
        if model_sd is not None:
            model.load_state_dict(model_sd)
    if opt_sd is not None:
        optimizer.set_state_dict(opt_sd)
    if scaler is not None:
        scaler.load_state_dict(meta["scaler"])
    rng = arrays.get("rng")
    if rng is not None:
        _random.set_rng_state({"cpu": rng["cpu"], "cuda": rng["cuda"],
                               "seed": meta.get("rng_seed", 0)})
    return meta


def async_save(path, model=None, optimizer=None, scaler=None, step=0,
               extra=None):
    """`save_state(..., async_save=True)`: returns the handle whose
    `wait_until_finished()` publishes the checkpoint."""
    return save_state(path, model=model, optimizer=optimizer, scaler=scaler,
                      step=step, extra=extra, async_save=True)
