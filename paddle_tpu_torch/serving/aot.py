"""Per-bucket AOT serving artifacts: a replica that starts from files.

Counterpart: `paddle_tpu/serving/aot.py`.  A serving replica's program
inventory (`LLMEngine.program_keys`: the decode program and one prefill
program per bucket of the ladder) is exported and compiled ahead of time
into AOTInductor packages (`jit.aoti`), stamped like
`jit.save_inference(aot=True)` artifacts, so that a fresh engine, a
respawned router replica or a worker process serves from them.

Layout under `path/`:

    serving_manifest.json   program inventory + env stamp + sha256s
    programs/<name>.pt2     one AOTInductor package a program

The JAX package writes pickled XLA executables (`.aotexec`); a package
here is a `.pt2` archive of a compiled shared library.  Each program
takes the model's weights and the pool as inputs and holds neither, so a
package is small beside the weights, and the pool is written in place:
there is no alias-free copy of the pool to retire (the JAX artifacts'
trade-off).  The manifest also records each program's input signature
(`jit.aoti.compile_packages`) and its export and compile seconds.

Compatibility is checked at load time with `jit.save_load`'s stamp
(platform, device name and count, compute capability, torch and CUDA
versions), then each package's checksum, then its signature against the
engine's own inputs (another model or pool geometry, or fewer rows or
table columns than the engine may run).  A refused program
warns, counts `serving_aot_refused_total` and is served eagerly;
`strict=True` raises `AOTIncompatible` instead.
"""
from __future__ import annotations

import hashlib
import json
import os
import warnings

from ..jit.aoti import AOTProgram, compile_packages
from ..jit.save_load import AOTIncompatible, _aot_compatible, _env_stamp
from ..observability import metrics as _metrics

_MANIFEST = "serving_manifest.json"
_PROGRAMS = "programs"


def _key_name(key):
    return "_".join(str(p) for p in key)


def _name_key(name):
    parts = name.split("_")
    return tuple(int(p) if p.isdigit() else p for p in parts)


def export_serving_artifacts(engine, path, prompt_lens=()):
    """Compile the engine's program inventory into packages under `path`
    and write the manifest.  `prompt_lens` adds the buckets of those
    prompts' first chunks (see `LLMEngine.program_keys`); the programs
    compile side by side in child processes
    (`jit.aoti.compile_packages`).  Returns the manifest dict."""
    path = os.path.abspath(path)
    os.makedirs(os.path.join(path, _PROGRAMS), exist_ok=True)
    stamp = _env_stamp(engine.device)
    keys = engine.program_keys(prompt_lens=prompt_lens)
    jobs = []
    for key in keys:
        builder, args, dynamic = engine.program_structs(key)
        jobs.append((builder(), args, os.path.join(
            path, _PROGRAMS, f"{_key_name(key)}.pt2"), dynamic))
    results = compile_packages(jobs)
    manifest = {"stamp": stamp, "programs": {}}
    for key, (signature, export_s, compile_s) in zip(keys, results):
        name = _key_name(key)
        fn = os.path.join(_PROGRAMS, f"{name}.pt2")
        with open(os.path.join(path, fn), "rb") as f:
            payload = f.read()
        manifest["programs"][name] = {
            "file": fn, "sha256": hashlib.sha256(payload).hexdigest(),
            "bytes": len(payload), "signature": signature,
            "export_s": export_s, "compile_s": compile_s}
        _metrics.registry().counter("serving_aot_exported_total").inc()
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _refuse(strict, reason, warning):
    if strict:
        raise AOTIncompatible(reason)
    warnings.warn(warning, UserWarning, stacklevel=3)
    _metrics.registry().counter("serving_aot_refused_total").inc()


def load_serving_artifacts(engine, path, strict=False):
    """Install the packages under `path` into the engine.  Returns the
    list of loaded program keys.  Incompatible or damaged artifacts are
    refused with the reason (a warning and `serving_aot_refused_total`;
    the engine serves those programs eagerly); `strict=True` raises
    AOTIncompatible instead, for replicas where an eager start is worse
    than a failed deploy."""
    path = os.path.abspath(path)
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        if strict:
            raise AOTIncompatible(f"unreadable serving manifest: {e}")
        warnings.warn(f"no serving AOT manifest at {path} ({e}); the "
                      f"engine serves eagerly", UserWarning, stacklevel=2)
        return []
    ok, reason = _aot_compatible(manifest.get("stamp", {}))
    if not ok:
        _refuse(strict, reason, f"serving AOT artifacts refused: {reason}; "
                f"the engine serves eagerly")
        return []
    loaded = []
    for name, entry in manifest.get("programs", {}).items():
        key = _name_key(name)
        try:
            with open(os.path.join(path, entry["file"]), "rb") as f:
                payload = f.read()
            if hashlib.sha256(payload).hexdigest() != entry.get("sha256"):
                raise ValueError("artifact checksum mismatch")
            _, args, dynamic = engine.program_structs(key)
            prog = AOTProgram(os.path.join(path, entry["file"]),
                              entry["signature"])
            prog.check_bounds(args, dynamic)
        except Exception as e:
            _refuse(strict, f"program {name}: {e}",
                    f"serving AOT program {name} refused ({e}); it is "
                    f"served eagerly")
            continue
        engine._aot_execs[key] = prog
        loaded.append(key)
        _metrics.registry().counter("serving_aot_loaded_total").inc()
    return loaded
