"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), under
`build/kernels/` at the root of the checkout.  The file name carries a
hash of the sources and flags, so an edited kernel rebuilds and a built
one is reused.  Callers pass every pointer and the CUDA stream as
`ctypes.c_void_p`; each C entry point returns a `cudaError_t` code that
its wrapper turns into an exception.

Nothing is built at import: the CPU tests import every module of the
package on a machine without nvcc.  (No JAX counterpart: there, XLA and
Mosaic compile the Pallas kernels.)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def sources():
    """Names of the kernel sources (`csrc/<name>.cu`)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source on the machine with the card")
    return path


def _target(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None):
    """Compile every named source not yet built: one nvcc per source, all
    started together.  Returns {name: compiler output} for the sources it
    compiled (ptxas prints registers, shared memory and spills per
    kernel).  Raises RuntimeError with the compiler's output if any nvcc
    fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, out)
    logs, errors = {}, []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode:
            errors.append(f"nvcc failed on {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)    # atomic: a reader never sees half a .so
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name):
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _, out = _target(name)
            if not out.exists():
                build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(out))
        return lib
