"""Build and bind the native shared-memory ring (`ring.cc`) with ctypes.

Counterpart: `paddle_tpu/io/native/__init__.py`.  The port keeps its own
copies of `ring.cc` and `imgproc.cc` beside this file and builds each at
first use with `g++ -O2 -shared -fPIC` into `build/native/` at the root
of the checkout (ignored by git), the file name carrying a hash of the
source, so an edited source rebuilds; the reference builds next to its
source at import.  Nothing is built at import.  No compiler means
`available()` is False and the DataLoader runs its workers as threads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"

LIB = None           # the ring library once `load()` has bound it
_LOCK = threading.Lock()
_FAILED = {}


def build_so(src, so=None, force=False):
    """Compile `src` into `so` with g++ unless it is there (default: a
    hash-named file under `build/native/`); the publish is atomic, so
    concurrent builders are safe.  Returns the path."""
    src = Path(src)
    if so is None:
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"{src.stem}-{digest}.so"
    so = Path(so)
    if so.exists() and not force:
        return str(so)
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp,
                        str(src)], check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(so)


def _bind(path):
    lib = ctypes.CDLL(path)
    lib.ring_hdr_size.restype = ctypes.c_uint64
    lib.ring_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ring_init.restype = ctypes.c_int
    lib.ring_close.argtypes = [ctypes.c_void_p]
    lib.ring_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint64, ctypes.c_long]
    lib.ring_write.restype = ctypes.c_long
    lib.ring_next_len.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.ring_next_len.restype = ctypes.c_long
    lib.ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_uint64]
    lib.ring_read.restype = ctypes.c_long
    return lib


def load_native(name, bind):
    """bind(CDLL) of `<name>.cc` beside this file, built first if needed;
    None when it cannot be built (no compiler), remembered."""
    if name in _FAILED:
        return None
    try:
        return bind(build_so(_DIR / f"{name}.cc"))
    except (OSError, subprocess.CalledProcessError) as e:
        _FAILED[name] = e
        return None


def load():
    """The ring library, built and bound on the first call."""
    global LIB
    with _LOCK:
        if LIB is None:
            LIB = load_native("ring", _bind)
        return LIB


def available():
    return load() is not None
