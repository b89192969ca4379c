"""ctypes binding of the native image pass (`imgproc.cc`; counterpart:
`paddle_tpu/io/native/imgproc.py`).

`to_chw_f32(img_u8_hwc, mean, std, unit_scale)` does uint8 -> float32,
/255 and normalisation, and HWC -> CHW in ONE C pass, where the plain
pipeline takes three numpy passes.  Built at first use like the ring;
without a compiler `available()` is False and callers use numpy.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import load_native

LIB = None
_LOCK = threading.Lock()


def _bind(path):
    lib = ctypes.CDLL(path)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.hwc_u8_to_chw_f32.argtypes = [
        ctypes.c_char_p, fp, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        fp, fp, ctypes.c_int]
    lib.batch_hwc_u8_to_chw_f32.argtypes = [
        ctypes.c_char_p, fp, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, fp, fp, ctypes.c_int]
    return lib


def load():
    global LIB
    with _LOCK:
        if LIB is None:
            LIB = load_native("imgproc", _bind)
        return LIB


def available():
    return load() is not None


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def to_chw_f32(img, mean=None, std=None, unit_scale=True):
    """img: uint8 HWC (or batched NHWC) -> float32 CHW / NCHW, normalised
    when mean and std are given.  The caller checks `available()`."""
    img = np.ascontiguousarray(img)
    assert img.dtype == np.uint8 and img.ndim in (3, 4)
    if (mean is None) != (std is None):
        raise ValueError("pass both mean and std, or neither")
    lib = load()
    m = iv = None
    c = img.shape[-1]
    if mean is not None:
        # scalars, (c,), or (c, 1, 1) as Normalize keeps them
        m = np.ascontiguousarray(np.broadcast_to(
            np.asarray(mean, np.float32).reshape(-1), (c,)))
        iv = np.ascontiguousarray(
            1.0 / np.broadcast_to(
                np.asarray(std, np.float32).reshape(-1), (c,)))
    mp = None if m is None else _fptr(m)
    ivp = None if iv is None else _fptr(iv)
    src = img.ctypes.data_as(ctypes.c_char_p)
    if img.ndim == 3:
        h, w, _ = img.shape
        out = np.empty((c, h, w), np.float32)
        lib.hwc_u8_to_chw_f32(src, _fptr(out), h, w, c, mp, ivp,
                              int(unit_scale))
    else:
        n, h, w, _ = img.shape
        out = np.empty((n, c, h, w), np.float32)
        lib.batch_hwc_u8_to_chw_f32(src, _fptr(out), n, h, w, c, mp, ivp,
                                    int(unit_scale))
    return out
