"""Signal processing: frames, overlap-add, STFT and ISTFT (counterpart:
`paddle_tpu/signal.py`; reference: python/paddle/signal.py).

The reference's formulation, in torch: framing is a gather by an index
matrix, overlap-add an `index_add`, the spectrum a batched real (or
complex) FFT of the windowed frames, laid out [batch, n_fft // 2 + 1
(or n_fft), frames].  `stft` is differentiable with respect to both the
signal and the window (autograd through the gather and the FFT);
`istft` divides by the overlap-added squared window (the COLA envelope,
floored at 1e-11).  `center` pads n_fft // 2 on each side with
`pad_mode` ("reflect", "constant", "edge" or "wrap", as `jnp.pad`).
A signal shorter than a frame raises ValueError, and so does `istft`
asked for a complex result of a one-sided spectrum.
"""
from __future__ import annotations

import torch

from .tensor_api import _pad_index, _t

__all__ = ["stft", "istft", "frame", "overlap_add"]


def _frame_counts(n, frame_length, hop_length):
    if n < frame_length:
        raise ValueError(
            f"input length {n} is shorter than frame_length {frame_length}")
    return 1 + (n - frame_length) // hop_length


def _frame_index(n_frames, frame_length, hop_length, device):
    return (torch.arange(n_frames, device=device)[:, None] * hop_length
            + torch.arange(frame_length, device=device)[None, :])


def _frame(arr, frame_length, hop_length):
    n_frames = _frame_counts(arr.shape[-1], frame_length, hop_length)
    return arr[..., _frame_index(n_frames, frame_length, hop_length,
                                 arr.device)]


def _overlap_add(arr, hop_length):
    *batch, n_frames, frame_length = arr.shape
    n = (n_frames - 1) * hop_length + frame_length
    idx = _frame_index(n_frames, frame_length, hop_length,
                       arr.device).reshape(-1)
    flat = arr.reshape(tuple(batch) + (n_frames * frame_length,))
    out = torch.zeros(tuple(batch) + (n,), dtype=arr.dtype,
                      device=arr.device)
    return out.index_add(out.dim() - 1, idx, flat)


def _pad_window(win, win_length, n_fft):
    if win_length < n_fft:  # center the window in n_fft
        pad = (n_fft - win_length) // 2
        win = torch.nn.functional.pad(win, (pad, n_fft - win_length - pad))
    return win


def _center(arr, n_fft, pad_mode):
    p = n_fft // 2
    if pad_mode == "constant":
        return torch.nn.functional.pad(arr, (p, p))
    mode = {"reflect": "reflect", "edge": "edge", "replicate": "edge",
            "wrap": "wrap", "circular": "wrap"}[pad_mode]
    return arr.index_select(-1, _pad_index(arr.shape[-1], p, p, mode,
                                           arr.device))


def frame(x, frame_length, hop_length, axis=-1):
    """Overlapping frames along the last axis: [..., n_frames,
    frame_length].  Differentiable."""
    t = _t(x)
    if axis not in (-1, t.dim() - 1):
        raise ValueError("frame: only axis=-1 is supported")
    return _frame(t, frame_length, hop_length)


def overlap_add(x, hop_length, axis=-1):
    """The inverse of frame(): [..., n_frames, frame_length] -> [..., n]."""
    t = _t(x)
    if axis not in (-1, t.dim() - 1):
        raise ValueError("overlap_add: only axis=-1 is supported")
    return _overlap_add(t, hop_length)


def _window_tensor(window, win_length, like):
    if window is None:
        return torch.ones(win_length, dtype=torch.float32,
                          device=like.device)
    return _t(window, ref=like)


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True):
    """Short-time Fourier transform of x [batch, n] or [n]: complex
    [batch, n_fft // 2 + 1 (or n_fft), n_frames]."""
    arr = _t(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    _frame_counts(arr.shape[-1] + (n_fft if center else 0), n_fft,
                  hop_length)
    win = _pad_window(_window_tensor(window, win_length, arr), win_length,
                      n_fft)
    squeeze = arr.dim() == 1
    if squeeze:
        arr = arr[None]
    if center:
        arr = _center(arr, n_fft, pad_mode)
    frames = _frame(arr, n_fft, hop_length) * win
    spec = (torch.fft.rfft if onesided else torch.fft.fft)(frames, dim=-1)
    out = spec.transpose(-1, -2)   # [batch, freq, time]
    if normalized:
        out = out / n_fft ** 0.5
    return out[0] if squeeze else out


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False):
    """Inverse STFT with the window-envelope (COLA) normalisation."""
    if onesided and return_complex:
        raise ValueError(
            "onesided=True produces a real signal; return_complex=True is "
            "contradictory (matches the reference's ValueError)")
    spec = _t(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    win = _pad_window(_window_tensor(window, win_length, spec), win_length,
                      n_fft)
    squeeze = spec.dim() == 2
    if squeeze:
        spec = spec[None]
    if normalized:
        spec = spec * n_fft ** 0.5
    frames_spec = spec.transpose(-1, -2)   # [batch, time, freq]
    if onesided:
        frames = torch.fft.irfft(frames_spec, n=n_fft, dim=-1)
    else:
        frames = torch.fft.ifft(frames_spec, n=n_fft, dim=-1)
        if not return_complex:
            frames = frames.real
    frames = frames * win
    y = _overlap_add(frames, hop_length)
    env = _overlap_add((win * win).expand(frames.shape[-2:]), hop_length)
    y = y / env.clamp(min=1e-11)
    if center:
        y = y[..., n_fft // 2:]
        if length is None:
            y = y[..., :y.shape[-1] - n_fft // 2]
    if length is not None:
        y = y[..., :length]
    return y[0] if squeeze else y
