"""Paged decode attention: the hand-written CUDA kernel, its wrapper and
its plain PyTorch version.

Counterpart: `paddle_tpu/ops/pallas/paged_attention.py` —
`paged_decode_attention` and the Pallas TPU kernel `_decode_kernel`.  The
kernel is `csrc/paged_attention.cu`; its source note says what bounds it
and how it is laid out.

Unlike the TPU kernel (D % 128 == 0 and bs % 8 == 0 only), the CUDA
kernel takes any block size, D a multiple of 8 from 8 to 256, H a
multiple of Hkv, and float32, bfloat16 or float16.

The kernel splits each row's context across blocks ("flash-decoding") and
merges the partial softmax states in the same launch.  `split_plan` picks
the split count from the table's width alone (`PARTITION_TOKENS` tokens a
partition, a multiple of the block size), never from `lens`, which lives
on the card: reading it would cost a device-to-host sync per call.  The
wrapper keeps one float32 workspace and one zeroed int32 arrival counter
per (row, kv head) per device, grown when a call needs more; launches
that share them must run in stream order (the engine's do).

`paged_decode_attention` runs the plain version only for tensors on the
CPU.  On a CUDA tensor it launches the kernel or raises; it never falls
back.  `paged_decode_attention.launches` counts the kernel's launches.
The keyword `_splits` forces a split count (`_splits=1`: one block walks
each row's whole context, the one-pass layout), for A/B timing and the
card tests only.

The kernel is also the operator `paddle_tpu_torch::paged_decode`
(`paged_decode_op`), the form `ops.paged_attention` calls under tracing
(eager calls take `paged_decode_attention` itself, whose host cost is
lower): `torch.export` keeps it as one node, and a program compiled ahead of time with
AOTInductor calls it back through its proxy executor.  CPU tensors take
the plain version, CUDA tensors `paged_decode_attention` (the launch is
counted there, inside a compiled program too), and a fake implementation
gives the shape to the tracer.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# tokens of context a block walks, rounded down to a multiple of the block
# size; chosen by timing partitions of 128 to 528 tokens and the one-pass
# layout at the serving shape on the card (PERF.md)
PARTITION_TOKENS = 512
_lib = None
_workspaces = {}    # device index -> (partials float32, arrivals int32)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_decode_attention.argtypes = [p, p, p, p, p, p, p, p,
                                               i, i, i, i, i, i, i, i,
                                               ctypes.c_float, i, i, p]
        lib.paged_decode_attention.restype = i
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _scale(scale, d):
    return float(scale) if scale is not None else 1.0 / (d ** 0.5)


def split_plan(M, bs, splits=None):
    """(splits, tokens per split) for block tables of M columns of bs
    tokens.  By default partitions of `PARTITION_TOKENS` rounded down to a
    multiple of bs (at least one block); `splits` asks for that many
    partitions instead (fewer if M has fewer columns).  Every partition is
    a whole number of blocks, and one split covers the whole table.  It
    reads the table's shape only, never the lengths."""
    cap = M * bs
    if splits is None:
        part = max(1, PARTITION_TOKENS // bs) * bs
    elif splits < 1:
        raise ValueError(f"_splits must be >= 1, got {splits}")
    else:
        part = -(-M // splits) * bs
    n = -(-cap // part)
    return (1, cap) if n == 1 else (n, part)


def _workspace(device, B, H, Hkv, D, splits):
    """The device's partial-state workspace (B * H * splits * (D + 2)
    float32) and arrival counters (B * Hkv int32, zero between launches),
    allocated once and grown when a call needs more."""
    part, arrivals = _workspaces.get(device.index, (None, None))
    need = B * H * splits * (D + 2)
    if part is None or part.numel() < need:
        part = torch.empty(need, dtype=torch.float32, device=device)
    if arrivals is None or arrivals.numel() < B * Hkv:
        arrivals = torch.zeros(B * Hkv, dtype=torch.int32, device=device)
    _workspaces[device.index] = (part, arrivals)
    return part, arrivals


def paged_decode_attention_plain(q, k_pool, v_pool, tables, lens,
                                 scale=None):
    """The kernel's math in plain PyTorch: gather each row's blocks, mask
    columns at or past `lens`, float32 scores, softmax and P.V, cast to
    the q dtype.  A row of length 0 gives 0, as the kernel does."""
    B, _, H, D = q.shape
    _, bs, Hkv, _ = k_pool.shape
    M = tables.shape[1]
    g = H // Hkv
    idx = tables.long()
    K = k_pool[idx].reshape(B, M * bs, Hkv, D).float()
    V = v_pool[idx].reshape(B, M * bs, Hkv, D).float()
    qf = q.reshape(B, Hkv, g, D).float()
    s = torch.einsum("bkgd,blkd->bkgl", qf, K) * _scale(scale, D)
    cols = torch.arange(M * bs, device=q.device)
    visible = cols[None, :] < lens.to(q.device).long()[:, None]    # [B, L]
    s = s.masked_fill(~visible[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgl,blkd->bkgd", p, V)
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(B, 1, H, D).to(q.dtype)


def _check(q, k_pool, v_pool, tables, lens):
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_decode_attention takes float32, bfloat16 "
                        f"or float16, not {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("q, k_pool and v_pool must share one dtype")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, D] (decode only), "
                         f"got {tuple(q.shape)}")
    B, _, H, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("k_pool and v_pool must both be [N, bs, Hkv, D]")
    _, bs, Hkv, Dk = k_pool.shape
    if Dk != D:
        raise ValueError(f"pool head_dim {Dk} != q head_dim {D}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"the kernel takes head_dim a multiple of 8 in "
                         f"[8, 256], got {D}")
    if not 1 <= B <= 65535:
        raise ValueError(f"batch {B} outside [1, 65535]")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != B or tables.shape[1] < 1:
        raise ValueError("tables must be int32 [B, M] with M >= 1")
    if lens.dtype != torch.int32 or tuple(lens.shape) != (B,):
        raise ValueError("lens must be int32 [B]")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_decode_attention(q, k_pool, v_pool, tables, lens, scale=None, *,
                           _splits=None):
    """One-token paged attention.  q: [B, 1, H, D]; pools [N, bs, Hkv, D];
    tables: [B, M] int32 block ids; lens: [B] int32 visible context length
    including the token just written.  Returns [B, 1, H, D] in q's dtype.
    CPU tensors take the plain version; CUDA tensors the kernel, with the
    split count `split_plan` gives (or `_splits`: A/B timing and card tests
    only)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, tables, lens,
                                            scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, "
                         f"not {q.device.type}")
    _check(q, k_pool, v_pool, tables, lens)
    B, _, H, D = q.shape
    _, bs, Hkv, _ = k_pool.shape
    M = tables.shape[1]
    splits, split_tokens = split_plan(M, bs, _splits)
    part = arrivals = None
    if splits > 1:
        part, arrivals = _workspace(q.device, B, H, Hkv, D, splits)
    out = torch.empty_like(q)
    lib = _kernel()
    rc = lib.paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(),
        B, H, Hkv, D, bs, M, splits, split_tokens, _scale(scale, D),
        _DTYPE_CODES[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"paged_decode_attention kernel failed: "
            f"{lib.paged_attention_error_string(rc).decode()} (code {rc})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


@torch.library.custom_op(
    "paddle_tpu_torch::paged_decode", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k_pool, Tensor v_pool, Tensor tables, "
           "Tensor lens, float scale) -> Tensor")
def paged_decode_op(q, k_pool, v_pool, tables, lens, scale):
    """`paged_decode_attention` as one operator, the scale resolved: CPU
    tensors take the plain version."""
    return paged_decode_attention_plain(q, k_pool, v_pool, tables, lens,
                                        scale)


@paged_decode_op.register_kernel("cuda")
def _paged_decode_op_cuda(q, k_pool, v_pool, tables, lens, scale):
    return paged_decode_attention(q, k_pool, v_pool, tables, lens, scale)


@paged_decode_op.register_fake
def _paged_decode_op_fake(q, k_pool, v_pool, tables, lens, scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _register_flop_formula():
    """The operator's FLOP formula for
    `torch.utils.flop_counter.FlopCounterMode`: Q K^T and P V over each
    row's `lens` tokens, 2 flops a multiply-add, every head.  `lens` is
    read from the tensor (a host read); a traced call (fake `lens`)
    counts the table's whole width instead."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.paddle_tpu_torch.paged_decode,
                           get_raw=True)
    def _flops(q, k_pool, v_pool, tables, lens, scale, *args, out_val=None,
               **kwargs):
        B, _, H, D = q.shape
        if isinstance(lens, FakeTensor):
            tokens = B * tables.shape[1] * k_pool.shape[1]
        else:
            tokens = int(lens.sum())
        return 4 * H * D * tokens


_register_flop_formula()
