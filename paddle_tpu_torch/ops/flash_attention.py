"""Flash attention: four families of hand-written CUDA kernels, their
wrappers, their plain PyTorch versions, and the operator that joins them
(`paddle_tpu_torch::flash_fwd`, a `torch.library` custom op with its
backward registered, so `torch.export` keeps the forward as one node).

Counterpart: `paddle_tpu/ops/pallas/flash_attention.py` — the Pallas TPU
kernels `_fwd_kernel` (`:84`), `_dkv_kernel` (`:262`) and `_dq_kernel`
(`:312`), the custom VJP `_flash_core` (`:455-481`), the entries
`flash_attention` (`:507`), `flash_block_fwd` / `flash_block_bwd`
(`:590-636`) and the gate `supports` (`:639-682`).

Kernel families (each source note says what bounds its kernels and how
they are laid out):
- "decode", `csrc/flash_decode.cu`: the forward alone, for short queries
  (Lq <= `DECODE_MAX_LQ`: a decode step, a speculative verify step);
  keys split across blocks (`decode_split_plan`, from Lk alone), one
  block per (kv head, batch, split) covering the g * Lq query rows of
  the kv head, partials merged by a second launch; every dtype, masks,
  causal, window, D a multiple of 8 up to 128.
- "sm90", `csrc/flash_attention_sm90.cu`: forward, dK/dV and dQ
  redesigned for Hopper (TMA ring, wgmma, warp specialisation; the
  forward and dQ q-stationary, dK/dV kv-stationary); bfloat16 / float16,
  D 64 or 128, 16-byte aligned operands; masks in all three (the
  backward kernels instantiated for no mask, a key vector and full rows).
- "fp32", `csrc/flash_fwd_fp32.cu`: the forward alone, in float32 on
  the CUDA cores (exact float32 FMAs, no TF32): register micro-tiles fed
  by float4 shared-memory loads, a cp.async ring of K/V tiles, per-element
  tests on edge tiles only; masks, causal, window, GQA, D a multiple of 8
  up to 128.
- "sm80", `csrc/flash_attention.cu`: forward, dK/dV and dQ on mma.sync
  tiles of 64 rows; every dtype, masks, D a multiple of 8 up to 128: the
  rest, the float32 backward among it.
The families are picked from the arguments before any launch, by one rule
for the forward and the backward: `_fwd_route(q, k, v, m4, dtype)` gives
"decode" for short queries, "sm90" where those kernels take the
operands, "fp32" for the rest in float32, "sm80" for the rest;
`_sm90_route(q, k, v, m4, dtype)` gives the backward's family, one for
dK/dV and dQ: "sm90" where those kernels take the operands, masked or
not, "sm80" otherwise (lse does not depend on the family that made it).
There is no fallback on failure: a failed build or launch raises.  The
keyword `_impl` of `flash_fwd_cuda`, `flash_bwd_dkv_cuda` and
`flash_bwd_dq_cuda` forces a family, for A/B timing and the card tests
only; forcing one on arguments it does not take raises ValueError
before any launch ("sm80" takes everything, "fp32" every float32
forward).

Layout is (B, L, H, D), GQA reads kv head h // (H // Hkv) without a
repeat, causal masking is bottom-right aligned over the real lengths
(`off = Lk - Lq`), a sliding window (with causal) keeps cols in
(r + off - window, r + off], and masks become additive float32 with their
batch, head and row broadcasts kept as strides of 0.  A row that sees
nothing gives o = 0 and lse = -inf (XLA's softmax gives NaN there).
The training path (bf16, D 128, causal, no mask, the q/k/v views of a
fused qkv projection) takes the sm90 forward, dK/dV and dQ; generation's
decode steps take the decode forward and its masked prefills the sm90
forward; a padded BERT step the sm90 forward, dK/dV and dQ, all under
the mask; float32 (ERNIE's inference, the card-vs-CPU checks) the fp32
forward and the sm80 dK/dV and dQ.

Tensors on the CPU take the plain versions; tensors on a CUDA device
launch the kernels or raise — there is no fallback.  The kernels take D a
multiple of 8 from 8 to 128 (the TPU kernel pads any D to 128 lanes);
`supports()` is the JAX gate narrowed to that.
`flash_attention.launches_fwd`, `.launches_dkv` and `.launches_dq` count
every launch of each kernel, of any family; `.launches_fwd_sm90`,
`.launches_dkv_sm90` and `.launches_dq_sm90` count those of the sm90
kernels, `.launches_fwd_decode` those of the decode forward (one per
call, its merge launch included) and `.launches_fwd_fp32` those of the
float32 forward.  The forward counts inside the operator's CUDA
implementation, so a program exported with the operator and loaded
elsewhere counts its launches too.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MASK_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_NEG_INF = float("-inf")
_MAX_D = 128
_SM90_DTYPES = (torch.bfloat16, torch.float16)
_SM90_HEAD_DIMS = (64, 128)
# queries of at most this many rows take the decode forward: a decode step
# (1) and a speculative verify step (k + 1)
DECODE_MAX_LQ = 16
# keys a decode block walks (one 64-key tile, 16 a warp; at Mistral-7B's
# decode shape 64 to 116 keys a split measured alike and 32 or fewer
# slower, PERF.md), and the most splits a call takes (longer contexts take
# longer splits)
DECODE_SPLIT_KEYS = 64
DECODE_MAX_SPLITS = 64


class _Params(ctypes.Structure):
    """`FlashParams` of csrc/flash_params.cuh, field for field."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "dout", "lse", "delta", "mask", "out", "lse_out",
            "dq", "dk", "dv")]
        + [(f"{t}_{s}", ctypes.c_int64)
           for t in ("q", "k", "v", "o", "do", "dq", "dk", "dv")
           for s in ("sb", "sl", "sh")]
        + [(n, ctypes.c_int64) for n in ("m_sb", "m_sh", "m_sr")]
        + [(n, ctypes.c_int) for n in (
            "B", "H", "Hkv", "Lq", "Lk", "D", "causal", "window")]
        + [("scale", ctypes.c_float)])


# (params, dtype, device, stream); the decode entry takes its partials, the
# split count and the keys a split after the params
_ARGS = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]
_DECODE_ARGS = _ARGS[:1] + [ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_int] + _ARGS[1:]
# source -> {launch entry: its argtypes}
_ENTRIES = {
    "flash_attention": {n: _ARGS for n in (
        "flash_attention_fwd", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq")},
    "flash_attention_sm90": {n: _ARGS for n in (
        "flash_attention_sm90_fwd", "flash_attention_sm90_bwd_dkv",
        "flash_attention_sm90_bwd_dq")},
    "flash_decode": {"flash_decode_fwd": _DECODE_ARGS},
    "flash_fwd_fp32": {"flash_fwd_fp32_fwd": _ARGS},
}
_libs = {}


def _kernel(source):
    """The loaded library of `csrc/<source>.cu`, its entries typed."""
    lib = _libs.get(source)
    if lib is None:
        lib = _build.load(source)
        for name, argtypes in _ENTRIES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        getattr(lib, f"{source}_params_size").restype = ctypes.c_int
        err = getattr(lib, f"{source}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        size = getattr(lib, f"{source}_params_size")()
        if size != ctypes.sizeof(_Params):
            raise RuntimeError(f"FlashParams is {size} bytes in {source} "
                               f"and {ctypes.sizeof(_Params)} in ctypes")
        _libs[source] = lib
    return lib


# ---------------------------------------------------------------- helpers
def _scale(scale, d):
    return float(scale) if scale is not None else 1.0 / (d ** 0.5)


def _window(window, is_causal):
    window = int(window or 0)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not is_causal:
        raise ValueError("window requires is_causal=True")
    return window


def _normalize_mask(mask):
    """-> additive float32 mask of 4 dims (mb, mh, mlq, Lk), contiguous,
    or None: a 2-dim mask is (Lq, Lk), a 3-dim one (B, Lq, Lk); bool True
    keeps.  As `_normalize_mask` (`:485-504`), the batch, head and row
    broadcasts stay size 1 (the kernels read them through strides of 0).
    Idempotent."""
    if mask is None:
        return None
    m = mask
    if m.dim() == 2:
        m = m[None, None]
    elif m.dim() == 3:
        m = m[:, None]
    if m.dtype == torch.bool:
        # log(True) = 0 and log(False) = -inf exactly, in one elementwise
        # launch (a fill and a masked fill take three on the card)
        m = torch.log(m)
    return m.float().contiguous()


def _keep(lq, lk, causal, window, device):
    """[Lq, Lk] bool of what causal / window leave visible, or None."""
    if not causal:
        return None
    off = lk - lq
    rows = torch.arange(lq, device=device)[:, None]
    cols = torch.arange(lk, device=device)[None, :]
    keep = rows + off >= cols
    if window:
        keep &= cols > rows + off - window
    return keep


def _scores(q, k, m4, causal, scale, window):
    """float32 scores [B, Hkv, g, Lq, Lk], masked to -inf, plus the mask."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    qf = q.float().permute(0, 2, 1, 3).reshape(B, Hkv, H // Hkv, Lq, D)
    kf = k.float().permute(0, 2, 1, 3)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kf) * scale
    keep = _keep(Lq, Lk, causal, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, _NEG_INF)
    if m4 is not None:
        s = s + m4.expand(B, H, Lq, Lk).reshape(B, Hkv, H // Hkv, Lq, Lk)
    return s, qf, kf


# --------------------------------------------------------- plain versions
def flash_fwd_plain(q, k, v, mask=None, is_causal=False, scale=None,
                    window=None):
    """The forward kernel's math in plain PyTorch -> (o (B, Lq, H, D) in
    q's dtype, lse (B, H, Lq) float32).  Scores and softmax in float32; p
    is cast to v's dtype before P.V, as `_fwd_kernel` does (`:135`), and
    P.V sums in float32."""
    B, Lq, H, D = q.shape
    window = _window(window, is_causal)
    s, _, _ = _scores(q, k, _normalize_mask(mask), is_causal,
                      _scale(scale, D), window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m == _NEG_INF, torch.zeros_like(m), m))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    vf = v.float().permute(0, 2, 1, 3)
    o = torch.einsum("bkgqc,bkcd->bkgqd", p.to(v.dtype).float(), vf) / l_safe
    o = o.reshape(B, H, Lq, D).transpose(1, 2).to(q.dtype)
    lse = (m + torch.log(l_safe)).reshape(B, H, Lq)
    return o, lse


def decode_split_plan(Lk, splits=None):
    """(splits, keys a split) for the decode forward over Lk keys: splits
    of `DECODE_SPLIT_KEYS` keys, at most `DECODE_MAX_SPLITS` of them (the
    splits of a longer context grow instead), or `splits` of about equal
    length when given.  No split is empty.  It reads Lk alone, never the
    mask, so a captured graph keeps its shape."""
    if splits is None:
        n = min(-(-Lk // DECODE_SPLIT_KEYS), DECODE_MAX_SPLITS)
    elif splits < 1:
        raise ValueError(f"_splits must be >= 1, got {splits}")
    else:
        n = min(int(splits), Lk)
    keys = -(-Lk // n)
    return -(-Lk // keys), keys


def flash_decode_plain(q, k, v, mask=None, is_causal=False, scale=None,
                       window=None, splits=None):
    """The decode forward's math in plain PyTorch -> (o, lse) as
    `flash_fwd_plain` gives them: the keys cut as `decode_split_plan`
    cuts them, each split's partial state (m, l, p.V with p rounded to v's
    dtype against the split's maximum) in float32, and the partials merged
    by their maxima; a split that sees nothing merges as empty.  For the
    tests and `chip_smoke.py`; CPU tensors take `flash_fwd_plain`."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    window = _window(window, is_causal)
    n, keys = decode_split_plan(Lk, splits)
    s, _, _ = _scores(q, k, _normalize_mask(mask), is_causal,
                      _scale(scale, D), window)       # [B, Hkv, g, Lq, Lk]
    pad = n * keys - Lk
    s = torch.nn.functional.pad(s, (0, pad), value=_NEG_INF)
    s = s.unflatten(-1, (n, keys))                    # [.., Lq, n, keys]
    vf = torch.nn.functional.pad(v.float().permute(0, 2, 1, 3),
                                 (0, 0, 0, pad)).unflatten(2, (n, keys))
    m = s.amax(dim=-1)                                # [.., Lq, n]
    zero = torch.zeros_like(m)
    p = torch.exp(s - torch.where(m == _NEG_INF, zero, m)[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqnc,bkncd->bkgqnd", p.to(v.dtype).float(), vf)
    mx = m.amax(dim=-1, keepdim=True)                 # [.., Lq, 1]
    w = torch.exp(m - torch.where(mx == _NEG_INF, torch.zeros_like(mx), mx))
    l = (w * l).sum(dim=-1)
    acc = (w[..., None] * acc).sum(dim=-2)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = (acc / l_safe[..., None]).reshape(B, H, Lq, D).transpose(1, 2)
    lse = (mx[..., 0] + torch.log(l_safe)).reshape(B, H, Lq)
    return o.to(q.dtype), lse


def flash_bwd_plain(q, k, v, do, lse, delta, mask=None, is_causal=False,
                    scale=None, window=None):
    """The backward kernels' math in plain PyTorch -> (dq, dk, dv) in the
    input dtypes, given the forward's lse (B, H, Lq) and delta =
    rowsum(dO * O) (B, H, Lq), both float32.  p = exp(s - lse) with lse
    taken as 0 where it is not finite (`_bwd_p`, `:258-259`); every product
    in float32, as `_dkv_kernel` / `_dq_kernel` take them
    (`:291-304`, `:340-351`)."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    window = _window(window, is_causal)
    scale = _scale(scale, D)
    s, qf, kf = _scores(q, k, _normalize_mask(mask), is_causal, scale,
                        window)
    lse5 = lse.float().reshape(B, Hkv, g, Lq, 1)
    lse5 = torch.where(torch.isfinite(lse5), lse5, torch.zeros_like(lse5))
    p = torch.exp(s - lse5)
    dof = do.float().permute(0, 2, 1, 3).reshape(B, Hkv, g, Lq, D)
    vf = v.float().permute(0, 2, 1, 3)
    dv = torch.einsum("bkgqc,bkgqd->bkcd", p, dof)
    dp = torch.einsum("bkgqd,bkcd->bkgqc", dof, vf)
    ds = p * (dp - delta.float().reshape(B, Hkv, g, Lq, 1))
    dk = torch.einsum("bkgqc,bkgqd->bkcd", ds, qf) * scale
    dq = torch.einsum("bkgqc,bkcd->bkgqd", ds, kf) * scale
    dq = dq.reshape(B, H, Lq, D).transpose(1, 2).to(q.dtype)
    return dq, dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


# ------------------------------------------------------- kernel wrappers
def _operand(x):
    """x (B, L, H, D) as the kernels read it: last dimension contiguous,
    data and every row 16-byte aligned; otherwise a contiguous copy.
    Returns (tensor, (batch, row, head) strides in elements)."""
    vec = 16 // x.element_size()
    st = [0 if x.shape[i] == 1 else x.stride(i) for i in range(3)]
    if x.stride(3) != 1 or x.data_ptr() % 16 or any(s % vec for s in st):
        x = x.contiguous()
        st = [0 if x.shape[i] == 1 else x.stride(i) for i in range(3)]
    return x, st


def _tma_ready(x):
    """Whether the sm90 kernels' tensor maps read x (B, L, H, D) as it is:
    last dimension contiguous, base 16-byte aligned, and the stride of
    every (batch, row, head) dimension longer than 1 a nonzero multiple of
    16 bytes."""
    vec = 16 // x.element_size()
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(x.stride(i) > 0 and x.stride(i) % vec == 0
                    for i in range(3) if x.shape[i] > 1))


def _tma_strides(x):
    """(batch, row, head) element strides for a tensor map of x: its own
    strides, except that a dimension of size 1 whose stride is zero or not
    a multiple of 16 bytes takes the stride it would have in a contiguous
    tensor (a map needs a nonzero aligned stride there, and never steps
    along it).  Computed here, not in the C entry, which only checks."""
    vec = 16 // x.element_size()
    _, L, H, D = x.shape
    return [s if s > 0 and s % vec == 0 else c
            for s, c in zip(x.stride()[:3], (L * H * D, H * D, D))]


def _sm90_takes(q, k, v, dtype):
    """Whether the sm90 kernels take these operands: bfloat16 / float16,
    D 64 or 128, and q, k, v that the tensor maps read as they are
    (`_tma_ready`).  All three take any mask `_normalize_mask` gives."""
    return (dtype in _SM90_DTYPES and q.shape[-1] in _SM90_HEAD_DIMS
            and all(_tma_ready(x) for x in (q, k, v)))


def _families(q, k, v, m4, dtype, fwd):
    """The families that take these arguments, the route's first: for the
    forward "decode" (Lq <= DECODE_MAX_LQ), "sm90", "fp32" (float32),
    "sm80"; for the backward "sm90", "sm80".  The mask does not decide the
    family."""
    out = []
    if fwd and q.shape[1] <= DECODE_MAX_LQ:
        out.append("decode")
    if _sm90_takes(q, k, v, dtype):
        out.append("sm90")
    if fwd and dtype == torch.float32:
        out.append("fp32")
    return tuple(out) + ("sm80",)


def _fwd_route(q, k, v, m4, dtype):
    """The forward's family for these arguments, decided before any
    launch: "decode" for short queries, "sm90" where those kernels take
    the operands (masked or not), "fp32" for float32, "sm80" otherwise."""
    return _families(q, k, v, m4, dtype, True)[0]


def _sm90_route(q, k, v, m4, dtype):
    """The backward's family (dK/dV and dQ together) for these arguments,
    decided before any launch: "sm90" where those kernels take the
    operands (masked or not), "sm80" otherwise."""
    return _families(q, k, v, m4, dtype, False)[0]


def _family(q, k, v, m4, impl, fwd=False):
    """The route of the forward (`fwd`) or the backward, or the family
    `impl` forces; a family that does not take the arguments raises
    ValueError ("sm80" takes everything, "fp32" every float32
    forward)."""
    fams = _families(q, k, v, m4, q.dtype, fwd)
    if impl is None:
        return fams[0]
    if impl in fams:
        return impl
    raise ValueError(f"the {impl} flash {'forward' if fwd else 'backward'} "
                     f"kernels do not take these arguments (the route "
                     f"gives {fams[0]})")


def _check(q, k, v, m4, extra=()):
    dev = q.device
    for name, t in (("k", k), ("v", v)) + tuple(extra):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention takes float32, bfloat16 or "
                        f"float16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError("q must be (B, Lq, H, D); k and v one (B, Lk, Hkv, "
                         "D) shape")
    B, Lq, H, D = q.shape
    Bk, Lk, Hkv, Dk = k.shape
    if Bk != B or Dk != D:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if D % 8 or not 8 <= D <= _MAX_D:
        raise ValueError(f"the kernels take head_dim a multiple of 8 in "
                         f"[8, {_MAX_D}], got {D}")
    if not (1 <= B <= 65535 and 1 <= H <= 65535 and Lq >= 1 and Lk >= 1):
        raise ValueError(f"shape {tuple(q.shape)} / {tuple(k.shape)} "
                         f"outside the launch grid")
    if m4 is not None:
        if m4.device != dev:
            raise ValueError(f"mask is on {m4.device}, q on {dev}")
        mb, mh, mlq, mlk = m4.shape
        if mb not in (1, B) or mh not in (1, H) or mlq not in (1, Lq) \
                or mlk != Lk:
            raise ValueError(f"mask {tuple(m4.shape)} does not broadcast "
                             f"to ({B}, {H}, {Lq}, {Lk})")


def _params(q, k, v, m4, causal, scale, window):
    B, Lq, H, D = q.shape
    p = _Params()
    p.B, p.H, p.Hkv, p.Lq, p.Lk, p.D = B, H, k.shape[2], Lq, k.shape[1], D
    p.causal, p.window, p.scale = int(bool(causal)), int(window), float(scale)
    if m4 is not None:
        mb, mh, mlq, mlk = m4.shape
        p.mask = m4.data_ptr()
        p.m_sb = 0 if mb == 1 else mh * mlq * mlk
        p.m_sh = 0 if mh == 1 else mlq * mlk
        p.m_sr = 0 if mlq == 1 else mlk
    return p


def _set(p, name, x, strides):
    setattr(p, {"o": "out", "do": "dout"}.get(name, name), x.data_ptr())
    for s, v in zip(("sb", "sl", "sh"), strides):
        setattr(p, f"{name}_{s}", v)


def _launch(source, fn, p, q, *extra):
    lib = _kernel(source)
    rc = getattr(lib, fn)(ctypes.byref(p), *extra, _DTYPE_CODES[q.dtype],
                          q.device.index or 0,
                          torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        err = getattr(lib, f"{source}_error_string")(rc).decode()
        raise RuntimeError(f"{fn} kernel failed: {err} (code {rc})")


def _operands(p, impl, named):
    """Point p at each (name, tensor): as the tensor maps read it (sm90,
    tensors already `_tma_ready`), or as `_operand` returns it (fp32, sm80
    and decode, which may copy).  Returns the tensors launched on."""
    out = []
    for name, x in named:
        if impl == "sm90":
            st = _tma_strides(x)
        else:
            x, st = _operand(x)
        _set(p, name, x, st)
        out.append(x)
    return out


def flash_fwd_cuda(q, k, v, mask=None, is_causal=False, scale=None,
                   window=None, *, _impl=None, _splits=None):
    """Launch a forward kernel -> (o (B, Lq, H, D), lse (B, H, Lq)
    float32): the family `_fwd_route` picks, or the one `_impl` forces,
    and for the decode family the split count `decode_split_plan` gives
    or `_splits` forces (A/B timing and card tests only).  CUDA tensors
    only; raises on what the kernel does not take."""
    window = _window(window, is_causal)
    m4 = _normalize_mask(mask)
    _check(q, k, v, m4)
    impl = _family(q, k, v, m4, _impl, fwd=True)
    if _splits is not None and impl != "decode":
        raise ValueError(f"_splits is for the decode family, not {impl}")
    B, Lq, H, D = q.shape
    p = _params(q, k, v, m4, is_causal, _scale(scale, D), window)
    q, k, v = _operands(p, impl, (("q", q), ("k", k), ("v", v)))
    o = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    _set(p, "o", o, _operand(o)[1])
    p.lse_out = lse.data_ptr()
    if impl == "decode":
        splits, keys = decode_split_plan(k.shape[1], _splits)
        # partials per call: inside a captured graph they come from the
        # graph's pool (csrc/flash_decode.cu says why)
        part = None if splits == 1 else torch.empty(
            B * H * Lq * splits * (D + 2), dtype=torch.float32,
            device=q.device)
        _launch("flash_decode", "flash_decode_fwd", p, q,
                None if part is None else part.data_ptr(), splits, keys)
        flash_attention.launches_fwd_decode += 1
    elif impl == "sm90":
        _launch("flash_attention_sm90", "flash_attention_sm90_fwd", p, q)
        flash_attention.launches_fwd_sm90 += 1
    elif impl == "fp32":
        _launch("flash_fwd_fp32", "flash_fwd_fp32_fwd", p, q)
        flash_attention.launches_fwd_fp32 += 1
    else:
        _launch("flash_attention", "flash_attention_fwd", p, q)
    flash_attention.launches_fwd += 1
    return o, lse


def _bwd_params(q, k, v, do, lse, delta, mask, is_causal, scale, window,
                impl=None):
    """Checked launch parameters of a backward kernel of family `impl`
    (None: the route's), the tensors they point into (kept alive by the
    caller until the launch) and the family."""
    window = _window(window, is_causal)
    m4 = _normalize_mask(mask)
    _check(q, k, v, m4, (("do", do), ("lse", lse), ("delta", delta)))
    B, Lq, H, D = q.shape
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"do {tuple(do.shape)} != q {tuple(q.shape)}")
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, Lq):
            raise ValueError(f"{name} must be (B, H, Lq) = "
                             f"{(B, H, Lq)}, got {tuple(t.shape)}")
    impl = _family(q, k, v, m4, impl)
    p = _params(q, k, v, m4, is_causal, _scale(scale, D), window)
    do = do.to(q.dtype)
    if impl == "sm90" and not _tma_ready(do):
        do = do.contiguous()
    q, k, v, do = _operands(p, impl, (("q", q), ("k", k), ("v", v),
                                      ("do", do)))
    p.lse, p.delta = lse.data_ptr(), delta.data_ptr()
    return p, (q, k, v, do, lse, delta, m4), impl


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, mask=None, is_causal=False,
                       scale=None, window=None, *, _impl=None):
    """Launch a dK/dV kernel -> (dk, dv), given lse and delta (B, H, Lq)
    float32 (from any forward family): the family `_sm90_route` picks, or
    the one `_impl` forces (A/B timing and card tests only).  CUDA tensors
    only."""
    p, held, impl = _bwd_params(q, k, v, do, lse, delta, mask, is_causal,
                                scale, window, _impl)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _set(p, "dk", dk, _operand(dk)[1])
    _set(p, "dv", dv, _operand(dv)[1])
    if impl == "sm90":
        _launch("flash_attention_sm90", "flash_attention_sm90_bwd_dkv", p,
                held[0])
        flash_attention.launches_dkv_sm90 += 1
    else:
        _launch("flash_attention", "flash_attention_bwd_dkv", p, held[0])
    flash_attention.launches_dkv += 1
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, mask=None, is_causal=False,
                      scale=None, window=None, *, _impl=None):
    """Launch a dQ kernel -> dq, given lse and delta (B, H, Lq) float32:
    the family `_sm90_route` picks, or the one `_impl` forces (A/B timing
    and card tests only).  CUDA tensors only."""
    p, held, impl = _bwd_params(q, k, v, do, lse, delta, mask, is_causal,
                                scale, window, _impl)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _set(p, "dq", dq, _operand(dq)[1])
    if impl == "sm90":
        _launch("flash_attention_sm90", "flash_attention_sm90_bwd_dq", p,
                held[0])
        flash_attention.launches_dq_sm90 += 1
    else:
        _launch("flash_attention", "flash_attention_bwd_dq", p, held[0])
    flash_attention.launches_dq += 1
    return dq


def flash_bwd_cuda(q, k, v, do, lse, delta, mask=None, is_causal=False,
                   scale=None, window=None):
    """Launch the dK/dV kernel, then the dQ kernel -> (dq, dk, dv), given
    lse and delta (B, H, Lq) float32.  CUDA tensors only."""
    m4 = _normalize_mask(mask)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, m4, is_causal,
                                scale, window)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, m4, is_causal, scale,
                           window)
    return dq, dk, dv


@torch.library.custom_op(
    "paddle_tpu_torch::flash_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor? mask, bool is_causal, "
           "float scale, int window) -> (Tensor, Tensor)")
def flash_fwd_op(q, k, v, mask, is_causal, scale, window):
    """The flash forward as one operator -> (o (B, Lq, H, D) in q's dtype,
    lse (B, H, Lq) float32), given a mask as `_normalize_mask` leaves it,
    the scale and the window already resolved.  `torch.export` keeps it
    as one node, which a loaded program runs: CPU tensors take
    `flash_fwd_plain`, CUDA tensors `flash_fwd_cuda` (which counts the
    launch there, so a loaded program's launches are counted too)."""
    o, lse = flash_fwd_plain(q, k, v, mask, is_causal, scale, window)
    return o.contiguous(), lse.contiguous()


@flash_fwd_op.register_kernel("cuda")
def _flash_fwd_op_cuda(q, k, v, mask, is_causal, scale, window):
    return flash_fwd_cuda(q, k, v, mask, is_causal, scale, window)


@flash_fwd_op.register_fake
def _flash_fwd_op_fake(q, k, v, mask, is_causal, scale, window):
    B, Lq, H, D = q.shape
    return (q.new_empty((B, Lq, H, D)),
            q.new_empty((B, H, Lq), dtype=torch.float32))


def _flash_fwd_op_setup(ctx, inputs, output):
    q, k, v, m4, causal, scale, window = inputs
    o, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, m4, o, lse)
    ctx.args = (causal, scale, window)


def _flash_fwd_op_backward(ctx, do, _dlse):
    """delta in plain torch ops, then the dK/dV and dQ kernels (CUDA) or
    their plain version (CPU).  Masks are inputs, not trained parameters:
    their gradient is None (callers with a mask that needs one take the
    plain path, as `ops.sdpa` routes them)."""
    q, k, v, m4, o, lse = ctx.saved_tensors
    dq, dk, dv = _backward(q, k, v, o, lse, do, m4, *ctx.args)
    return dq, dk, dv, None, None, None, None


flash_fwd_op.register_autograd(_flash_fwd_op_backward,
                               setup_context=_flash_fwd_op_setup)


def _forward(q, k, v, m4, causal, scale, window):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    return flash_fwd_op(q, k, v, m4, causal, scale, window)


def _delta(do, o):
    """rowsum(dO * O) in float32, (B, H, Lq) like lse (`:365-366`)."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _backward(q, k, v, o, lse, do, m4, causal, scale, window):
    delta = _delta(do, o)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, m4, causal, scale,
                               window)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    return flash_bwd_cuda(q, k, v, do, lse, delta, m4, causal, scale, window)


def flash_attention(q, k, v, mask=None, is_causal=False, scale=None,
                    window=None):
    """Flash attention on (B, L, H, D) -> (B, Lq, H, D) in q's dtype, with
    gradients for q, k and v (the operator's registered backward, in place
    of `_flash_core`'s custom VJP).  `mask` is bool (True keeps) or
    additive, of shape (Lq, Lk), (B, Lq, Lk) or (B|1, H|1, Lq|1, Lk).
    `window` (sliding window, needs is_causal) keeps cols in (r + off -
    window, r + off]; a negative window raises ValueError (the JAX entry
    does not check it)."""
    window = _window(window, is_causal)
    D = q.shape[-1]
    return _forward(q, k, v, _normalize_mask(mask), bool(is_causal),
                    _scale(scale, D), window)[0]


flash_attention.launches_fwd = 0
flash_attention.launches_dkv = 0
flash_attention.launches_dq = 0
flash_attention.launches_fwd_sm90 = 0
flash_attention.launches_fwd_decode = 0
flash_attention.launches_fwd_fp32 = 0
flash_attention.launches_dkv_sm90 = 0
flash_attention.launches_dq_sm90 = 0


def flash_block_fwd(q, k, v, is_causal, scale=None):
    """One attention block on (B, L, H, D) shards -> (o (B, Lq, H, D) in
    the input dtype, lse (B, H, Lq) float32), through the same route as
    `flash_attention`; no autograd (ring attention composes these and
    writes its own backward)."""
    with torch.no_grad():
        return _forward(q, k, v, None, bool(is_causal),
                        _scale(scale, q.shape[-1]), 0)


def flash_block_bwd(q, k, v, o, lse, do, is_causal, scale=None):
    """Partial gradients of one block given the GLOBAL (o, lse) and do:
    with the global lse, p = exp(s - lse) is the globally normalised block,
    so partials from several blocks simply sum.  Returns (dq, dk, dv) in
    the input dtypes."""
    with torch.no_grad():
        return _backward(q, k, v, o, lse, do.to(q.dtype), None,
                         bool(is_causal), _scale(scale, q.shape[-1]), 0)


def supports(q_shape, k_shape, mask, dtype, v_shape=None, is_causal=False):
    """The JAX gate (`:639-682`, without its TPU-build check), narrowed to
    the kernels' head dims (a multiple of 8 from 8 to 128).  Anything else
    takes the plain `sdpa`."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    if dtype not in _DTYPE_CODES:
        return False
    B, Lq, H, D = q_shape
    Lk = k_shape[1]
    Hkv = k_shape[2]
    if Hkv == 0 or H % Hkv:
        return False
    if is_causal and Lq > Lk:   # fully-masked rows: plain gives NaN,
        return False            # the kernel 0 — keep numerics equal
    if k_shape[3] != D:
        return False
    if v_shape is not None and tuple(v_shape) != tuple(k_shape):
        return False
    if D % 8 or not 8 <= D <= _MAX_D:
        return False
    if mask is not None:
        ms = getattr(mask, "shape", None)
        md = getattr(mask, "dtype", None)
        if ms is None or len(ms) not in (2, 3, 4):
            return False
        if md != torch.bool and md not in _MASK_DTYPES:
            return False
        if len(ms) == 2:
            ms = (1, 1) + tuple(ms)
        elif len(ms) == 3:
            ms = (ms[0], 1, ms[1], ms[2])
        mb, mh, mlq, mlk = ms
        if mb not in (1, B) or mh not in (1, H):
            return False
        if mlq not in (1, Lq) or mlk != Lk:
            return False
        if is_causal and mlq == 1 and Lq != Lk:
            return False
    if Lq < 1 or Lk < 1:
        return False
    return True
