"""The port's flash attention: plain versions, wrappers and CUDA kernels.

This file imports torch and numpy only, so it also runs on the machine
with the card, which has no JAX.  There, run it without the JAX test
setup of tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_flash_kernel.py

On the CPU the `cuda` tests skip; the rest hold the plain versions (what
the wrappers run for CPU tensors) against float64 dense attention and its
autograd gradients, and the routes that pick a kernel family.  The card
tests run each case through the families that take it: "sm80"
(csrc/flash_attention.cu), "sm90" (csrc/flash_attention_sm90.cu: forward,
dK/dV and dQ, masked or not), "fp32" (csrc/flash_fwd_fp32.cu: the
float32 forward) and, for short queries,
"decode" (csrc/flash_decode.cu, the forward at every split count), forced
with the wrappers' `_impl` and `_splits`; and the decode forward inside
captured CUDA graphs.  The parity of this op with the JAX package is in
tests/test_torch_flash_attention.py.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa

# name: (B, Lq, Lk, H, Hkv, D, causal, window, mask kind)
CASES = {
    "causal": (2, 128, 128, 2, 2, 64, True, 0, None),
    "full": (1, 96, 96, 4, 4, 32, False, 0, None),
    "cross_length_causal": (1, 64, 128, 2, 2, 64, True, 0, None),
    "gqa_causal": (2, 80, 80, 8, 2, 64, True, 0, None),
    "gqa_full": (1, 70, 70, 6, 3, 32, False, 0, None),
    "bool_padding": (2, 128, 128, 2, 2, 64, False, 0, "bool_padding"),
    "additive_full": (2, 100, 100, 2, 2, 64, False, 0, "additive_full"),
    "bool_full_bh": (2, 64, 64, 2, 2, 32, True, 0, "bool_full_bh"),
    "additive_row_batch1": (3, 50, 50, 2, 2, 64, True, 0, "additive_row1"),
    "ragged_100": (1, 100, 100, 2, 2, 64, True, 0, None),
    "ragged_257": (2, 257, 257, 2, 2, 32, False, 0, None),
    "ragged_7": (1, 7, 7, 2, 2, 64, True, 0, None),
    "decode_masked": (2, 1, 128, 4, 4, 64, False, 0, "bool_padding"),
    "window_40": (1, 200, 200, 2, 2, 64, True, 40, None),
    "window_cross": (1, 64, 150, 2, 1, 32, True, 33, None),
    "masked_row": (2, 40, 40, 2, 2, 64, False, 0, "dead_row"),
    "d8": (1, 33, 33, 2, 2, 8, True, 0, None),
    "d72": (1, 65, 65, 2, 1, 72, True, 0, None),
    "d128": (1, 130, 130, 2, 2, 128, True, 0, None),
    # short queries (the decode family): a window that bites at GQA 4, a
    # verify step (Lq 5) under a padding mask at GQA 7, an additive mask
    # at GQA 8 and D 128
    "decode_gqa4_window": (2, 1, 300, 8, 2, 64, True, 50, None),
    "verify_gqa7_padding": (2, 5, 150, 14, 2, 128, True, 0, "bool_padding"),
    "decode_gqa8_additive": (3, 1, 129, 16, 2, 128, False, 0,
                             "additive_full"),
    # BERT-base's fine-tune shape (batch 32, seq 128, 12 heads of 64),
    # unmasked and under its additive key-padding mask [32, 1, 1, 128]
    # (0 / -1e4, rows 64 to 128 long)
    "bert": (32, 128, 128, 12, 12, 64, False, 0, None),
    "bert_padding": (32, 128, 128, 12, 12, 64, False, 0,
                     "additive_padding"),
    # more of the mask layouts the sm90 backward takes (its key-vector and
    # full-row instantiations): a key vector under GQA, causal and a window
    # that leaves short rows nothing to see; a key vector per head; full
    # rows per head (bool) and batch-broadcast (a prefill into a longer
    # buffer); rows that see nothing at D 128; an odd Lk, so the full
    # mask's rows are not 8-byte aligned
    "keys_gqa_window": (3, 150, 200, 8, 2, 64, True, 96, "bool_padding"),
    "keys_per_head": (2, 130, 130, 8, 2, 128, False, 0, "additive_keys_bh"),
    "full_bh_d128": (2, 96, 160, 8, 4, 128, True, 0, "bool_full_bh"),
    "prefill_batch1": (2, 120, 150, 8, 2, 64, False, 0, "prefill"),
    "dead_row_d128": (2, 70, 70, 4, 4, 128, False, 0, "dead_row"),
    "full_odd_lk": (2, 65, 131, 4, 2, 64, True, 33, "additive_full"),
}


def make_mask(kind, B, Lq, Lk, H, rng):
    if kind is None:
        return None
    if kind == "bool_padding":          # (B, 1, 1, Lk) key padding
        lens = rng.integers(1, Lk + 1, size=B)
        m = np.arange(Lk)[None, :] < lens[:, None]
        return torch.from_numpy(m)[:, None, None, :]
    if kind == "additive_padding":      # (B, 1, 1, Lk): BERT's (1 - m) * -1e4
        lens = rng.integers(Lk // 2, Lk + 1, size=B)
        m = np.where(np.arange(Lk)[None, :] < lens[:, None], 0.0, -1e4)
        return torch.from_numpy(m.astype(np.float32))[:, None, None, :]
    if kind == "additive_full":         # (B, 1, Lq, Lk)
        return torch.from_numpy(np.where(rng.random((B, 1, Lq, Lk)) < 0.8,
                                         0.0, -1e9).astype(np.float32))
    if kind == "bool_full_bh":          # (B, H, Lq, Lk)
        return torch.from_numpy(rng.random((B, H, Lq, Lk)) < 0.9)
    if kind == "additive_row1":         # (1, 1, 1, Lk): batch broadcast
        return torch.from_numpy(
            rng.standard_normal((1, 1, 1, Lk)).astype(np.float32))
    if kind == "additive_keys_bh":      # (B, H, 1, Lk): a key vector a head
        return torch.from_numpy(
            rng.standard_normal((B, H, 1, Lk)).astype(np.float32))
    if kind == "prefill":               # (1, 1, Lq, Lk): c <= r + Lk - Lq
        return torch.from_numpy(np.arange(Lk)[None, :]
                                <= np.arange(Lq)[:, None] + Lk - Lq)[None,
                                                                     None]
    if kind == "dead_row":              # (B, Lq, Lk) with fully-masked rows
        m = rng.random((B, Lq, Lk)) < 0.7
        m[:, 3] = False
        m[1, 17] = False
        return torch.from_numpy(m)
    raise ValueError(kind)


def make_inputs(name, dtype=torch.float32, device="cpu", seed=0):
    B, Lq, Lk, H, Hkv, D, causal, window, kind = CASES[name]
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    q, k, v = t((B, Lq, H, D)), t((B, Lk, Hkv, D)), t((B, Lk, Hkv, D))
    do = t((B, Lq, H, D))
    mask = make_mask(kind, B, Lq, Lk, H, rng)
    if mask is not None:
        mask = mask.to(device)
    return q, k, v, do, mask, dict(is_causal=causal, window=window)


def dense64(q, k, v, mask, is_causal, window):
    """float64 dense attention (repeat for GQA); rows that see nothing
    give 0.  Returns (o, lse)."""
    q, k, v = (x.double() for x in (q, k, v))
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(H // Hkv, dim=2)
    v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / D ** 0.5
    if is_causal:
        r = torch.arange(Lq)[:, None] + Lk - Lq
        c = torch.arange(Lk)[None, :]
        keep = r >= c
        if window:
            keep &= c > r - window
        s = s.masked_fill(~keep, float("-inf"))
    if mask is not None:
        m = mask if mask.dim() == 4 else mask[:, None]
        s = s.masked_fill(~m, float("-inf")) if m.dtype == torch.bool \
            else s + m.double()
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse,
                                  torch.zeros_like(lse))[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", p, v), lse


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_matches_float64(name):
    q, k, v, _, mask, kw = make_inputs(name)
    o, lse = fa.flash_fwd_plain(q, k, v, mask, **kw)
    ref, ref_lse = dense64(q, k, v, mask, **kw)
    # float32 math against float64: a few float32 roundings
    torch.testing.assert_close(o.double(), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse.double(), ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_float64_autograd(name):
    q, k, v, do, mask, kw = make_inputs(name, seed=1)
    o, lse = fa.flash_fwd_plain(q, k, v, mask, **kw)
    delta = fa._delta(do, o)
    grads = fa.flash_bwd_plain(q, k, v, do, lse, delta, mask, **kw)
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    ref, _ = dense64(*leaves, mask, **kw)
    refs = torch.autograd.grad(ref, leaves, do.double())
    for got, want in zip(grads, refs):
        torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-5)


def test_wrapper_on_cpu_runs_the_plain_version():
    q, k, v, do, mask, kw = make_inputs("gqa_causal")
    before = (fa.flash_attention.launches_fwd,
              fa.flash_attention.launches_dkv,
              fa.flash_attention.launches_dq)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, mask, **kw)
    out.backward(do)
    o, lse = fa.flash_fwd_plain(q, k, v, mask, **kw)
    assert torch.equal(out.detach(), o)
    grads = fa.flash_bwd_plain(q, k, v, do, lse, fa._delta(do, o), mask,
                               **kw)
    for leaf, want in zip(leaves, grads):
        assert torch.equal(leaf.grad, want)
    assert (fa.flash_attention.launches_fwd, fa.flash_attention.launches_dkv,
            fa.flash_attention.launches_dq) == before   # no kernel ran


@pytest.mark.parametrize("bad", ["head_dim_big", "head_dim_odd", "gqa",
                                 "dtype", "mixed_dtype", "mask_shape",
                                 "lk_mismatch"])
def test_check_rejects_what_the_kernels_do_not_take(bad):
    q, k, v, _, mask, _ = make_inputs("causal")
    if bad == "head_dim_big":
        q, k, v = (torch.cat([x, x, x], dim=-1) for x in (q, k, v))
    elif bad == "head_dim_odd":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif bad == "gqa":
        k, v = torch.cat([k, k[:, :, :1]], 2), torch.cat([v, v[:, :, :1]], 2)
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed_dtype":
        k = k.half()
    elif bad == "mask_shape":
        mask = torch.zeros(2, 2, 3, 128)
    elif bad == "lk_mismatch":
        v = v[:, :100]
    with pytest.raises((ValueError, TypeError)):
        fa._check(q, k, v, fa._normalize_mask(mask))


def _fused_qkv(B, L, H, D, dtype):
    """q, k, v as the views unbind gives of a fused (B, L, 3, H, D)
    projection."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((B, L, 3, H, D)).astype(
        np.float32)).to(dtype)
    return qkv.unbind(2)


def _route_case(name):
    """-> (q, k, v, mask) of one route case, on the CPU."""
    rng = np.random.default_rng(5)

    def t(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    if name == "bf16_d128_causal_fused_qkv":
        return (*_fused_qkv(2, 64, 4, 128, torch.bfloat16), None)
    if name == "fp16_d64_gqa_window":
        return (t((2, 64, 8, 64), torch.float16),
                t((2, 64, 2, 64), torch.float16),
                t((2, 64, 2, 64), torch.float16), None)
    if name == "float32":
        return (*_fused_qkv(2, 64, 4, 128, torch.float32), None)
    if name == "additive_mask":
        q, k, v = _fused_qkv(2, 64, 4, 128, torch.bfloat16)
        return q, k, v, torch.zeros(2, 1, 64, 64)
    if name == "float32_masked":
        q, k, v = _fused_qkv(2, 64, 4, 128, torch.float32)
        return q, k, v, torch.zeros(2, 1, 64, 64)
    if name == "d96":
        return (*_fused_qkv(2, 64, 4, 96, torch.bfloat16), None)
    if name == "misaligned_view":            # base one element off
        buf = t((1 + 2 * 64 * 4 * 128,), torch.bfloat16)
        q = buf[1:].view(2, 64, 4, 128)
        k, v = _fused_qkv(2, 64, 4, 128, torch.bfloat16)[1:]
        return q, k, v, None
    if name == "batch1":
        return (*_fused_qkv(1, 64, 4, 128, torch.bfloat16), None)
    raise ValueError(name)


def _bwd_args(q):
    """dO, lse and delta for q (B, L, H, D): what a backward launch takes."""
    B, L, H, _ = q.shape
    return (torch.ones_like(q), torch.zeros(B, H, L), torch.zeros(B, H, L))


# name, the family of the forward, the family of dK/dV and dQ (Lq 64: no
# case here is short enough for the decode forward).  The forward and the
# backward follow one rule: a mask moves neither off sm90; float32 takes
# the fp32 forward and the sm80 backward
@pytest.mark.parametrize("name, family, dkv_family", [
    ("bf16_d128_causal_fused_qkv", "sm90", "sm90"),
    ("fp16_d64_gqa_window", "sm90", "sm90"),
    ("float32", "fp32", "sm80"),
    ("additive_mask", "sm90", "sm90"),
    ("d96", "sm80", "sm80"),
    ("misaligned_view", "sm80", "sm80"),
    ("batch1", "sm90", "sm90"),
])
def test_sm90_route(name, family, dkv_family):
    q, k, v, mask = _route_case(name)
    m4 = fa._normalize_mask(mask)
    assert fa._fwd_route(q, k, v, m4, q.dtype) == family
    assert fa._family(q, k, v, m4, None, fwd=True) == family
    assert fa._sm90_route(q, k, v, m4, q.dtype) == dkv_family
    assert fa._family(q, k, v, m4, None) == dkv_family
    assert fa._family(q, k, v, m4, "sm80") == "sm80"
    assert fa._family(q, k, v, m4, "sm80", fwd=True) == "sm80"
    with pytest.raises(ValueError):
        fa._family(q, k, v, m4, "decode", fwd=True)
    # a backward launch's parameters take the route too (no launch here)
    _, _, impl = fa._bwd_params(q, k, v, *_bwd_args(q), mask, True, None, 0)
    assert impl == dkv_family
    if dkv_family == "sm80":
        with pytest.raises(ValueError):
            fa._family(q, k, v, m4, "sm90")
    with pytest.raises(ValueError, match="backward"):
        fa._family(q, k, v, m4, "fp32")
    if family != "sm90":
        with pytest.raises(ValueError):
            fa._family(q, k, v, m4, "sm90", fwd=True)
        return
    # the tensor maps take the tensors' own strides: a fused view's row
    # stride is 3 H D, and a size-1 batch keeps the stride torch gives it
    for x in (q, k, v):
        assert fa._tma_strides(x) == list(x.stride()[:3])
    if name == "bf16_d128_causal_fused_qkv":
        assert fa._tma_strides(q)[1] == 3 * 4 * 128


@pytest.mark.parametrize("name", ["float32", "float32_masked", "d96",
                                  "misaligned_view"])
def test_dkv_forced_to_sm90_raises_before_any_launch(name):
    """Forcing the sm90 dK/dV kernel on arguments the route sends to sm80
    raises ValueError in the wrapper, before a library is loaded or a
    kernel launched (these tensors are on the CPU, so any launch would
    fail otherwise)."""
    q, k, v, mask = _route_case(name)
    before = (fa.flash_attention.launches_dkv,
              fa.flash_attention.launches_dkv_sm90)
    with pytest.raises(ValueError, match="sm90"):
        fa.flash_bwd_dkv_cuda(q, k, v, *_bwd_args(q), mask, is_causal=True,
                              _impl="sm90")
    assert (fa.flash_attention.launches_dkv,
            fa.flash_attention.launches_dkv_sm90) == before


def _short(Lq, dtype=torch.bfloat16, D=128, mask=False):
    """q (2, Lq, 8, D), k and v (2, 96, 2, D) on the CPU, and a bool
    mask (2, 1, Lq, 96) or None."""
    g = torch.Generator().manual_seed(Lq)
    q = torch.randn(2, Lq, 8, D, generator=g).to(dtype)
    k, v = (torch.randn(2, 96, 2, D, generator=g).to(dtype)
            for _ in range(2))
    m = torch.rand(2, 1, Lq, 96, generator=g) < 0.8 if mask else None
    return q, k, v, m


@pytest.mark.parametrize("Lq", [1, 5, 16, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [False, True])
def test_decode_route(Lq, dtype, mask):
    """Short queries (Lq <= DECODE_MAX_LQ), masked or not, in any dtype,
    take the decode forward, longer float32 ones the fp32 forward; the
    backward keeps its own route (sm90 for bf16 / fp16, masked or not);
    "sm90", "fp32" and "sm80" may be forced on a short query where they
    take it, "decode" never on a longer one nor on the backward."""
    q, k, v, m = _short(Lq, dtype, mask=mask)
    m4 = fa._normalize_mask(m)
    short = Lq <= fa.DECODE_MAX_LQ
    sm90 = dtype == torch.bfloat16
    want = "decode" if short else "sm90" if sm90 else "fp32"
    assert fa._fwd_route(q, k, v, m4, dtype) == want
    assert fa._family(q, k, v, m4, None, fwd=True) == want
    assert fa._families(q, k, v, m4, dtype, True) == (
        ("decode",) * short + ("sm90",) * sm90 + ("fp32",) * (not sm90)
        + ("sm80",))
    assert fa._sm90_route(q, k, v, m4, dtype) == ("sm90" if sm90
                                                  else "sm80")
    with pytest.raises(ValueError, match="backward"):
        fa._family(q, k, v, m4, "decode")
    if not short:
        with pytest.raises(ValueError, match="decode"):
            fa._family(q, k, v, m4, "decode", fwd=True)


@pytest.mark.parametrize("impl, splits, Lq", [
    ("decode", None, 17), ("sm90", None, 1), ("sm80", 2, 1), (None, 2, 17),
    ("decode", 0, 1), ("paged", None, 1)])
def test_forward_forced_wrongly_raises_before_any_launch(impl, splits, Lq):
    """Forcing a forward family (or a split count) on arguments it does
    not take raises ValueError in the wrapper, before a library is loaded
    or a kernel launched: float32 for sm90, Lq 17 for decode, `_splits`
    outside the decode family or below 1 (these tensors are on the CPU,
    so any launch would fail otherwise)."""
    q, k, v, m = _short(Lq, torch.float32, mask=True)
    before = _counts()
    with pytest.raises(ValueError):
        fa.flash_fwd_cuda(q, k, v, m, _impl=impl, _splits=splits)
    assert _counts() == before


@pytest.mark.parametrize("Lk, want", [
    (1, (1, 1)), (64, (1, 64)), (65, (2, 33)), (576, (9, 64)),
    (581, (10, 59)), (4096, (64, 64)), (4097, (64, 65)),
    (64 * 64 * 8, (64, 512))])
def test_decode_split_plan(Lk, want):
    """Splits of 64 keys, at most 64 of them, from Lk alone; none empty."""
    assert fa.decode_split_plan(Lk) == want
    for forced in range(1, 10):
        n, keys = fa.decode_split_plan(Lk, forced)
        assert n == min(forced, Lk) or (n < forced and n * keys >= Lk)
        assert (n - 1) * keys < Lk <= n * keys


def test_tma_strides_replace_a_zero_stride_of_a_size1_dim():
    x = torch.zeros(8, 2, 64, dtype=torch.bfloat16)[None]
    z = torch.as_strided(torch.zeros(8 * 2 * 64, dtype=torch.bfloat16),
                         (1, 8, 2, 64), (0, 128, 64, 1))
    assert fa._tma_strides(x) == [1024, 128, 64]
    assert fa._tma_strides(z) == [1024, 128, 64]     # 0 -> contiguous
    assert fa._sm90_route(z, z, z, None, torch.bfloat16) == "sm90"


@pytest.mark.parametrize("dtype, family, bwd_family", [
    (torch.bfloat16, "sm90", "sm90"), (torch.float16, "sm90", "sm90"),
    (torch.float32, "fp32", "sm80")])
def test_bert_padded_shape_routes_the_masked_backward(dtype, family,
                                                      bwd_family):
    """BERT's padded fine-tune (B 32, L 128, H 12, D 64, the q/k/v views of
    its [B, L, 3 H D] projection, the additive padding mask [32, 1, 1,
    128] that `text.bert.additive_mask` builds): the forward and dK/dV and
    dQ take sm90 in bf16 / fp16, the fp32 forward and the sm80 backward in
    float32, and the mask reaches the kernels as a key vector (row stride
    0, batch stride Lk, no head stride), the sm90 backward's and the fp32
    forward's key-vector instantiation."""
    from paddle_tpu_torch.text.bert import additive_mask
    B, L, H, D = 32, 128, 12, 64
    qkv = torch.zeros(B, L, 3 * H * D, dtype=dtype)
    q, k, v = (x.view(B, L, H, D) for x in qkv.split(H * D, dim=-1))
    lens = np.random.default_rng(7).integers(L // 2, L + 1, size=B)
    keep = torch.from_numpy(np.arange(L)[None, :] < lens[:, None])
    m4 = fa._normalize_mask(additive_mask(keep.long(), dtype))
    assert tuple(m4.shape) == (B, 1, 1, L) and m4.dtype == torch.float32
    assert fa._fwd_route(q, k, v, m4, dtype) == family
    assert fa._sm90_route(q, k, v, m4, dtype) == bwd_family
    p, _, impl = fa._bwd_params(q, k, v, *_bwd_args(q), m4, False, None, 0)
    assert impl == bwd_family
    assert (p.m_sb, p.m_sh, p.m_sr) == (L, 0, 0)
    assert p.mask == m4.data_ptr()
    if family == "sm90":    # the kernels read the views through strides
        assert [fa._tma_strides(x) for x in (q, k, v)] == [
            [L * 3 * H * D, 3 * H * D, D]] * 3
    if family == "fp32":    # the views reach the fp32 forward uncopied
        for x in (q, k, v):
            y, st = fa._operand(x)
            assert y.data_ptr() == x.data_ptr()
            assert st == [L * 3 * H * D, 3 * H * D, D]


@pytest.mark.parametrize("Lq, want", [(17, ("fp32", "sm80")),
                                      (64, ("fp32", "sm80")),
                                      (1, ("decode", "fp32", "sm80")),
                                      (16, ("decode", "fp32", "sm80"))])
@pytest.mark.parametrize("mask", [False, True])
def test_fp32_route(Lq, want, mask):
    """float32 forwards take the fp32 family above DECODE_MAX_LQ rows and
    may have it forced at or below; the backward stays on sm80, and
    "fp32" forced on it raises; bf16 and fp16 keep their families."""
    q, k, v, m = _short(Lq, torch.float32, D=64, mask=mask)
    m4 = fa._normalize_mask(m)
    assert fa._families(q, k, v, m4, torch.float32, True) == want
    assert fa._fwd_route(q, k, v, m4, torch.float32) == want[0]
    assert fa._family(q, k, v, m4, "fp32", fwd=True) == "fp32"
    assert fa._families(q, k, v, m4, torch.float32, False) == ("sm80",)
    assert fa._sm90_route(q, k, v, m4, torch.float32) == "sm80"
    with pytest.raises(ValueError, match="backward"):
        fa._family(q, k, v, m4, "fp32")
    _, _, impl = fa._bwd_params(q, k, v, *_bwd_args(q), m, False, None, 0)
    assert impl == "sm80"
    for dtype in (torch.bfloat16, torch.float16):
        qh, kh, vh = (x.to(dtype) for x in (q, k, v))
        fams = fa._families(qh, kh, vh, m4, dtype, True)
        assert "fp32" not in fams
        assert fams == ("decode",) * (Lq <= fa.DECODE_MAX_LQ) + (
            "sm90", "sm80")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("Lq", [1, 64])
def test_fp32_forced_on_half_raises_before_any_launch(dtype, Lq):
    """Forcing the fp32 forward on bfloat16 / float16 raises ValueError in
    the wrapper, before a library is loaded or a kernel launched (these
    tensors are on the CPU, so any launch would fail otherwise)."""
    q, k, v, m = _short(Lq, dtype, D=64, mask=True)
    before = _counts()
    with pytest.raises(ValueError, match="fp32"):
        fa.flash_fwd_cuda(q, k, v, m, _impl="fp32")
    assert _counts() == before


def test_window_must_be_causal_and_not_negative():
    q, k, v, _, _, _ = make_inputs("causal")
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, window=-1, is_causal=True)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, window=16, is_causal=False)


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 plain
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# kernel vs plain on the card.  Forward: both accumulate in float32 in
# another order; both round p to the working type before P.V, but against
# another running maximum (the kernel's per tile, the plain version's per
# row), and o rounds once: 2 units in the last place of bfloat16 / float16
# at the scale of the unit-normal v, relative and absolute (a few float32
# roundings in float32).  lse stays float32 whatever the input type.
# Backward: the kernels round p and dS to bfloat16 / float16 before the
# tensor-core products where the plain version keeps float32, and dS
# cancels, so the error is taken against the largest gradient element:
# max |kernel - plain| <= tol * max |plain|.
FWD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
           torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2),
           torch.float16: dict(rtol=2e-3, atol=2e-3)}
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 4e-3}


def _counts():
    f = fa.flash_attention
    return (f.launches_fwd, f.launches_dkv, f.launches_dq,
            f.launches_fwd_sm90, f.launches_dkv_sm90, f.launches_dq_sm90,
            f.launches_fwd_decode, f.launches_fwd_fp32)


def bwd_error(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sm80", "sm90", "fp32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain_on_card(card, name, dtype, family):
    """Each case through one kernel family.  A case a family does not take
    (sm90: float32, D other than 64 or 128; fp32: bfloat16 / float16)
    must be routed elsewhere, and forcing the family on it must raise
    before any launch; the sm90 forward, dK/dV and dQ and the fp32
    forward take every mask.  The fp32 family is a forward alone: two
    launches give the same bits.  The gradients are finite (rows that see
    nothing give 0), and a second dK/dV and dQ launch gives the same bits
    (no atomics)."""
    q, k, v, do, mask, kw = make_inputs(name, dtype=dtype, device=card)
    m4 = fa._normalize_mask(mask)
    if family not in fa._families(q, k, v, m4, dtype, True):
        before = _counts()
        with pytest.raises(ValueError):
            fa.flash_fwd_cuda(q, k, v, mask, **kw, _impl=family)
        assert _counts() == before
        return
    sm90, fp32 = int(family == "sm90"), int(family == "fp32")
    before = _counts()
    o, lse = fa.flash_fwd_cuda(q, k, v, mask, **kw, _impl=family)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + d for c, d in zip(
        before, (1, 0, 0, sm90, 0, 0, 0, fp32)))
    ref_o, ref_lse = fa.flash_fwd_plain(q, k, v, mask, **kw)
    torch.testing.assert_close(o.float(), ref_o.float(), **FWD_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    if fp32:
        o2, lse2 = fa.flash_fwd_cuda(q, k, v, mask, **kw, _impl=family)
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        return

    delta = fa._delta(do, ref_o)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, ref_lse, delta, mask, **kw,
                                   _impl=family)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, ref_lse, delta, mask, **kw,
                              _impl=family)
    torch.cuda.synchronize()
    assert _counts()[4:6] == (before[4] + sm90, before[5] + sm90)
    want = fa.flash_bwd_plain(q, k, v, do, ref_lse, delta, mask, **kw)
    for nm, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bool(torch.isfinite(a).all()), nm
        assert bwd_error(a, b) <= BWD_TOL[dtype], (nm, bwd_error(a, b))
    again = (*fa.flash_bwd_dkv_cuda(q, k, v, do, ref_lse, delta, mask, **kw,
                                    _impl=family),
             fa.flash_bwd_dq_cuda(q, k, v, do, ref_lse, delta, mask, **kw,
                                  _impl=family))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((dk, dv, dq), again))


DECODE_NAMES = sorted(n for n, c in CASES.items()
                      if c[1] <= fa.DECODE_MAX_LQ)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", DECODE_NAMES)
def test_decode_kernel_matches_plain_on_card(card, name, dtype, splits):
    """Each short-query case through the decode forward at every split
    count (None: the plan's), against its plain version (the same splits
    and merge) and against flash_fwd_plain, with the forward tolerances;
    the route takes it there without forcing."""
    q, k, v, _, mask, kw = make_inputs(name, dtype=dtype, device=card)
    assert fa._fwd_route(q, k, v, fa._normalize_mask(mask),
                         dtype) == "decode"
    before = _counts()
    o, lse = fa.flash_fwd_cuda(q, k, v, mask, **kw, _impl="decode",
                               _splits=splits)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + d for c, d in zip(
        before, (1, 0, 0, 0, 0, 0, 1, 0)))
    assert o.dtype == dtype and lse.dtype == torch.float32
    for ref_o, ref_lse in (
            fa.flash_decode_plain(q, k, v, mask, splits=splits, **kw),
            fa.flash_fwd_plain(q, k, v, mask, **kw)):
        torch.testing.assert_close(o.float(), ref_o.float(), **FWD_TOL[dtype])
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_decode_kernel_in_captured_graphs(card):
    """Two captured programs of different Lk (one split, and ten with a
    wholly masked tail), replayed in turns on fresh inputs: each replay
    equals the plain version.  The partials come from each graph's own
    pool, so neither replay reads memory the other freed or shares."""
    progs = []
    for Lk, lens in ((60, (60, 33)), (620, (600, 301))):
        q = torch.empty(2, 1, 32, 128, device=card, dtype=torch.bfloat16)
        k = torch.empty(2, Lk, 8, 128, device=card, dtype=torch.bfloat16)
        v = torch.empty_like(k)
        mask = (torch.arange(Lk, device=card)[None, :]
                < torch.tensor(lens, device=card)[:, None])[:, None, None]
        for x in (q, k, v):
            x.normal_()
        fa.flash_fwd_cuda(q, k, v, mask)         # built and loaded
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            o, lse = fa.flash_fwd_cuda(q, k, v, mask)
        progs.append((graph, (q, k, v, mask), (o, lse)))
    for turn in range(6):
        graph, (q, k, v, mask), (o, lse) = progs[turn % 2]
        for x in (q, k, v):
            x.normal_()
        graph.replay()
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.flash_fwd_plain(q, k, v, mask)
        torch.testing.assert_close(o.float(), ref_o.float(),
                                   **FWD_TOL[torch.bfloat16])
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_autograd_on_card_launches_each_kernel_once(card):
    q, k, v, do, _, _ = make_inputs("gqa_causal", dtype=torch.bfloat16,
                                    device=card)
    counts = (fa.flash_attention.launches_fwd,
              fa.flash_attention.launches_dkv,
              fa.flash_attention.launches_dq)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*leaves, is_causal=True).backward(do)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches_fwd, fa.flash_attention.launches_dkv,
            fa.flash_attention.launches_dq) == tuple(c + 1 for c in counts)


@pytest.mark.cuda
def test_autograd_on_card_takes_the_sm90_forward_and_dq(card):
    """The training path's arguments (bf16, D 128, causal, views of a fused
    qkv) launch the sm90 forward, dK/dV and dQ once each."""
    qkv = torch.stack(_fused_qkv(2, 200, 4, 128, torch.bfloat16), 2)
    qkv = qkv.to(card).requires_grad_()
    q, k, v = qkv.unbind(2)
    assert fa._sm90_route(q, k, v, None, q.dtype) == "sm90"
    do = torch.randn(2, 200, 4, 128, device=card).to(torch.bfloat16)
    before = _counts()
    fa.flash_attention(q, k, v, is_causal=True).backward(do)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + 1 for c in before[:6]) + before[6:]
    assert qkv.grad is not None and bool(torch.isfinite(qkv.grad).all())


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sm80", "sm90", "fp32"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_strided_qkv_views_match_contiguous(card, dtype, family):
    """q, k, v as the views unbind gives of a fused (b, s, 3, H, D)
    projection: read through their strides, no copy.  A family that does
    not take the dtype (sm90: float32; fp32: bf16 / fp16) raises before
    any launch."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 77, 3, 4, 64)).astype(
        np.float32)).to(card, dtype)
    q, k, v = qkv.unbind(2)
    if family not in fa._families(q, k, v, None, dtype, True):
        with pytest.raises(ValueError):
            fa.flash_fwd_cuda(q, k, v, is_causal=True, _impl=family)
        return
    o, lse = fa.flash_fwd_cuda(q, k, v, is_causal=True, _impl=family)
    o2, lse2 = fa.flash_fwd_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous(), is_causal=True,
                                 _impl=family)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sm80", "sm90"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("L, H, Hkv", [(77, 4, 4), (300, 8, 2), (130, 4, 1)])
def test_strided_views_dkv_match_contiguous(card, dtype, family, L, H, Hkv):
    """dK/dV on the views unbind gives of a fused projection (q of H
    heads, k and v of Hkv) equals dK/dV on contiguous copies, bit for bit
    (no atomics: the GQA group is summed in one block in a fixed order),
    and matches the plain version."""
    rng = np.random.default_rng(6)
    fused = torch.from_numpy(rng.standard_normal(
        (2, L, H + 2 * Hkv, 64)).astype(np.float32)).to(card, dtype)
    q, k, v = fused.split([H, Hkv, Hkv], dim=2)
    do = torch.from_numpy(rng.standard_normal((2, L, H, 64)).astype(
        np.float32)).to(card, dtype)
    o, lse = fa.flash_fwd_plain(q, k, v, is_causal=True)
    delta = fa._delta(do, o)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, is_causal=True,
                                   _impl=family)
    dk2, dv2 = fa.flash_bwd_dkv_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(), do, lse, delta,
                                     is_causal=True, _impl=family)
    torch.cuda.synchronize()
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    _, want_dk, want_dv = fa.flash_bwd_plain(q, k, v, do, lse, delta,
                                             is_causal=True)
    assert bwd_error(dk, want_dk) <= BWD_TOL[dtype]
    assert bwd_error(dv, want_dv) <= BWD_TOL[dtype]


@pytest.mark.cuda
def test_kernel_raises_on_unsupported_shape(card):
    q, k, v, _, _, _ = make_inputs("causal", device=card)
    q, k, v = (torch.cat([x, x, x], dim=-1) for x in (q, k, v))   # D 192
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, is_causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exported_encoder_holds_the_op_and_counts_launches(card, dtype,
                                                           tmp_path):
    """An ERNIE encoder (2 layers, D 64) exported on the card holds the
    flash operator once per layer; its predictor launches the forward
    once per layer a run (sm90 in bf16, fp32 in float32) and gives the
    eager model's logits."""
    from paddle_tpu_torch import amp, inference
    from paddle_tpu_torch.jit import InputSpec, save_inference
    from paddle_tpu_torch.text import (ErnieConfig,
                                       ErnieForSequenceClassification)
    cfg = ErnieConfig(vocab_size=500, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=256,
                      hidden_dropout_prob=0.0)
    model = ErnieForSequenceClassification(cfg, device=card)
    if dtype != torch.float32:
        amp.decorate(models=model, dtype="bfloat16")
    model.eval()
    save_inference(model, str(tmp_path), [InputSpec([None, 64], "int64",
                                                    "input_ids")])
    predictor = inference.create_predictor(inference.Config(str(tmp_path)))
    graph = predictor._layer.program.graph
    ops_ = [n for n in graph.nodes if n.op == "call_function"
            and "paddle_tpu_torch.flash_fwd" in str(n.target)]
    assert len(ops_) == cfg.num_hidden_layers
    ids = np.random.default_rng(0).integers(0, 500, (4, 64))
    h = predictor.get_input_handle("input_ids")
    h.copy_from_cpu(ids)
    before = _counts()
    predictor.run()
    logits = predictor.get_output_handle("output_0").copy_to_cpu()
    grew = tuple(a - b for a, b in zip(_counts(), before))
    sm90 = cfg.num_hidden_layers if dtype == torch.bfloat16 else 0
    fp32 = cfg.num_hidden_layers - sm90
    assert grew == (cfg.num_hidden_layers, 0, 0, sm90, 0, 0, 0, fp32)
    with torch.no_grad():
        eager = model(torch.from_numpy(ids).to(card)).float().cpu().numpy()
    np.testing.assert_array_equal(logits.astype(np.float32), eager)
