"""The port's flash attention against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX
`flash_attention(..., interpret=True)` (its Pallas kernels in interpret
mode, as tests/test_pallas.py runs them) and the port's `flash_attention`
(the `paddle_tpu_torch::flash_fwd` operator and its registered backward
over the plain versions, which is what CPU tensors take).  Forward outputs are compared, and gradients through `jax.vjp`
against `torch.autograd.grad` with one cotangent.  The case list follows
tests/test_pallas.py at a tiny size.  Also: the `supports()` gate against
the JAX gate, `flash_block_fwd` / `flash_block_bwd` against JAX's, the
window checks, the plain `sdpa`'s sliding window against `sdpa_k`, and
`torch.library.opcheck` of the operator (its schema, fake implementation,
autograd registration and traced backward) on the CPU.

Tolerance: float32 on both sides, summed in another order (the JAX kernel
blockwise with an online softmax, the port densely): rtol = atol = 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.nn_kernels import sdpa_k
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import nn_kernels

TOL = dict(rtol=1e-5, atol=1e-5)

# name: (B, Lq, Lk, H, Hkv, D, causal, window, mask kind, check grads)
CASES = {
    "causal": (2, 40, 40, 4, 4, 16, True, 0, None, True),
    "full": (2, 40, 40, 4, 4, 16, False, 0, None, True),
    "cross_length_causal": (1, 16, 40, 4, 4, 16, True, 0, None, True),
    "gqa_causal": (2, 32, 32, 4, 2, 16, True, 0, None, True),
    "gqa_full": (1, 24, 24, 4, 1, 16, False, 0, None, True),
    "mask_bool_padding": (2, 32, 32, 4, 4, 16, False, 0, "bool_padding",
                          True),
    "mask_additive_full": (2, 24, 24, 4, 4, 16, False, 0, "additive_full",
                           False),
    "mask_bool_full_bh": (2, 24, 24, 4, 4, 16, True, 0, "bool_full_bh",
                          False),
    "mask_additive_row_batch1": (2, 24, 24, 4, 4, 16, True, 0,
                                 "additive_row1", True),
    "ragged_37": (2, 37, 37, 4, 4, 16, True, 0, None, True),
    "ragged_7": (1, 7, 7, 4, 4, 16, False, 0, None, False),
    "decode_masked": (2, 1, 40, 4, 4, 16, False, 0, "bool_padding", True),
    "window": (1, 40, 40, 4, 2, 16, True, 9, None, True),
}


def _mask(kind, B, Lq, Lk, H, rng):
    if kind is None:
        return None
    if kind == "bool_padding":
        lens = rng.integers(1, Lk + 1, size=B)
        return (np.arange(Lk)[None, :] < lens[:, None])[:, None, None, :]
    if kind == "additive_full":
        return np.where(rng.random((B, 1, Lq, Lk)) < 0.8, 0.0,
                        -1e9).astype(np.float32)
    if kind == "bool_full_bh":
        return rng.random((B, H, Lq, Lk)) < 0.9
    if kind == "additive_row1":
        return rng.standard_normal((1, 1, 1, Lk)).astype(np.float32)
    raise ValueError(kind)


def _case(name, seed=0):
    B, Lq, Lk, H, Hkv, D, causal, window, kind, grads = CASES[name]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Lq, H, D), (B, Lk, Hkv, D), (B, Lk, Hkv, D), (B, Lq, H, D))]
    return arrs, _mask(kind, B, Lq, Lk, H, rng), causal, window, grads


def _jax(q, k, v, mask, causal, window):
    return jfa.flash_attention(q, k, v, mask=mask, is_causal=causal,
                               window=window or None, interpret=True)


def _torch(q, k, v, mask, causal, window):
    return tfa.flash_attention(q, k, v, mask=mask, is_causal=causal,
                               window=window or None)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_forward_and_grads_match_jax(name):
    (q, k, v, ct), mask, causal, window, grads = _case(name)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    if not grads:
        ref = _jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                   causal, window)
        out = _torch(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), tm, causal, window)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        return
    ref, vjp = jax.vjp(lambda a, b, c: _jax(a, b, c, jm, causal, window),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = _torch(*leaves, tm, causal, window)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for g, want in zip(got, vjp(jnp.asarray(ct))):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL)


def test_fully_masked_rows_give_zero_like_jax():
    """A row that sees nothing gives 0 in both kernels (XLA's softmax
    gives NaN there), and its lse is -inf."""
    (q, k, v, _), _, _, _, _ = _case("full", seed=3)
    mask = np.random.default_rng(3).random((2, 40, 40)) < 0.7
    mask[:, 5] = False
    ref = _jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               jnp.asarray(mask), False, 0)
    out = _torch(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), torch.from_numpy(mask), False, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[:, 5].any()
    _, lse = tfa.flash_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(mask))
    assert torch.isneginf(lse[:, :, 5]).all()


# shapes for the gate: (q shape, k shape, mask shape or None, mask dtype,
# v shape, causal)
GATE = [
    ((2, 128, 4, 64), (2, 128, 4, 64), None, None, None, False),
    ((2, 128, 4, 64), (2, 128, 2, 64), None, None, None, True),
    ((2, 128, 4, 64), (2, 128, 3, 64), None, None, None, False),
    ((2, 100, 4, 64), (2, 100, 4, 64), None, None, None, True),
    ((2, 128, 4, 64), (2, 64, 4, 64), None, None, None, True),    # Lq > Lk
    ((2, 64, 4, 64), (2, 128, 4, 64), None, None, None, True),
    ((2, 128, 4, 64), (2, 128, 4, 32), None, None, None, False),
    ((2, 128, 4, 64), (2, 128, 4, 64), None, None, (2, 128, 4, 32), False),
    ((2, 128, 4, 64), (2, 128, 4, 64), (2, 1, 128, 128), "f32", None, False),
    ((2, 128, 4, 64), (2, 128, 4, 64), (1, 4, 128, 128), "bool", None, True),
    ((2, 128, 4, 64), (2, 128, 4, 64), (2, 1, 1, 128), "bool", None, False),
    ((2, 128, 4, 64), (2, 128, 4, 64), (128, 128), "bf16", None, True),
    ((2, 128, 4, 64), (2, 128, 4, 64), (2, 128, 128), "f16", None, False),
    ((2, 128, 4, 64), (2, 128, 4, 64), (3, 1, 128, 128), "f32", None, False),
    ((2, 128, 4, 64), (2, 128, 4, 64), (2, 2, 128, 128), "f32", None, False),
    ((2, 128, 4, 64), (2, 128, 4, 64), (2, 1, 64, 128), "f32", None, False),
    ((2, 128, 4, 64), (2, 128, 4, 64), (2, 1, 128, 128), "i32", None, False),
    ((2, 128, 4, 64), (2, 128, 4, 64), (2, 1, 1, 128), "f32", None, True),
    ((2, 64, 4, 64), (2, 128, 4, 64), (2, 1, 1, 128), "f32", None, True),
    ((1, 1, 4, 64), (1, 40, 4, 64), (1, 1, 1, 40), "bool", None, False),
    ((2, 128, 4, 256), (2, 128, 4, 256), None, None, None, True),
    ((2, 128, 4, 12), (2, 128, 4, 12), None, None, None, True),
]
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16,
        "bool": jnp.bool_, "i32": jnp.int32}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
        "bool": torch.bool, "i32": torch.int32}


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i32"])
@pytest.mark.parametrize("i", range(len(GATE)))
def test_supports_is_the_jax_gate_narrowed_to_the_kernels_head_dims(i,
                                                                    dtype):
    qs, ks, ms, mdt, vs, causal = GATE[i]
    jm = None if ms is None else jnp.zeros(ms, _JDT[mdt])
    tm = None if ms is None else torch.zeros(ms, dtype=_TDT[mdt])
    want = jfa.supports(qs, ks, jm, _JDT[dtype], v_shape=vs,
                        is_causal=causal)
    D = qs[3]
    want = want and D % 8 == 0 and 8 <= D <= 128
    assert tfa.supports(qs, ks, tm, _TDT[dtype], v_shape=vs,
                        is_causal=causal) == want


@pytest.mark.parametrize("causal", [False, True])
def test_flash_block_fwd_and_bwd_match_jax(causal):
    """The raw entries ring attention composes: (o, lse) forward, and the
    backward from a given (o, lse, do)."""
    (q, k, v, do), _, _, _, _ = _case("cross_length_causal", seed=5)
    jo, jlse = jfa.flash_block_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal, interpret=True)
    to, tlse = tfa.flash_block_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    jg = jfa.flash_block_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jo, jlse, jnp.asarray(do), causal,
                             interpret=True)
    tg = tfa.flash_block_bwd(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), to, tlse,
                             torch.from_numpy(do), causal)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("name", ["causal", "gqa_full", "mask_bool_padding",
                                  "mask_additive_full", "window"])
def test_flash_op_passes_opcheck(name):
    """The operator as `torch.export` and autograd see it: opcheck runs
    its schema, fake (meta) implementation, autograd registration and a
    traced forward and backward with dynamic shapes against the CPU
    implementation; the fake gives o (B, Lq, H, D) in q's dtype and lse
    (B, H, Lq) float32."""
    (q, k, v, _), mask, causal, window, _ = _case(name, seed=7)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    m4 = tfa._normalize_mask(None if mask is None else torch.from_numpy(mask))
    args = (q, k, v, m4, causal, tfa._scale(None, q.shape[-1]),
            tfa._window(window, causal))
    torch.library.opcheck(torch.ops.paddle_tpu_torch.flash_fwd.default, args)
    with torch.device("meta"):
        fo, flse = tfa.flash_fwd_op(*(x.to("meta") if torch.is_tensor(x)
                                      else x for x in args))
    assert (fo.shape, fo.dtype) == (q.shape, q.dtype)
    assert (flse.shape, flse.dtype) == ((q.shape[0], q.shape[2],
                                         q.shape[1]), torch.float32)


def test_window_checks():
    (q, k, v, _), _, _, _, _ = _case("causal")
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    with pytest.raises(ValueError):      # the JAX entry raises here too
        tfa.flash_attention(q, k, v, window=8, is_causal=False)
    with pytest.raises(ValueError):      # the JAX entry does not check
        tfa.flash_attention(q, k, v, window=-1, is_causal=True)


@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("window", [1, 7, 40])
def test_plain_sdpa_sliding_window_matches_sdpa_k(window, gqa):
    rng = np.random.default_rng(window)
    H, Hkv = 4, (2 if gqa else 4)
    q = rng.standard_normal((2, 24, H, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, Hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, Hkv, 16)).astype(np.float32)
    ref = sdpa_k(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 is_causal=True, sliding_window=window)
    out = nn_kernels.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), is_causal=True,
                          sliding_window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    routed = ops.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), is_causal=True,
                      sliding_window=window)
    assert torch.equal(routed, out)     # CPU tensors take the plain sdpa


def test_flash_window_matches_plain_sdpa_window():
    """The flash band (kernel semantics) and the plain sdpa band agree."""
    (q, k, v, _), _, _, _, _ = _case("window", seed=7)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    np.testing.assert_allclose(
        tfa.flash_attention(q, k, v, is_causal=True, window=9).numpy(),
        nn_kernels.sdpa(q, k, v, is_causal=True, sliding_window=9).numpy(),
        **TOL)


# ------------------------------------------------------ the decode family
# The decode forward's plain version (the split partials and their merge,
# what csrc/flash_decode.cu computes) against the JAX kernel and against
# the port's flash_fwd_plain, at the generation paths' short queries.
# name: (B, Lq, Lk, H, Hkv, D, causal, window, mask kind)
DECODE_CASES = {
    # key padding that leaves the last splits wholly masked, GQA 4
    "decode_gqa4_padding": (2, 1, 96, 8, 2, 16, False, 0, "short_rows"),
    # a window that bites: the left splits see nothing, GQA 7
    "decode_gqa7_window": (2, 1, 80, 14, 2, 16, True, 12, None),
    # a verify step (Lq 5) under causal, a window and a padding mask
    "verify_gqa4_window_mask": (2, 5, 90, 8, 2, 16, True, 20,
                                "bool_padding"),
    # a verify step with a row that sees nothing, GQA 7
    "verify_gqa7_dead_row": (2, 5, 70, 7, 1, 16, False, 0, "dead_row"),
}


def _decode_case(name, dtype):
    B, Lq, Lk, H, Hkv, D, causal, window, kind = DECODE_CASES[name]
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, Lq, H, D), (B, Lk, Hkv, D), (B, Lk, Hkv, D)))
    mask = None
    if kind == "short_rows":            # (B, 1, 1, Lk): rows of 20 and 45
        mask = (np.arange(Lk)[None, :]
                < np.array([20, 45])[:, None])[:, None, None, :]
    elif kind == "bool_padding":
        mask = _mask(kind, B, Lq, Lk, H, rng)
    elif kind == "dead_row":            # (B, Lq, Lk), row 2 of batch 1 empty
        mask = rng.random((B, Lq, Lk)) < 0.7
        mask[1, 2] = False
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = _jax(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
               None if mask is None else jnp.asarray(mask), causal, window)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    return t, tm, causal, window, ref


_DECODE_REFS = {}


def _decode_ref(name, dtype):
    """The case's inputs and the JAX output, made once per case and dtype
    (the JAX reference does not depend on the split count)."""
    if (name, dtype) not in _DECODE_REFS:
        _DECODE_REFS[name, dtype] = _decode_case(name, dtype)
    return _DECODE_REFS[name, dtype]


# float32: both sides float32, summed in another order (JAX blockwise, the
# plain version per split then merged): 1e-5.  bfloat16: both round p to
# bfloat16 before P.V but against other maxima (a JAX key block's running
# maximum, a split's), and o rounds once: 2 units in the last place of
# bfloat16 at the scale of the unit-normal v, 1.6e-2 (chip_smoke.py's
# FLASH_FWD_TOL).  lse is float32 in both dtypes: 1e-5.
DECODE_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
              torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_plain_matches_jax_and_flash_plain(name, splits, dtype):
    (q, k, v), mask, causal, window, ref = _decode_ref(name, dtype)
    n, keys = tfa.decode_split_plan(k.shape[1], splits)
    assert n == splits and (n - 1) * keys < k.shape[1] <= n * keys
    o, lse = tfa.flash_decode_plain(q, k, v, mask, causal, None, window,
                                    splits)
    assert o.dtype == dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), ref, **DECODE_TOL[dtype])
    want_o, want_lse = tfa.flash_fwd_plain(q, k, v, mask, causal, None,
                                           window)
    np.testing.assert_allclose(o.float().numpy(), want_o.float().numpy(),
                               **DECODE_TOL[dtype])
    # lse: -inf exactly where a row sees nothing, else float32 close
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want_lse))
    fin = torch.isfinite(want_lse)
    np.testing.assert_allclose(lse[fin].numpy(), want_lse[fin].numpy(),
                               rtol=1e-5, atol=1e-5)
    if name == "verify_gqa7_dead_row":
        assert not o[1, 2].float().any() and torch.isneginf(lse[1, :, 2]).all()
    if name in ("decode_gqa4_padding", "decode_gqa7_window") and splits > 2:
        assert torch.isfinite(lse).all()    # empty splits merged as empty
