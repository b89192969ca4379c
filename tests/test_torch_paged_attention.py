"""Parity of the port's paged attention ops with the JAX package, on CPU.

The port's plain versions (`paddle_tpu_torch/ops/nn_kernels.py` and the
kernel module's plain version, which the wrapper runs for CPU tensors)
against `paddle_tpu/ops/nn_kernels.py` and the Pallas TPU kernel run in
interpret mode, on the same numpy inputs.  The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_paged_kernel.py,
chip_smoke.py).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.nn_kernels import (paged_attention_k, paged_write_k,
                                       sdpa_k)
from paddle_tpu.ops.pallas import paged_attention as jax_pa
import paddle_tpu_torch.ops as tops
from paddle_tpu_torch.ops import nn_kernels as tk
from paddle_tpu_torch.ops import paged_decode as pd


def _case(s=1, dtype=np.float32, seed=0):
    """The case of tests/test_serving.py's pallas-vs-fallback test:
    B=3, H=4, Hkv=2, D=128, bs=8, a 12-block pool, 4 table columns."""
    rng = np.random.RandomState(seed)
    B, H, Hkv, D, bs, N, M = 3, 4, 2, 128, 8, 12, 4
    q = rng.randn(B, s, H, D).astype(dtype)
    kp = rng.randn(N, bs, Hkv, D).astype(dtype)
    vp = rng.randn(N, bs, Hkv, D).astype(dtype)
    tables = rng.permutation(N)[:B * M].reshape(B, M).astype(np.int32)
    pos = np.asarray([5, 17, 30 - (s - 1)], np.int32)
    return q, kp, vp, tables, pos


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_plain_paged_attention_matches_pallas_interpret():
    q, kp, vp, tables, pos = _case()
    ref = np.asarray(jax_pa.paged_decode_attention(
        *_jax(q, kp, vp, tables, pos + 1), interpret=True))
    out = tk.paged_attention(*_torch(q, kp, vp, tables, pos)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("lens", [[6, 18, 31], [1, 32, 8], [0, 9, 17]])
def test_kernel_plain_version_matches_pallas_interpret(lens):
    q, kp, vp, tables, _ = _case(seed=1)
    lens = np.asarray(lens, np.int32)
    ref = np.asarray(jax_pa.paged_decode_attention(
        *_jax(q, kp, vp, tables, lens), interpret=True))
    out = pd.paged_decode_attention(*_torch(q, kp, vp, tables, lens)).numpy()
    # a row of length 0 gives 0 in both kernels
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)


def test_prefill_chunk_matches_jax_gather_path():
    q, kp, vp, tables, pos = _case(s=5, seed=2)
    ref = np.asarray(paged_attention_k(*_jax(q, kp, vp, tables, pos)))
    out = tops.paged_attention(*_torch(q, kp, vp, tables, pos)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)


def test_bf16_matches_jax():
    """bfloat16 inputs.  The gather paths both round the probabilities to
    bfloat16 before P.V: 2 bf16 units in the last place (2**-7 relative).
    The Pallas kernel rounds p to bfloat16 too while the port's kernel
    math keeps it in float32, so that pair differs by the rounding of p
    summed over the row: 3e-2 absolute on outputs of magnitude <~ 2."""
    q, kp, vp, tables, pos = _case(seed=3)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp))
    tq, tk_, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp))
    t_tab, t_pos = _torch(tables, pos)
    j_tab, j_pos = _jax(tables, pos)

    gather_ref = np.asarray(paged_attention_k(jq, jk, jv, j_tab, j_pos),
                            np.float32)
    gather = tk.paged_attention(tq, tk_, tv, t_tab, t_pos).float().numpy()
    np.testing.assert_allclose(gather, gather_ref, rtol=1.6e-2, atol=1e-2)

    kern_ref = np.asarray(jax_pa.paged_decode_attention(
        jq, jk, jv, j_tab, j_pos + 1, interpret=True), np.float32)
    kern = pd.paged_decode_attention(tq, tk_, tv, t_tab,
                                     t_pos + 1).float().numpy()
    np.testing.assert_allclose(kern, kern_ref, rtol=0, atol=3e-2)


def _write_case():
    rng = np.random.RandomState(4)
    N, bs, H, D, b, s = 10, 4, 2, 8, 3, 6
    pool = rng.randn(N, bs, H, D).astype(np.float32)
    val = rng.randn(b, s, H, D).astype(np.float32)
    tables = np.asarray([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    pos = np.asarray([1, 3, 0], np.int32)
    return pool, val, tables, pos


@pytest.mark.parametrize("limit", [
    [7, 9, 6],     # every position written
    [4, 5, 6],     # bucket padding: positions past the limit are dropped
    [7, 9, 0],     # a dead slot (limit 0, table of block 0) writes nothing
])
def test_paged_write_matches_jax(limit):
    pool, val, tables, pos = _write_case()
    limit = np.asarray(limit, np.int32)
    ref = np.asarray(paged_write_k(*_jax(pool, val, tables, pos, limit),
                                   block_size=pool.shape[1]))
    t_pool = torch.from_numpy(pool.copy())
    out = tk.paged_write(t_pool, *_torch(val, tables, pos, limit))
    assert out is t_pool                     # written in place
    np.testing.assert_array_equal(t_pool.numpy(), ref)


@pytest.mark.parametrize("limit", [
    [4, 9, 3],     # row 2 keeps nothing; row 1 writes its blocks
    [1, 3, 3],     # no row keeps anything: the pool is unchanged
])
def test_paged_write_drops_whole_rows_over_shared_blocks(limit):
    """A row that keeps no position, its table over the blocks that a
    later-written row of the same call fills, takes nothing from them:
    the dropped entries carry what the slot they are sent to receives."""
    pool, val, _, _ = _write_case()
    tables = np.asarray([[1, 2, 3], [4, 5, 6], [4, 5, 6]], np.int32)
    pos = np.asarray([1, 3, 3], np.int32)
    limit = np.asarray(limit, np.int32)
    ref = np.asarray(paged_write_k(*_jax(pool, val, tables, pos, limit),
                                   block_size=pool.shape[1]))
    t_pool = torch.from_numpy(pool.copy())
    tk.paged_write(t_pool, *_torch(val, tables, pos, limit))
    np.testing.assert_array_equal(t_pool.numpy(), ref)


def test_paged_write_without_limit_writes_every_position():
    pool, val, tables, pos = _write_case()
    full = (pos + val.shape[1]).astype(np.int32)
    ref = np.asarray(paged_write_k(*_jax(pool, val, tables, pos, full),
                                   block_size=pool.shape[1]))
    t_pool = torch.from_numpy(pool.copy())
    tk.paged_write(t_pool, *_torch(val, tables, pos))
    np.testing.assert_array_equal(t_pool.numpy(), ref)


@pytest.mark.parametrize("kind", ["causal", "causal_lq_lt_lk", "bool_mask",
                                  "additive_mask", "gqa"])
def test_sdpa_matches_jax(kind):
    rng = np.random.RandomState(5)
    B, Lq, Lk, H, D = 2, 6, 6, 4, 16
    if kind == "causal_lq_lt_lk":
        Lq = 3
    Hkv = 2 if kind == "gqa" else H
    q = rng.randn(B, Lq, H, D).astype(np.float32)
    k = rng.randn(B, Lk, Hkv, D).astype(np.float32)
    v = rng.randn(B, Lk, Hkv, D).astype(np.float32)
    kw, mask = {}, None
    if kind in ("causal", "causal_lq_lt_lk", "gqa"):
        kw["is_causal"] = True
    elif kind == "bool_mask":
        mask = rng.rand(B, 1, Lq, Lk) > 0.3
        mask[..., 0] = True                 # no fully masked row
    else:
        mask = (rng.randn(B, H, Lq, Lk) * 2).astype(np.float32)
    ref = np.asarray(sdpa_k(*_jax(q, k, v), mask=None if mask is None
                            else jnp.asarray(mask), **kw))
    out = tops.sdpa(*_torch(q, k, v), mask=None if mask is None
                    else torch.from_numpy(mask), **kw).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)


def test_sdpa_on_cuda_raises_and_names_the_flash_slice(monkeypatch):
    """On CUDA, sdpa inside the flash gate goes to the flash kernels, and a
    kernel that fails raises through sdpa (no fallback, no plain call
    counted); outside the gate (here D = 12) it runs the plain version
    and counts the call."""
    def fail(*args, **kw):
        raise RuntimeError("flash_attention_fwd kernel failed")

    monkeypatch.setattr(tops._flash, "flash_attention", fail)
    monkeypatch.setattr(tops.nn_kernels, "sdpa", lambda *a, **kw: "plain")
    cuda = torch.device("cuda")
    q = types.SimpleNamespace(device=cuda, shape=(1, 4, 2, 8),
                              dtype=torch.bfloat16)
    before = tops.sdpa.plain_calls
    with pytest.raises(RuntimeError, match="flash_attention"):
        tops.sdpa(q, q, q, is_causal=True)
    assert tops.sdpa.plain_calls == before
    odd = types.SimpleNamespace(device=cuda, shape=(1, 4, 2, 12),
                                dtype=torch.bfloat16)
    assert tops.sdpa(odd, odd, odd, is_causal=True) == "plain"
    assert tops.sdpa.plain_calls == before + 1


def test_paged_decode_operator_on_cpu_matches_jax():
    """`paddle_tpu_torch::paged_decode` on CPU tensors is the plain
    version, as the JAX kernel computes it."""
    q, kp, vp, tables, pos = _case()
    lens = (pos + 1).astype(np.int32)
    ref = np.asarray(jax_pa.paged_decode_attention(
        *_jax(q, kp, vp, tables, lens), interpret=True))
    out = torch.ops.paddle_tpu_torch.paged_decode(
        *_torch(q, kp, vp, tables, lens), q.shape[-1] ** -0.5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-6)


def test_traced_cuda_decode_step_is_one_operator_node():
    """Traced over fake CUDA tensors (as `torch.export` traces a program
    for the card), a decode step's attention is one call of the operator
    and no call of the ctypes wrapper; this needs no card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    before = pd.paged_decode_attention.launches
    with FakeTensorMode():
        q = torch.empty(2, 1, 4, 64, device="cuda", dtype=torch.bfloat16)
        pool = torch.empty(16, 16, 2, 64, device="cuda",
                           dtype=torch.bfloat16)
        tables = torch.zeros(2, 4, device="cuda", dtype=torch.int32)
        pos = torch.zeros(2, device="cuda", dtype=torch.int32)
        graph = make_fx(lambda q, k, v, t, p: tops.paged_attention(
            q, k, v, t, p))(q, pool, pool, tables, pos)
    calls = [n.target for n in graph.graph.nodes
             if n.op == "call_function"]
    assert calls.count(torch.ops.paddle_tpu_torch.paged_decode.default) == 1
    assert pd.paged_decode_attention.launches == before
