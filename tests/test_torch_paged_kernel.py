"""The port's paged decode attention: plain version, wrapper and CUDA kernel.

This file imports torch and numpy only, so it also runs on the machine
with the card, which has no JAX.  There, run it without the JAX test
setup of tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_paged_kernel.py

On the CPU the `cuda` tests skip; the rest hold the plain version (what
the wrapper runs for CPU tensors) against a float64 numpy walk over the
block table that mirrors the Pallas TPU kernel step by step.  The parity
of this op with the JAX package is in tests/test_torch_paged_attention.py.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_decode as pa


def _inputs(B, H, Hkv, D, bs, M, lens, dtype=torch.float32, device="cpu",
            seed=0):
    """Pool of B*M + 1 blocks; each row's used blocks are distinct random
    ids, and table columns past a row's length are padded with block 0
    (as the engine pads them)."""
    rng = np.random.default_rng(seed)
    N = B * M + 1
    q = rng.standard_normal((B, 1, H, D), dtype=np.float32)
    kp = rng.standard_normal((N, bs, Hkv, D), dtype=np.float32)
    vp = rng.standard_normal((N, bs, Hkv, D), dtype=np.float32)
    ids = rng.permutation(np.arange(1, N))
    tables = np.zeros((B, M), np.int32)
    for b, n in enumerate(lens):
        used = -(-n // bs)
        tables[b, :used] = ids[b * M:b * M + used]
    lens = np.asarray(lens, np.int32)

    def t(a):
        return torch.from_numpy(a).to(device)

    return (t(q).to(dtype), t(kp).to(dtype), t(vp).to(dtype), t(tables),
            t(lens))


def _walk_reference(q, kp, vp, tables, lens):
    """float64 replay of `_decode_kernel`: per (row, head), walk the table
    one block at a time with online softmax; blocks at or past the length
    are skipped; a row of length 0 gives 0."""
    q, kp, vp = (np.asarray(x, np.float64) for x in (q, kp, vp))
    B, _, H, D = q.shape
    bs, Hkv = kp.shape[1], kp.shape[2]
    g = H // Hkv
    out = np.zeros((B, 1, H, D))
    for b in range(B):
        n = int(lens[b])
        for h in range(H):
            m, l, acc = -np.inf, 0.0, np.zeros(D)
            for j in range(tables.shape[1]):
                if j * bs >= n:
                    continue
                blk = int(tables[b, j])
                k = kp[blk, :, h // g]
                v = vp[blk, :, h // g]
                s = k @ q[b, 0, h] / np.sqrt(D)
                s[j * bs + np.arange(bs) >= n] = -np.inf
                m_new = max(m, s.max())
                p = np.exp(s - m_new)
                corr = np.exp(m - m_new)
                l = l * corr + p.sum()
                acc = acc * corr + p @ v
                m = m_new
            out[b, 0, h] = acc / (l if l else 1.0)
    return out


CASES = {
    # name: (B, H, Hkv, D, bs, M, lens)
    "mha_d128_bs16": (4, 4, 4, 128, 16, 5, [1, 16, 17, 80]),
    "gqa_d128": (3, 8, 2, 128, 16, 4, [33, 64, 5]),
    "d64_bs8": (3, 4, 4, 64, 8, 6, [48, 9, 1]),
    "odd_bs_d72_g3": (2, 6, 2, 72, 5, 7, [35, 12]),
    "zero_length_row": (3, 4, 2, 128, 16, 3, [0, 20, 48]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_block_walk(name):
    B, H, Hkv, D, bs, M, lens = CASES[name]
    q, kp, vp, tables, lens_t = _inputs(B, H, Hkv, D, bs, M, lens)
    out = pa.paged_decode_attention_plain(q, kp, vp, tables, lens_t)
    ref = _walk_reference(q.numpy(), kp.numpy(), vp.numpy(),
                          tables.numpy(), lens_t.numpy())
    # float32 math against a float64 replay: a few float32 roundings
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_runs_the_plain_version():
    q, kp, vp, tables, lens = _inputs(2, 4, 2, 64, 8, 3, [7, 20])
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(q, kp, vp, tables, lens)
    plain = pa.paged_decode_attention_plain(q, kp, vp, tables, lens)
    assert torch.equal(out, plain)
    assert pa.paged_decode_attention.launches == before   # no kernel ran


@pytest.mark.parametrize("bad", ["prefill", "head_dim", "gqa", "dtype",
                                 "table_dtype", "strided"])
def test_check_rejects_what_the_kernel_does_not_take(bad):
    q, kp, vp, tables, lens = _inputs(2, 4, 2, 64, 8, 3, [7, 20])
    if bad == "prefill":
        q = torch.cat([q, q], dim=1)
    elif bad == "head_dim":
        q, kp, vp = q[..., :12].contiguous(), kp[..., :12].contiguous(), \
            vp[..., :12].contiguous()
    elif bad == "gqa":
        kp, vp = kp[:, :, :1].expand(-1, -1, 3, -1).contiguous(), \
            vp[:, :, :1].expand(-1, -1, 3, -1).contiguous()
    elif bad == "dtype":
        q = q.double()
    elif bad == "table_dtype":
        tables = tables.long()
    elif bad == "strided":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        pa._check(q, kp, vp, tables, lens)


# M, bs, _splits -> (splits, tokens per split), with partitions of 512
@pytest.mark.parametrize("M, bs, splits, want", [
    (66, 16, None, (3, 512)),     # the serving shape: 1,056 columns' tokens
    (32, 16, None, (1, 512)),     # one whole partition
    (4, 16, None, (1, 64)),       # one short partition: the whole table
    (33, 16, None, (2, 512)),     # one block past a partition
    (1300, 1, None, (3, 512)),    # bs 1
    (12, 100, None, (3, 500)),    # bs not a divisor of the partition
    (500, 600, None, (500, 600)),  # bs above the partition: one block each
    (66, 16, 1, (1, 1056)),       # _splits=1: the one-pass layout
    (66, 16, 3, (3, 352)),
    (5, 16, 99, (5, 16)),         # at most one split per column
])
def test_split_plan_from_the_table_width(M, bs, splits, want):
    """The split count and partition come from the table's shape (M
    columns of bs tokens) and the partition size, not from the lengths,
    which live on the card; partitions are whole blocks and cover the
    table."""
    got = pa.split_plan(M, bs, splits)
    assert got == want
    n, part = got
    assert part % bs == 0 and n * part >= M * bs > (n - 1) * part


def test_split_plan_rejects_zero_splits():
    with pytest.raises(ValueError):
        pa.split_plan(4, 16, 0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# tolerance of kernel vs plain on the card: both accumulate in float32 in
# another order, then round once to the working type (2 units in the last
# place of bfloat16 / float16 output, a few float32 roundings otherwise)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-3),
       torch.float16: dict(rtol=2e-3, atol=1e-4)}

CUDA_CASES = dict(CASES, **{
    "fp32_d256_vpl2": (2, 4, 4, 256, 16, 3, [40, 3]),
    "group12_chunks": (2, 12, 1, 64, 16, 3, [30, 48]),
    "d8": (2, 2, 2, 8, 4, 4, [13, 16]),
})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_kernel_matches_plain_on_card(card, name, dtype):
    B, H, Hkv, D, bs, M, lens = CUDA_CASES[name]
    q, kp, vp, tables, lens_t = _inputs(B, H, Hkv, D, bs, M, lens,
                                        dtype=dtype, device=card)
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(q, kp, vp, tables, lens_t)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    ref = pa.paged_decode_attention_plain(q, kp, vp, tables, lens_t)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


# split edges, each row's context cut into partitions of P tokens:
# name: (B, H, Hkv, D, bs, M, lens)
P = pa.PARTITION_TOKENS
SPLIT_CASES = {
    # a row inside one partition, an empty row, a last partition of one
    # token, a row over six partitions
    "g1_bs16_edges": (4, 4, 4, 128, 16, -(-(5 * P + 40) // 16),
                      [10, 0, P + 1, 5 * P + 40]),
    # bs 1: partitions of P blocks; 2 P + 1 = two partitions and one token
    "g2_bs1": (3, 4, 2, 64, 1, 2 * P + 60, [1, 2 * P + 1, 2 * P + 60]),
    "g8_bs16": (2, 16, 2, 128, 16, -(-(P + 100) // 16), [P + 100, 33]),
    "g16_bs16_chunks": (2, 16, 1, 128, 16, -(-(P + 100) // 16),
                        [P + 100, P + 1]),
    "d256_bs16": (2, 4, 4, 256, 16, -(-(P + 60) // 16), [P + 60, 0]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_kernel_matches_plain_and_one_pass_on_card(card, name, dtype):
    """The split kernel against the plain version and against the
    one-pass layout (`_splits=1`), both within TOL; a second call gives
    the same bits, so the first left its arrival counters at 0."""
    B, H, Hkv, D, bs, M, lens = SPLIT_CASES[name]
    assert pa.split_plan(M, bs)[0] > 1
    q, kp, vp, tables, lens_t = _inputs(B, H, Hkv, D, bs, M, lens,
                                        dtype=dtype, device=card, seed=3)
    before = pa.paged_decode_attention.launches
    out = pa.paged_decode_attention(q, kp, vp, tables, lens_t)
    again = pa.paged_decode_attention(q, kp, vp, tables, lens_t)
    one = pa.paged_decode_attention(q, kp, vp, tables, lens_t, _splits=1)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 3
    ref = pa.paged_decode_attention_plain(q, kp, vp, tables, lens_t)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(out.float(), one.float(), **TOL[dtype])
    assert torch.equal(out, again)
    empty = [b for b, n in enumerate(lens) if n == 0]
    assert not out[empty].any()


@pytest.mark.cuda
def test_kernel_raises_on_unsupported_shape(card):
    q, kp, vp, tables, lens = _inputs(2, 4, 2, 12, 8, 3, [7, 20],
                                      device=card)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, kp, vp, tables, lens)
