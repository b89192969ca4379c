"""Plain PyTorch versions of the ops the serving, generation and vision
paths use.

Counterpart: `paddle_tpu/ops/nn_kernels.py` — `sdpa_k`, `paged_write_k`,
`paged_attention_k`, `rms_norm_k` and the space-to-depth ResNet stem
(`s2d_stem_conv_k` `:51`, `s2d_stem_conv_nhwc_k` `:707`, XLA ops there,
not Pallas kernels) — and `dyn_update_seq_k`
(`paddle_tpu/ops/kernels.py:459-474`).  Layouts follow the JAX package:
activations are (B, L, H, D), the paged KV pool is [N, bs, Hkv, D], and
conv weights are OIHW in either data format.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sdpa(q, k, v, mask=None, is_causal=False, scale=None,
         sliding_window=None):
    """Scaled dot-product attention on (B, L, H, D), as `sdpa_k`: scores
    and softmax in float32, probabilities cast back to q's dtype before
    P.V; causal masking is bottom-right aligned (`tril(ones, lk - lq)`),
    and with `sliding_window` banded to cols in (r + off - W, r + off]
    (`triu(ones, lk - lq - W + 1)`; the band applies with causal only);
    `mask` is bool (True = keep) or additive; fewer kv heads are repeated
    up to the q heads (GQA)."""
    d = q.shape[-1]
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = torch.einsum("blhd,bmhd->bhlm", q, k) * scale
    scores = scores.float()
    if is_causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        ones = torch.ones(lq, lk, dtype=torch.bool, device=q.device)
        keep = ones.tril(lk - lq)
        if sliding_window:
            keep &= ones.triu(lk - lq - int(sliding_window) + 1)
        scores = scores.masked_fill(~keep, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, float("-inf"))
        else:
            scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhlm,bmhd->blhd", probs, v)


def paged_write(pool, val, tables, pos, limit=None):
    """Scatter `val` [b, s, H, D] into the pool [N, bs, H, D] IN PLACE at
    row positions pos[b] .. pos[b] + s - 1, through each row's block table
    (position p lands in block tables[b, p // bs], slot p % bs); returns
    `pool`.  The JAX version returns a new array instead.

    Positions at or past limit[b] are dropped, as `paged_write_k` drops
    them with `mode="drop"`.  PyTorch has no dropping scatter, and
    selecting the kept entries would give a shape that only the card
    knows, so every dropped entry is sent to one slot instead, the
    target of the call's first kept entry, and carries what that entry
    writes (when no entry is kept: the first entry's target and what
    the pool holds there).  Writes to one slot then agree, whichever
    lands last, and nothing waits for the card (an exported program
    traces it with static shapes).  The eager engine feeds exact chunks
    and live rows, so it passes no limit; its programs compiled ahead of
    time pad a prefill chunk to its bucket and drop the pad through
    `limit`."""
    bs = pool.shape[1]
    s = val.shape[1]
    positions = (pos.long()[:, None]
                 + torch.arange(s, device=pos.device)[None, :])    # [b, s]
    col = (positions // bs).clamp(0, tables.shape[1] - 1)
    blk = tables.long().gather(1, col)
    off = positions % bs
    val = val.to(pool.dtype)
    if limit is not None:
        keep = positions < limit.long()[:, None]
        i = keep.flatten().int().argmax().reshape(1)
        tb = blk.flatten().index_select(0, i)
        to = off.flatten().index_select(0, i)
        tv = torch.where(keep.flatten().index_select(0, i)[:, None, None],
                         val.flatten(0, 1).index_select(0, i), pool[tb, to])
        blk = torch.where(keep, blk, tb)
        off = torch.where(keep, off, to)
        val = torch.where(keep[:, :, None, None], val, tv)
    pool.index_put_((blk, off), val)
    return pool


def paged_attention(q, k_pool, v_pool, tables, pos, scale=None):
    """Attention over the paged pool for any chunk length s, as
    `paged_attention_k`: gather each row's blocks into a contiguous
    [b, M * bs, Hkv, D] window and run the `sdpa` math under the mask
    `cols <= pos + row` (query row i of a request at offset pos sees
    absolute positions <= pos + i)."""
    b, s = q.shape[0], q.shape[1]
    bs = k_pool.shape[1]
    m = tables.shape[1]
    flat = tables.long().reshape(-1)
    K = k_pool[flat].reshape((b, m * bs) + tuple(k_pool.shape[2:]))
    V = v_pool[flat].reshape((b, m * bs) + tuple(v_pool.shape[2:]))
    cols = torch.arange(m * bs, device=q.device)[None, None, :]
    rows = (pos.long()[:, None, None]
            + torch.arange(s, device=q.device)[None, :, None])
    mask = (cols <= rows)[:, None, :, :]                 # [b, 1, s, M*bs]
    return sdpa(q, K, V, mask=mask, scale=scale)


def dyn_update_seq(buf, val, pos):
    """Write `val` [b, s, ...] into `buf` [b, L, ...] IN PLACE at sequence
    offset `pos` (axis 1) and return `buf`: `pos` is a 0-d tensor (every
    row at one offset) or a [b] tensor (per-row offsets).  As
    `lax.dynamic_update_slice` does, a negative start counts from the end
    (start + L) and every start is then clamped to [0, L - s], so the
    write always fits; nothing raises and nothing is read back to the
    host, so the write can be captured in a CUDA graph."""
    b, s = val.shape[0], val.shape[1]
    L = buf.shape[1]
    start = pos.reshape(-1).long()
    start = torch.where(start < 0, start + L, start).clamp(0, L - s)
    start = start.expand(b)
    idx = start[:, None] + torch.arange(s, device=buf.device)[None, :]
    idx = idx.reshape((b, s) + (1,) * (val.dim() - 2)).expand(val.shape)
    return buf.scatter_(1, idx, val.to(buf.dtype))


def rms_norm(x, weight=None, eps=1e-6):
    """RMSNorm in `rms_norm_k`'s rounding order: the mean of squares in
    float32, rsqrt, a cast back to x's dtype, then the product with the
    weight in that dtype.  (`torch.nn.functional.rms_norm` multiplies by
    the weight before it rounds, which differs in bfloat16.)"""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + eps)).to(x.dtype)
    return out * weight if weight is not None else out


def _s2d_stem_weight(w, channels_last):
    """The 7x7 stem weight [o, c, 7, 7] as the 4x4 kernel over the
    space-to-depth input: padded top-left to 8x8, each spatial axis split
    into (tap, parity), the parities packed into the input channels in
    the order the input packs them ((c, hp, wp) for NCHW, (hp, wp, c) for
    NHWC)."""
    o, c = w.shape[:2]
    w4 = F.pad(w, (1, 0, 1, 0)).reshape(o, c, 4, 2, 4, 2)
    order = (0, 3, 5, 1, 2, 4) if channels_last else (0, 1, 3, 5, 2, 4)
    return w4.permute(*order).reshape(o, 4 * c, 4, 4)


def s2d_stem_conv(x, w):
    """The 7x7 / stride-2 / pad-3 stem conv computed as space-to-depth(2)
    followed by a 4x4 stride-1 conv (pad 2 before, 1 after): the same sum
    of products, over 12 input channels at half the resolution.
    x [b, c, H, W] with H and W even; w [o, c, 7, 7]."""
    b, c, H, W = x.shape
    z = x.reshape(b, c, H // 2, 2, W // 2, 2).permute(0, 1, 3, 5, 2, 4)
    z = F.pad(z.reshape(b, 4 * c, H // 2, W // 2), (2, 1, 2, 1))
    return F.conv2d(z, _s2d_stem_weight(w, False))


def s2d_stem_conv_nhwc(x, w):
    """`s2d_stem_conv` on channels-last input: x [b, H, W, c] (H, W
    even), w [o, c, 7, 7] (the same OIHW weight); returns [b, H/2, W/2,
    o].  The conv runs on an NCHW-shaped view with channels-last
    strides, which is what `torch.channels_last` is."""
    b, H, W, c = x.shape
    z = x.reshape(b, H // 2, 2, W // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    z = F.pad(z.reshape(b, H // 2, W // 2, 4 * c), (0, 0, 2, 1, 2, 1))
    out = F.conv2d(z.permute(0, 3, 1, 2), _s2d_stem_weight(w, True))
    return out.permute(0, 2, 3, 1)
