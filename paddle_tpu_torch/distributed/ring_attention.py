"""Ring attention: context parallelism over a mesh axis (default "mp").

Counterpart: `paddle_tpu/distributed/ring_attention.py`, the flash ring
`make_ring_flash_local` (`:130-210`).  Each rank holds one contiguous
sequence shard of q, k and v ([B, L/n, H, D], k and v with their own kv
heads: the unrepeated GQA shards ride the ring).  The forward walks n
steps: at step s the rank holds the K/V shard of rank (idx - s) mod n,
runs one flash block on it (`ops.flash_attention.flash_block_fwd`, o and
the float32 lse), merges it into the running (o, lse) by log-sum-exp in
float32, and passes K/V on to rank idx + 1 (`batch_isend_irecv`).  Under
causal masking the diagonal block is causal, an earlier shard is
attended in full and a later one is skipped.

The backward is the ring-flash decomposition: with the global lse, each
step's `flash_block_bwd` gives the exact partial (dq, dk, dv) of that
K/V shard; dq sums in place while dK / dV travel with their shard and
arrive home after n hops.  The whole ring is one autograd Function.  On
CUDA tensors every block runs the flash kernels (the sm90 family for
bf16 / fp16 at D 64 / 128, fp32 for float32, sm80 otherwise); on the CPU
their plain versions.  With one rank the ring is one diagonal block:
`flash_attention`'s forward and backward, bit for bit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.flash_attention import flash_block_bwd, flash_block_fwd
from . import mesh as mesh_mod
from .parallel_layers import gather_seq_full, scatter_seq


def _rotate(x, pg, idx, n):
    """x from this rank to rank idx + 1 of the axis; returns what rank
    idx - 1 sent."""
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(pg, (idx + 1) % n), group=pg),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(pg, (idx - 1) % n), group=pg)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


def _branch(src, idx, causal):
    """"diag" (own shard, causal), "full" (attend all) or "skip"."""
    if not causal:
        return "full"
    return "diag" if src == idx else "full" if src < idx else "skip"


def _bt(w):
    return w.transpose(1, 2)[..., None]     # [B, H, L] -> [B, L, H, 1]


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale):
        pg = mesh_mod.axis_group(axis)
        n = mesh_mod.degree(axis)
        idx = mesh_mod.axis_rank(axis)
        o = lse = None
        kc, vc = k, v
        for s in range(n):
            br = _branch((idx - s) % n, idx, causal)
            if br != "skip":
                ob, lseb = flash_block_fwd(q, kc, vc, br == "diag", scale)
                if o is None:
                    o, lse = ob.float(), lseb
                else:
                    new = torch.logaddexp(lse, lseb)
                    o = o * _bt(torch.exp(lse - new)) + \
                        ob.float() * _bt(torch.exp(lseb - new))
                    lse = new
            if s < n - 1:
                kc, vc = _rotate(kc, pg, idx, n), _rotate(vc, pg, idx, n)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (axis, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        axis, causal, scale = ctx.args
        pg = mesh_mod.axis_group(axis)
        n = mesh_mod.degree(axis)
        idx = mesh_mod.axis_rank(axis)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kc, vc = k, v
        for s in range(n):
            br = _branch((idx - s) % n, idx, causal)
            if br != "skip":
                dqb, dkb, dvb = flash_block_bwd(q, kc, vc, o, lse, do,
                                                br == "diag", scale)
                dq += dqb.float()
                dk += dkb.float()
                dv += dvb.float()
            if n > 1:
                # dK / dV travel with their shard: home after n hops
                dk, dv = _rotate(dk, pg, idx, n), _rotate(dv, pg, idx, n)
            if s < n - 1:
                kc, vc = _rotate(kc, pg, idx, n), _rotate(vc, pg, idx, n)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention_local(q, k, v, axis_name="mp", scale=None, causal=True):
    """The ring on this rank's sequence shards q [B, L/n, H, D], k and v
    [B, L/n, Hkv, D] -> o [B, L/n, H, D] in q's dtype, differentiable in
    q, k and v.  Rank i of the axis holds positions i*L/n .. (i+1)*L/n-1."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"ring attention GQA needs q heads ({q.shape[2]}) divisible by "
            f"kv heads ({k.shape[2]})")
    return _RingFlash.apply(q, k, v, axis_name, bool(causal), scale)


def ring_attention(q, k, v, mesh=None, axis_name="mp", causal=True,
                   scale=None, impl="auto"):
    """The full-array entry: every rank passes the whole q [B, L, H, D],
    k and v; each keeps its sequence shard of `axis_name` (L divisible
    by the axis' degree), runs the ring and all-gathers the output, so
    every rank returns the whole o.  Gradients reach the whole inputs.
    `mesh` is the installed one (the argument is the JAX package's);
    `impl` "auto" and "flash" are both the flash blocks (the JAX package's
    "einsum" and "interpret" paths have no counterpart)."""
    if impl not in ("auto", "flash"):
        raise ValueError(f"impl {impl!r}: the port's ring runs the flash "
                         f"blocks ('auto' or 'flash')")
    if axis_name != "mp":
        raise NotImplementedError(
            f"ring attention over {axis_name!r}: the port rings over 'mp' "
            f"(ROADMAP.md A11)")
    n = mesh_mod.degree(axis_name)
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} is not divisible "
                         f"by the {axis_name} degree {n}")
    qs, ks, vs = (scatter_seq(t) for t in (q, k, v))
    return gather_seq_full(
        ring_attention_local(qs, ks, vs, axis_name, scale, causal))

