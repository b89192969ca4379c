"""Tensor-parallel layers over the mesh's "mp" axis (Megatron style).

Counterpart: `paddle_tpu/distributed/parallel_layers.py`.  There each
layer holds the whole weight and annotates its split axis, and GSPMD
inserts the collectives.  Here each rank holds its local shard as a
plain tensor, and the collectives are explicit autograd Functions, so the
flash kernels and every other op see ordinary local tensors:

  copy_to_mp        f: forward identity, backward all-reduce
  reduce_from_mp    g: forward all-reduce, backward identity
  gather_last       forward all-gather along the last dim, backward the
                    local slice
  scatter_seq       forward this rank's slice of dim 1, backward
                    all-gather (into sequence parallelism)
  gather_seq        forward all-gather along dim 1, backward
                    reduce-scatter (before a column-parallel layer under
                    sequence parallelism)
  reduce_scatter_seq  forward reduce-scatter along dim 1, backward
                    all-gather (after a row-parallel layer under sequence
                    parallelism)
  gather_seq_full   forward all-gather along dim 1, backward the local
                    slice (out of sequence or context parallelism, before
                    a computation every rank repeats)

The split axes are the JAX package's, in torch's [out, in] Linear layout
(`:20-85`): `ColumnParallelLinear` keeps rows out/mp of [out, in] (the
JAX [in, out] split along out), `RowParallelLinear` columns in/mp, and
`VocabParallelEmbedding` rows vocab/mp.  `interleave=k` on a column layer
splits each of k equal blocks of the output separately, so that rank r
holds its heads of each of GPT's fused q, k and v.

The row layer adds its bias once, after the reduction.  The vocab layer
looks up only the ids in its rows and zeroes the others before the
all-reduce.  `ParallelCrossEntropy` reduces the max, the sum of exps and
the target logit across the mp ranks.

`state_dict()` gathers each shard back to the dense tensor (collective:
every mp rank calls it), and `load_state_dict` takes either the dense
tensor (sliced to the shard) or the shard itself, so a checkpoint crosses
between mp degrees; `state_dict(keep_vars=True)` gives the local
parameters.  With mp 1, or no process group, every collective is the
identity and each layer is its dense counterpart.

Parameters whose gradient is a partial sum over the sequence shards
under sequence parallelism (norm weights and row biases after
`reduce_scatter_seq`) carry `sequence_parallel = True`; the fleet step
all-reduces their gradients over mp (`mark_sequence_parallel`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import mesh as mesh_mod

AXIS = "mp"


def _group():
    return mesh_mod.axis_group(AXIS)


def _n():
    return mesh_mod.degree(AXIS)


def _r():
    return mesh_mod.axis_rank(AXIS)


def _all_reduce(x):
    g = _group()
    if g is not None:
        dist.all_reduce(x, group=g)
    return x


def _gather(x, dim):
    g = _group()
    if g is None:
        return x
    parts = [torch.empty_like(x) for _ in range(_n())]
    dist.all_gather(parts, x.contiguous(), group=g)
    return torch.cat(parts, dim=dim)


def _slice(x, dim):
    n = _n()
    if n == 1:
        return x
    return x.chunk(n, dim=dim)[_r()].contiguous()


def _reduce_scatter(x, dim):
    g = _group()
    if g is None:
        return x
    n = _n()
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xt, group=g)
    return out.movedim(0, dim).contiguous()


class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone())


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _gather(x, -1)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, -1)


class _ScatterLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _slice(x, -1)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, -1)


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _slice(x, 1)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, 1)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _gather(x, 1)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, 1)


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _reduce_scatter(x, 1)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, 1)


class _GatherSeqFull(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _gather(x, 1)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, 1)


def copy_to_mp(x):
    return _CopyToMP.apply(x) if _n() > 1 else x


def reduce_from_mp(x):
    return _ReduceFromMP.apply(x) if _n() > 1 else x


def gather_last(x):
    return _GatherLast.apply(x) if _n() > 1 else x


def scatter_seq(x):
    return _ScatterSeq.apply(x) if _n() > 1 else x


def gather_seq(x):
    return _GatherSeq.apply(x) if _n() > 1 else x


def reduce_scatter_seq(x):
    return _ReduceScatterSeq.apply(x) if _n() > 1 else x


def gather_seq_full(x):
    return _GatherSeqFull.apply(x) if _n() > 1 else x


def mark_sequence_parallel(*params):
    for p in params:
        if p is not None:
            p.sequence_parallel = True


def _check_divisible(size, what):
    n = _n()
    if size % n:
        raise ValueError(f"{what} ({size}) is not divisible by the mp "
                         f"degree ({n})")


class _Sharded:
    """Shard bookkeeping shared by the parallel layers: `_split` maps a
    parameter name to (dim, interleave), and `shard` / `unshard` move a
    tensor between the dense layout and this rank's piece."""

    _split: dict = {}

    def shard(self, name, dense):
        """This rank's piece of the dense tensor `dense` of parameter
        `name` (a tensor not split by this layer is returned as is)."""
        if name not in self._split:
            return dense
        dim, k = self._split[name]
        n = _n()
        if n == 1:
            return dense
        blocks = dense.chunk(k, dim=dim)
        return torch.cat([b.chunk(n, dim=dim)[_r()] for b in blocks],
                         dim=dim).contiguous()

    def unshard(self, name, local):
        """The dense tensor from every rank's `local` piece (collective
        over mp)."""
        if name not in self._split or _n() == 1:
            return local
        dim, k = self._split[name]
        parts = [p.chunk(k, dim=dim)
                 for p in _gather(local.unsqueeze(0), 0).unbind(0)]
        return torch.cat([torch.cat([p[b] for p in parts], dim=dim)
                          for b in range(k)], dim=dim)

    def dense_shape(self, name, local_shape):
        shape = list(local_shape)
        if name in self._split:
            shape[self._split[name][0]] *= _n()
        return tuple(shape)

    @torch.no_grad()
    def normal_(self, std, generator=None):
        """Draw the dense weight from Normal(0, std) with `generator` and
        keep this rank's piece: the same stream as the dense layer's draw,
        so a model built at any mp degree holds the dense model's
        weights."""
        w = self.weight
        dense = torch.empty(self.dense_shape("weight", w.shape),
                            dtype=w.dtype, device=w.device)
        dense.normal_(0.0, std, generator=generator)
        w.copy_(self.shard("weight", dense))
        if getattr(self, "bias", None) is not None:
            self.bias.zero_()

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        if keep_vars:
            return
        for name in self._split:
            key = prefix + name
            if key in destination:
                destination[key] = self.unshard(name, destination[key])

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in self._split:
            key = prefix + name
            t = state_dict.get(key)
            own = getattr(self, name, None)
            if t is not None and own is not None and \
                    tuple(t.shape) != tuple(own.shape):
                state_dict[key] = self.shard(name, t)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class ColumnParallelLinear(_Sharded, nn.Linear):
    """y = x W^T + b with W's output rows split over mp: rank r holds
    out/mp rows (of each of `interleave` blocks).  The output stays split
    along its last dim unless `gather_output`.  With
    `sequence_parallel`, x is this rank's sequence shard [b, s/mp, in]
    and is all-gathered first."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, interleave=1,
                 sequence_parallel=False, device=None, dtype=None):
        _check_divisible(out_features // interleave,
                         "ColumnParallelLinear's out_features per block")
        super().__init__(in_features, out_features // _n(), bias=has_bias,
                         device=device, dtype=dtype)
        self._split = {"weight": (0, interleave), "bias": (0, interleave)}
        self.gather_output = gather_output
        self.sequence_parallel = sequence_parallel

    def forward(self, x):
        x = gather_seq(x) if self.sequence_parallel else copy_to_mp(x)
        out = F.linear(x, self.weight, self.bias)
        return gather_last(out) if self.gather_output else out


class RowParallelLinear(_Sharded, nn.Linear):
    """y = x W^T + b with W's input columns split over mp: rank r holds
    in/mp columns.  x is split along its last dim unless
    `input_is_parallel`; the partial products are all-reduced (reduce-
    scattered along the sequence with `sequence_parallel`), then the bias
    is added once."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 sequence_parallel=False, device=None, dtype=None):
        _check_divisible(in_features, "RowParallelLinear's in_features")
        super().__init__(in_features // _n(), out_features, bias=has_bias,
                         device=device, dtype=dtype)
        self._split = {"weight": (1, 1)}
        self.input_is_parallel = input_is_parallel
        self.sequence_parallel = sequence_parallel
        if sequence_parallel:
            mark_sequence_parallel(self.bias)

    def forward(self, x):
        if not self.input_is_parallel:
            x = _ScatterLast.apply(x) if _n() > 1 else x
        out = F.linear(x, self.weight)
        out = reduce_scatter_seq(out) if self.sequence_parallel else \
            reduce_from_mp(out)
        return out if self.bias is None else out + self.bias


class VocabParallelEmbedding(_Sharded, nn.Embedding):
    """An embedding table whose rows (the vocabulary) are split over mp:
    rank r looks up the ids in its rows, zeroes the rest, and the pieces
    are all-reduced."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        _check_divisible(num_embeddings, "VocabParallelEmbedding's vocab")
        super().__init__(num_embeddings // _n(), embedding_dim,
                         device=device, dtype=dtype)
        self._split = {"weight": (0, 1)}

    def forward(self, ids):
        if _n() == 1:
            return F.embedding(ids, self.weight)
        lo = _r() * self.num_embeddings
        local = ids - lo
        out_of_shard = (local < 0) | (local >= self.num_embeddings)
        out = F.embedding(local.masked_fill(out_of_shard, 0), self.weight)
        out = out.masked_fill(out_of_shard[..., None], 0.0)
        return reduce_from_mp(out)


class ParallelCrossEntropy(nn.Module):
    """Per-token cross entropy of vocab-split logits [..., V/mp] against
    global labels (reduction "none", as the JAX layer): the max, the sum
    of exps and the target logit are reduced across the mp ranks, in
    float32.  Labels equal to `ignore_index` give 0."""

    def __init__(self, mp_group=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, label):
        x = logits.float()
        vl = x.shape[-1]
        m = x.detach().amax(dim=-1)
        g = _group()
        if g is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        shifted = x - m[..., None]
        sumexp = reduce_from_mp(shifted.exp().sum(dim=-1))
        local = label.long() - _r() * vl
        inside = (local >= 0) & (local < vl)
        tgt = shifted.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
        tgt = reduce_from_mp(tgt * inside)
        loss = sumexp.log() - tgt
        return loss.masked_fill(label == self.ignore_index, 0.0)


def shard_activation(x, spec):
    """The JAX package's sharding constraint (`:109-126`).  The port's
    activations are already the local pieces the layers made, so this is
    the identity; it is kept for the reference's call sites."""
    return x


def seq_shard(x, enabled, cache=None):
    """The JAX package's Megatron-SP hook (`:88-106`), a sharding
    constraint that changes no number.  In the port the blocks are built
    with `sequence_parallel=True` layers, which move between the sequence
    shards and the full sequence themselves (`gather_seq`,
    `reduce_scatter_seq`), so this too is the identity."""
    return x


@torch.no_grad()
def init_normal_(mod, std, generator):
    """A Linear or Embedding's draw, Normal(0, std) weight and zero bias,
    for a dense layer and a parallel one alike (the parallel one draws
    the dense weight and keeps its piece)."""
    if isinstance(mod, _Sharded):
        mod.normal_(std, generator)
        return
    mod.weight.normal_(0.0, std, generator=generator)
    if getattr(mod, "bias", None) is not None:
        mod.bias.zero_()


def parallel_parameters(model):
    """{parameter name: (layer, attribute)} for every split parameter of
    `model`'s parallel layers."""
    out = {}
    for mname, mod in model.named_modules():
        if isinstance(mod, _Sharded):
            for attr in mod._split:
                if getattr(mod, attr, None) is not None:
                    out[f"{mname}.{attr}" if mname else attr] = (mod, attr)
    return out
