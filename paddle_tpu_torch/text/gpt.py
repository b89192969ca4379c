"""GPT model family, for serving and training.

Counterpart: `paddle_tpu/text/gpt.py`.  Same presets, same module tree and
parameter names (`gpt.wte.weight`, `gpt.h.0.attn.qkv_proj.weight`, ...),
so `weights.load_paddle_tpu_state` carries a JAX model's weights across
name for name.  One layout differs: the port uses `torch.nn.Linear`,
whose weight is [out, in] where the JAX package keeps [in, out].

Ported here: the no-cache branch of `GPTAttention` (training and dense
inference, through the flash kernels on the card), the block-paged branch
the serving engine drives, the preallocated branch (`:129-135`, the
jitted decode loops) and the concat branch (`:136-143`, the eager
`generate`), `GPTModel`'s positions for each (`:222-241`), `new_caches`
(`:301-316`) and `generate` (`:318-325`), recompute of the blocks in
training (`use_recompute`, `:248-258`), train-mode dropout, the
pretraining criterion (`:327-333`), `gpt_loss_fn` (`:336-347`) and the
MoE configuration: `num_experts` > 0 puts an `incubate.nn.MoELayer` in
place of the MLP of every `moe_every`-th block (`:171-188`), its aux
loss crosses `recompute` as an explicit output (`:244-258`) and
`gpt_loss_fn` adds `moe_aux_weight` times their sum.

Parallelism over the mesh's "mp" axis (`:80-90`, `:103-109`, `:144-150`,
`:188-194`, `:210-211`), one process a rank:
- `tensor_parallel` (default: mp degree > 1 and not `context_parallel`):
  `qkv_proj` and `fc_in` are column-parallel, `out_proj` and `fc_out`
  row-parallel, `wte` vocab-parallel.  The fused `qkv_proj` [3h, h] is
  split per block (`interleave=3`): rank r holds the rows of its H/mp
  heads in each of q, k and v, so its [b, s, 3, H/mp, D] view is its own
  heads.  The tied head `x @ wte.T` gives vocab-split logits, which are
  gathered: the model returns the full logits, as the JAX model's global
  array is, so any loss works.
- `sequence_parallel` (needs tensor parallelism at mp > 1): Megatron-SP.
  The residual stream between the parallel layers is this rank's
  sequence shard [b, s/mp, h]; the column layers all-gather it, the row
  layers reduce-scatter into it, and the norms run on the shard (their
  gradients are summed over mp by the fleet step).
- `context_parallel`: the sequence is split over mp for the whole model,
  with replicated weights; attention is `ring_attention_local` over the
  shards and the logits are gathered back.  It raises with
  `attention_dropout > 0` (`:103-109`) and, at mp > 1, beside tensor
  parallelism (both ride the mp axis).
Decode caches and MoE blocks under mp > 1 raise NotImplementedError
(tensor-parallel serving and expert parallelism, ROADMAP.md A11).

Dropout draws from explicit generators: `set_dropout_generator` gives
one `torch.Generator` to every dropout of the model (None: the device's
default generator).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..device import generator as make_generator
from ..device import resolve_device
from ..distributed import mesh as mesh_mod
from ..distributed.parallel_layers import (ColumnParallelLinear,
                                           RowParallelLinear,
                                           VocabParallelEmbedding,
                                           copy_to_mp, gather_last,
                                           gather_seq, gather_seq_full,
                                           init_normal_,
                                           mark_sequence_parallel,
                                           scatter_seq)
from ..distributed.recompute import recompute
from ..distributed.ring_attention import ring_attention_local
from ..incubate.nn.moe import MoELayer, moe_aux_loss
from ..nn import Dropout
from ..nn import functional as PF
from .decode import (_update_paged_cache, _update_prealloc_cache,
                     jit_generate)
from .generation import generate as _eager_generate


class GPTConfig:
    PRESETS = {
        "gpt3-125M": dict(hidden_size=768, num_layers=12, num_heads=12),
        "gpt3-350M": dict(hidden_size=1024, num_layers=24, num_heads=16),
        "gpt3-760M": dict(hidden_size=1536, num_layers=24, num_heads=16),
        "gpt3-1.3B": dict(hidden_size=2048, num_layers=24, num_heads=16),
        "gpt3-2.7B": dict(hidden_size=2560, num_layers=32, num_heads=32),
        "gpt3-6.7B": dict(hidden_size=4096, num_layers=32, num_heads=32),
        "gpt3-13B": dict(hidden_size=5120, num_layers=40, num_heads=40),
    }

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None,
                 max_position_embeddings=2048, hidden_dropout=0.1,
                 attention_dropout=0.1, initializer_range=0.02,
                 use_recompute=False, sequence_parallel=False,
                 context_parallel=False, tensor_parallel=None,
                 num_experts=0, moe_top_k=2, moe_capacity_factor=1.25,
                 moe_every=1, moe_aux_weight=0.01):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout = hidden_dropout
        self.attention_dropout = attention_dropout
        self.initializer_range = initializer_range
        self.use_recompute = use_recompute
        self.sequence_parallel = sequence_parallel
        self.context_parallel = context_parallel
        self.tensor_parallel = bool(tensor_parallel) \
            if tensor_parallel is not None \
            else mesh_mod.degree("mp") > 1 and not context_parallel
        # MoE (GShard / Switch): num_experts > 0 routes the FFN of every
        # `moe_every`-th block
        self.num_experts = num_experts
        self.moe_top_k = moe_top_k
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_every = moe_every
        self.moe_aux_weight = moe_aux_weight
        _check_parallel(self)

    @classmethod
    def from_preset(cls, name, **kw):
        return cls(**{**cls.PRESETS[name], **kw})


def _check_parallel(cfg):
    """The flag combinations the port refuses (GPT and LLaMA configs)."""
    mp = mesh_mod.degree("mp")
    if mp > 1 and cfg.context_parallel and cfg.tensor_parallel:
        raise NotImplementedError(
            "context_parallel beside tensor_parallel: both ride the mp "
            "axis in the port; set tensor_parallel=False (ROADMAP.md A11)")
    if mp > 1 and cfg.sequence_parallel and not cfg.tensor_parallel:
        raise ValueError("sequence_parallel at mp > 1 needs "
                         "tensor_parallel (Megatron-SP)")
    if mp > 1 and getattr(cfg, "num_experts", 0) and \
            (cfg.tensor_parallel or cfg.context_parallel):
        raise NotImplementedError(
            "MoE blocks under mp > 1: expert parallelism is not ported yet "
            "(ROADMAP.md A11)")


def _tp_degree(cfg):
    return mesh_mod.degree("mp") if cfg.tensor_parallel else 1


def _sp(cfg):
    return bool(cfg.sequence_parallel) and _tp_degree(cfg) > 1


def _cp(cfg):
    return bool(cfg.context_parallel) and mesh_mod.degree("mp") > 1


def _linear(cfg, in_f, out_f, column=True, interleave=1, bias=True, **kw):
    """nn.Linear, or its column- / row-parallel counterpart under tensor
    parallelism (the output of a column layer stays split; a row layer
    takes split input)."""
    if not cfg.tensor_parallel:
        return nn.Linear(in_f, out_f, bias=bias, **kw)
    if column:
        return ColumnParallelLinear(in_f, out_f, has_bias=bias,
                                    gather_output=False,
                                    interleave=interleave,
                                    sequence_parallel=_sp(cfg), **kw)
    return RowParallelLinear(in_f, out_f, has_bias=bias,
                             input_is_parallel=True,
                             sequence_parallel=_sp(cfg), **kw)


def _no_parallel_cache(module, cache):
    if cache is not None and (_tp_degree(module.cfg) > 1
                              or _cp(module.cfg)):
        raise NotImplementedError(
            "decode caches under mp > 1: tensor-parallel serving is not "
            "ported yet (ROADMAP.md A11)")


class GPTAttention(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        n = _tp_degree(cfg)
        if cfg.num_heads % n:
            raise ValueError(f"num_heads ({cfg.num_heads}) is not divisible "
                             f"by the mp degree ({n})")
        self.local_heads = cfg.num_heads // n
        if cfg.context_parallel and cfg.attention_dropout > 0:
            # the ring's flash blocks have no dropout (`gpt.py:103-109`)
            raise ValueError(
                "context_parallel ring attention does not support "
                "attention_dropout > 0; set attention_dropout=0.0 "
                "(hidden_dropout is unaffected)")
        kw = dict(device=device, dtype=dtype)
        self.qkv_proj = _linear(cfg, cfg.hidden_size, 3 * cfg.hidden_size,
                                interleave=3, **kw)
        self.out_proj = _linear(cfg, cfg.hidden_size, cfg.hidden_size,
                                column=False, **kw)
        self.dropout_p = cfg.attention_dropout
        self.generator = None       # attention dropout's generator

    def forward(self, x, cache=None):
        _no_parallel_cache(self, cache)
        qkv = self.qkv_proj(x)
        b, s = qkv.shape[:2]        # the whole sequence under Megatron-SP
        # [b, s, 3, H, D] then unbind the 3: the JAX package's qkv layout
        # (this rank's H/mp heads under tensor parallelism)
        q, k, v = qkv.view(b, s, 3, self.local_heads,
                           self.head_dim).unbind(2)
        if cache is not None and "table" in cache:
            # block-paged pool (serving engine): write this chunk's k/v
            # through the block table, then attend the whole context
            kp, vp = _update_paged_cache(cache, k, v)
            out = ops.paged_attention(q, kp, vp, cache["table"],
                                      cache["pos"])
        elif cache is not None and "pos" in cache:
            # preallocated cache (jitted decode): static shapes, write at
            # the offset, attend under the length mask
            k, v, mask = _update_prealloc_cache(cache, k, v, s)
            out = PF.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=0.0,
                training=self.training)
        elif cache is not None:
            # concat cache (eager decode): causal only within the chunk
            k = torch.cat([cache["k"], k], dim=1)
            v = torch.cat([cache["v"], v], dim=1)
            cache["k"], cache["v"] = k, v
            out = PF.scaled_dot_product_attention(
                q, k, v, is_causal=s > 1, dropout_p=0.0,
                training=self.training)
        elif _cp(self.cfg):
            out = ring_attention_local(q, k, v, "mp", causal=True)
        else:
            # dropout on the attention output in training, as the JAX
            # package applies it
            out = PF.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.dropout_p,
                training=self.training, generator=self.generator)
        return self.out_proj(out.reshape(b, s, -1))


class GPTMLP(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc_in = _linear(cfg, cfg.hidden_size, cfg.intermediate_size,
                             **kw)
        self.fc_out = _linear(cfg, cfg.intermediate_size, cfg.hidden_size,
                              column=False, **kw)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate="tanh"))


class GPTBlock(nn.Module):
    def __init__(self, cfg, layer_idx=0, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)
        self.attn = GPTAttention(cfg, **kw)
        self.ln_2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)
        if cfg.num_experts > 0 and (layer_idx + 1) % cfg.moe_every == 0:
            # drawn again by GPTForCausalLM.reset_parameters
            self.mlp = MoELayer(cfg.hidden_size, cfg.intermediate_size,
                                num_experts=cfg.num_experts,
                                top_k=cfg.moe_top_k,
                                capacity_factor=cfg.moe_capacity_factor,
                                **kw)
        else:
            self.mlp = GPTMLP(cfg, **kw)
        self.dropout = Dropout(cfg.hidden_dropout)
        if _sp(cfg):
            mark_sequence_parallel(*self.ln_1.parameters(),
                                   *self.ln_2.parameters())

    def forward(self, x, cache=None, return_aux=False):
        """The block's output; with `return_aux`, (output, the routed
        MLP's aux loss or a float32 zero), so that the aux loss leaves
        recompute's checkpoint as an output."""
        x = x + self.dropout(self.attn(self.ln_1(x), cache=cache))
        x = x + self.dropout(self.mlp(self.ln_2(x)))
        if return_aux:
            aux = getattr(self.mlp, "aux_loss", None)
            return x, aux if aux is not None else \
                torch.zeros((), device=x.device)
        return x


class GPTModel(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.wte = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden_size,
                                          **kw) if cfg.tensor_parallel \
            else nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = nn.Embedding(cfg.max_position_embeddings,
                                cfg.hidden_size, **kw)
        self.drop = Dropout(cfg.hidden_dropout)
        self.h = nn.ModuleList([GPTBlock(cfg, i, **kw)
                                for i in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)
        if _sp(cfg):
            mark_sequence_parallel(*self.ln_f.parameters())

    def forward(self, input_ids, position_ids=None, caches=None):
        """Final hidden states [b, s, hidden].  With paged or preallocated
        caches the tokens sit at pos .. pos + s - 1 (`pos` 0-d, or [b]
        per row); with concat caches after the cached length.  Under
        sequence or context parallelism, this rank's sequence shard
        [b, s/mp, hidden]."""
        b, s = input_ids.shape
        if position_ids is None:
            ar = torch.arange(s, device=input_ids.device)
            if caches is not None and "pos" in caches[0]:
                p = caches[0]["pos"].long()
                position_ids = (p + ar)[None, :] if p.dim() == 0 else \
                    p[:, None] + ar[None, :]
            else:
                offset = 0 if caches is None else caches[0]["k"].shape[1]
                position_ids = (ar + offset)[None, :]
        if _cp(self.cfg):
            # this rank's contiguous piece of the sequence
            n, r = mesh_mod.degree("mp"), mesh_mod.axis_rank("mp")
            input_ids = input_ids.chunk(n, 1)[r]
            position_ids = position_ids.chunk(n, 1)[r]
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        if _sp(self.cfg):
            x = scatter_seq(x)
        for i, block in enumerate(self.h):
            if self.cfg.use_recompute and self.training and caches is None:
                if isinstance(block.mlp, MoELayer):
                    # the aux loss leaves the checkpoint as an output and
                    # is attached again outside it
                    x, aux = recompute(block, x, return_aux=True)
                    block.mlp.restore_aux_loss(aux)
                else:
                    x = recompute(block, x)
            else:
                x = block(x, cache=None if caches is None else caches[i])
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """The LM head ties the embedding weight: logits = x @ wte.T.

    Built on `device` (the CUDA device unless told otherwise; raises when
    there is none) in `dtype`, with weights drawn like the JAX package's:
    Normal(0, initializer_range) for every Linear weight and embedding,
    zero biases, unit LayerNorm scales, and a routed block's expert and
    router weights from Normal(0, 0.02) (`MoELayer`'s own draw).
    `generator` (a torch.Generator on `device`) makes the draw
    reproducible; by default one seeded with 0."""

    def __init__(self, cfg, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, device=device, dtype=dtype)
        self.reset_parameters(generator if generator is not None
                              else make_generator(0, device))

    @torch.no_grad()
    def reset_parameters(self, generator):
        std = self.cfg.initializer_range
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                init_normal_(mod, std, generator)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, MoELayer):
                mod.reset_parameters(generator)

    def set_dropout_generator(self, generator):
        """Draw every dropout mask of the model (hidden and attention) from
        `generator`, a torch.Generator on the model's device."""
        for mod in self.modules():
            if isinstance(mod, (Dropout, GPTAttention)):
                mod.generator = generator
        return self

    def forward(self, input_ids, position_ids=None, caches=None):
        x = self.gpt(input_ids, position_ids, caches)
        return _tied_head(self.cfg, x, self.gpt.wte.weight)

    def new_caches(self, batch_size, dtype=None, max_length=None):
        """Concat-style caches (eager decode) or, with `max_length`, the
        preallocated static-shape caches of the jitted decode loops: per
        layer {"k", "v": [batch, max_length or 0, H, D] zeros} on the
        model's device, in `dtype` (default: the parameters'), plus a 0-d
        int32 "pos" when preallocated."""
        return _new_caches(self, self.cfg.num_heads, batch_size, dtype,
                           max_length)

    def generate(self, input_ids, max_new_tokens=20, use_jit=True, **kw):
        """`decode.jit_generate` (the captured decode step) or, with
        `use_jit=False`, the eager `generation.generate`."""
        return _generate(self, input_ids, max_new_tokens, use_jit, **kw)


def _tied_head(cfg, x, weight):
    """Full logits x @ weight.T from the final hidden states: under
    tensor parallelism `weight` is this rank's vocab rows, and the
    vocab-split logits are gathered; under sequence or context
    parallelism the sequence shards are gathered too."""
    if _cp(cfg):
        return gather_seq_full(F.linear(x, weight))
    if _tp_degree(cfg) == 1:
        return F.linear(x, weight)
    x = gather_seq(x) if _sp(cfg) else copy_to_mp(x)
    return gather_last(F.linear(x, weight))


class GPTPretrainingCriterion(nn.Module):
    """Token-mean cross entropy; with `loss_mask`, the mean over the
    masked-in tokens (at least 1)."""

    def forward(self, logits, labels, loss_mask=None):
        loss = PF.cross_entropy(logits, labels, reduction="none")
        if loss_mask is not None:
            m = loss_mask.to(loss.dtype)
            return (loss * m).sum() / m.sum().clamp(min=1.0)
        return loss.mean()


def gpt_loss_fn(model, input_ids, labels):
    """The pretraining loss TrainStep drives: cross entropy of the logits
    against `labels` (float32, mean over the labels that are not -100),
    plus `moe_aux_weight` times the routed blocks' aux losses when the
    config routes any."""
    loss = PF.cross_entropy(model(input_ids), labels, reduction="mean")
    cfg = getattr(model, "cfg", None)
    if cfg is not None and getattr(cfg, "num_experts", 0):
        aux = moe_aux_loss(model)
        if aux is not None:
            loss = loss + cfg.moe_aux_weight * aux
    return loss


def _new_caches(model, kv_heads, batch_size, dtype, max_length):
    """`new_caches` of a decoder: one cache dict per layer (see
    `GPTForCausalLM.new_caches`)."""
    cfg = model.cfg
    param = next(iter(model.parameters()))
    shape = (batch_size, 0 if max_length is None else max_length, kv_heads,
             cfg.hidden_size // cfg.num_heads)
    kw = dict(dtype=dtype or param.dtype, device=param.device)
    caches = []
    for _ in range(cfg.num_layers):
        c = {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
        if max_length is not None:
            c["pos"] = torch.zeros((), dtype=torch.int32,
                                   device=param.device)
        caches.append(c)
    return caches


def _generate(model, input_ids, max_new_tokens, use_jit, **kw):
    fn = jit_generate if use_jit else _eager_generate
    return fn(model, input_ids, max_new_tokens=max_new_tokens, **kw)
