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
`gpt_loss_fn` adds `moe_aux_weight` times their sum.  Tensor, sequence
and context parallelism are the distributed slice's (ROADMAP.md A11):
their flags raise NotImplementedError when set.

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
from ..distributed.recompute import recompute
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
        self.tensor_parallel = bool(tensor_parallel)
        # MoE (GShard / Switch): num_experts > 0 routes the FFN of every
        # `moe_every`-th block
        self.num_experts = num_experts
        self.moe_top_k = moe_top_k
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_every = moe_every
        self.moe_aux_weight = moe_aux_weight
        on = [name for name in ("tensor_parallel", "sequence_parallel",
                                "context_parallel") if getattr(self, name)]
        if on:
            raise NotImplementedError(
                f"{', '.join(on)}: the port's distributed slice is not "
                f"ported yet (ROADMAP.md A11)")

    @classmethod
    def from_preset(cls, name, **kw):
        return cls(**{**cls.PRESETS[name], **kw})


class GPTAttention(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        kw = dict(device=device, dtype=dtype)
        self.qkv_proj = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size, **kw)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.dropout_p = cfg.attention_dropout
        self.generator = None       # attention dropout's generator

    def forward(self, x, cache=None):
        b, s, h = x.shape
        # [b, s, 3, H, D] then unbind the 3: the JAX package's qkv layout
        qkv = self.qkv_proj(x).view(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
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
        else:
            # dropout on the attention output in training, as the JAX
            # package applies it
            out = PF.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.dropout_p,
                training=self.training, generator=self.generator)
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

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
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = nn.Embedding(cfg.max_position_embeddings,
                                cfg.hidden_size, **kw)
        self.drop = Dropout(cfg.hidden_dropout)
        self.h = nn.ModuleList([GPTBlock(cfg, i, **kw)
                                for i in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)

    def forward(self, input_ids, position_ids=None, caches=None):
        """Final hidden states [b, s, hidden].  With paged or preallocated
        caches the tokens sit at pos .. pos + s - 1 (`pos` 0-d, or [b]
        per row); with concat caches after the cached length."""
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
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
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
                mod.weight.normal_(0.0, std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
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
        return F.linear(x, self.gpt.wte.weight)

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
