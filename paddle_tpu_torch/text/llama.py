"""LLaMA family: RoPE, RMSNorm, SwiGLU, GQA, optional sliding window.

Counterpart: `paddle_tpu/text/llama.py`.  Same presets, module tree and
parameter names (`llama.embed_tokens.weight`,
`llama.layers.0.self_attn.q_proj.weight`, `lm_head.weight`, ...), so
`weights.load_paddle_tpu_state` carries a JAX model across name for name.

`LlamaAttention` has the JAX package's four branches: the block-paged
pool (serving engine), the preallocated cache (jitted decode loops, the
window as a band in the length mask), the concat cache (eager decode,
the window as a banded mask over the concatenated keys) and no cache
(training and dense inference, the window passed to `sdpa`).  GQA kv
heads stay unrepeated: the flash and paged kernels read kv head
h // (H // Hkv) in place.

`_rope` rotates interleaved pairs (x[..., ::2], x[..., 1::2]), as the JAX
package does, not HF's rotate-half.  It computes in float32 and rounds
the result to q's dtype; the JAX `_rope` lets bfloat16 q and k promote
to float32 there (ROADMAP.md C).

Parallelism over the mesh's "mp" axis follows `text/gpt.py` (JAX:
`llama.py:99-107`, `:201`, `:236`, `:252-253`, `:278`): under
`tensor_parallel` q / k / v, gate and up are column-parallel, o and down
row-parallel, the embedding vocab-parallel and the untied `lm_head`
column-parallel with its output gathered; GQA needs `num_kv_heads`
divisible by the mp degree (rank r holds kv heads r*Hkv/mp ...).
`sequence_parallel` is Megatron-SP, `context_parallel` the ring over
sequence shards, with rope at the shard's global positions.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import ops
from ..device import generator as make_generator
from ..device import resolve_device
from ..distributed import mesh as mesh_mod
from ..distributed.parallel_layers import (ColumnParallelLinear,
                                           VocabParallelEmbedding,
                                           gather_seq_full, init_normal_,
                                           mark_sequence_parallel,
                                           scatter_seq)
from ..distributed.recompute import recompute
from ..distributed.ring_attention import ring_attention_local
from ..nn import RMSNorm
from ..nn import functional as PF
from .decode import _update_paged_cache, _update_prealloc_cache
from .gpt import (_check_parallel, _cp, _generate, _linear, _new_caches,
                  _no_parallel_cache, _sp, _tp_degree)


class LlamaConfig:
    PRESETS = {
        "llama-7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                         intermediate_size=11008),
        "llama-13b": dict(hidden_size=5120, num_layers=40, num_heads=40,
                          intermediate_size=13824),
        "llama-tiny": dict(hidden_size=256, num_layers=2, num_heads=4,
                           intermediate_size=688),
        # Mistral = the llama block + GQA (8 kv heads) + a 4096 window
        "mistral-7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                           num_kv_heads=8, intermediate_size=14336,
                           vocab_size=32000, rope_theta=10000.0,
                           max_position_embeddings=32768,
                           sliding_window=4096),
    }

    def __init__(self, vocab_size=32000, hidden_size=4096, num_layers=32,
                 num_heads=32, num_kv_heads=None, intermediate_size=11008,
                 max_position_embeddings=4096, rms_norm_eps=1e-6,
                 rope_theta=10000.0, initializer_range=0.02,
                 use_recompute=False, sequence_parallel=False,
                 context_parallel=False, tensor_parallel=None,
                 attention_bias=False, sliding_window=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.initializer_range = initializer_range
        self.use_recompute = use_recompute
        self.sequence_parallel = sequence_parallel
        self.context_parallel = context_parallel
        self.tensor_parallel = bool(tensor_parallel) \
            if tensor_parallel is not None \
            else mesh_mod.degree("mp") > 1 and not context_parallel
        # attention_bias: biased q/k/v projections (Qwen2); sliding_window:
        # Mistral's banded causal attention
        self.attention_bias = attention_bias
        self.sliding_window = sliding_window
        if sliding_window and context_parallel:
            raise ValueError(
                "sliding_window does not compose with context_parallel "
                "(the ring rotates full KV shards); pick one")
        _check_parallel(self)

    @classmethod
    def from_preset(cls, name, **kw):
        return cls(**{**cls.PRESETS[name], **kw})


def _rope(q, k, positions, theta):
    """Rotary embedding of q, k [b, s, h, d] at `positions` [1|b, s]: each
    interleaved pair (x[..., 2i], x[..., 2i + 1]) rotated by positions *
    theta ** (-2i / d), in float32, each result rounded to its input's
    dtype."""
    d = q.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=q.device) / d))
    freqs = positions[..., None].float() * inv              # [1|b, s, d/2]
    cos = torch.cos(freqs)[:, :, None, :]
    sin = torch.sin(freqs)[:, :, None, :]

    def rot(x):
        xf = x.float()
        x1, x2 = xf[..., ::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.reshape(x.shape).to(x.dtype)

    return rot(q), rot(k)


class LlamaAttention(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.head_dim = cfg.hidden_size // cfg.num_heads
        n = _tp_degree(cfg)
        if cfg.num_heads % n or cfg.num_kv_heads % n:
            raise ValueError(
                f"tensor parallelism needs num_heads ({cfg.num_heads}) and "
                f"num_kv_heads ({cfg.num_kv_heads}) divisible by the mp "
                f"degree ({n})")
        self.local_heads = cfg.num_heads // n
        self.local_kv_heads = cfg.num_kv_heads // n
        kw = dict(device=device, dtype=dtype)
        bias = bool(cfg.attention_bias)
        self.q_proj = _linear(cfg, cfg.hidden_size,
                              cfg.num_heads * self.head_dim, bias=bias, **kw)
        self.k_proj = _linear(cfg, cfg.hidden_size,
                              cfg.num_kv_heads * self.head_dim, bias=bias,
                              **kw)
        self.v_proj = _linear(cfg, cfg.hidden_size,
                              cfg.num_kv_heads * self.head_dim, bias=bias,
                              **kw)
        self.o_proj = _linear(cfg, cfg.num_heads * self.head_dim,
                              cfg.hidden_size, column=False, bias=False, **kw)

    def forward(self, x, cache=None):
        cfg = self.cfg
        _no_parallel_cache(self, cache)
        q = self.q_proj(x)
        b, s = q.shape[:2]          # the whole sequence under Megatron-SP
        q = q.view(b, s, self.local_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.local_kv_heads, self.head_dim)
        v = self.v_proj(x).view(b, s, self.local_kv_heads, self.head_dim)
        ar = torch.arange(s, device=x.device)
        if _cp(cfg):
            # this rank's shard sits at global positions r*s .. r*s + s-1
            ar = ar + mesh_mod.axis_rank("mp") * s
        if cache is not None and "pos" in cache:
            # paged or preallocated: a 0-d offset or [b] per-row offsets
            p = cache["pos"].long()
            positions = (p[:, None] if p.dim() else p) + ar[None, :]
        else:
            offset = 0 if cache is None else cache["k"].shape[1]
            positions = (ar + offset)[None, :]
        q, k = _rope(q, k, positions, cfg.rope_theta)

        W = cfg.sliding_window
        if cache is not None and "table" in cache:
            # block-paged pool (serving engine): write, then attend
            if W:
                raise NotImplementedError(
                    "sliding_window does not compose with the paged "
                    "serving cache (the pool keeps the full context); "
                    "serve this model without paged attention")
            kp, vp = _update_paged_cache(cache, k, v)
            out = ops.paged_attention(q, kp, vp, cache["table"],
                                      cache["pos"])
            return self.o_proj(out.reshape(b, s, -1))
        mask = None
        if cache is not None and "pos" in cache:
            k, v, mask = _update_prealloc_cache(cache, k, v, s, window=W)
        elif cache is not None:
            k = torch.cat([cache["k"], k], dim=1)
            v = torch.cat([cache["v"], v], dim=1)
            cache["k"], cache["v"] = k, v
            if W:
                # banded mask over the concatenated window: row r sits at
                # absolute position Lk - s + r and attends (r' - W, r']
                Lk = k.shape[1]
                cols = torch.arange(Lk, device=x.device)[None, :]
                rows = (Lk - s + ar)[:, None]
                mask = ((cols <= rows) & (cols > rows - W)).reshape(
                    1, 1, s, Lk)
        if mask is not None:
            out = PF.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=0.0,
                training=self.training)
        elif _cp(cfg):
            out = ring_attention_local(q, k, v, "mp", causal=True)
        else:
            out = PF.scaled_dot_product_attention(
                q, k, v, is_causal=cache is None or s > 1, dropout_p=0.0,
                training=self.training,
                sliding_window=W if cache is None else None)
        return self.o_proj(out.reshape(b, s, -1))


class LlamaMLP(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = _linear(cfg, cfg.hidden_size, cfg.intermediate_size,
                                 **kw)
        self.up_proj = _linear(cfg, cfg.hidden_size, cfg.intermediate_size,
                               **kw)
        self.down_proj = _linear(cfg, cfg.intermediate_size, cfg.hidden_size,
                                 column=False, **kw)

    def forward(self, x):
        return self.down_proj(PF.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       **kw)
        self.self_attn = LlamaAttention(cfg, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(cfg, **kw)
        if _sp(cfg):
            mark_sequence_parallel(self.input_layernorm.weight,
                                   self.post_attention_layernorm.weight)

    def forward(self, x, cache=None):
        x = x + self.self_attn(self.input_layernorm(x), cache=cache)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, **kw) if cfg.tensor_parallel \
            else nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList([LlamaBlock(cfg, **kw)
                                     for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        if _sp(cfg):
            mark_sequence_parallel(self.norm.weight)

    def forward(self, input_ids, caches=None):
        """Final hidden states [b, s, hidden] (this rank's sequence shard
        under sequence or context parallelism)."""
        if _cp(self.cfg):
            input_ids = input_ids.chunk(mesh_mod.degree("mp"), 1)[
                mesh_mod.axis_rank("mp")]
        x = self.embed_tokens(input_ids)
        if _sp(self.cfg):
            x = scatter_seq(x)
        for i, block in enumerate(self.layers):
            if self.cfg.use_recompute and self.training and caches is None:
                x = recompute(block, x)
            else:
                x = block(x, cache=None if caches is None else caches[i])
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """An untied LM head over `LlamaModel`.

    Built on `device` (the CUDA device unless told otherwise; raises when
    there is none) in `dtype`, with weights drawn like the JAX package's:
    Normal(0, initializer_range) for every Linear weight and the
    embedding, zero biases, unit RMSNorm scales.  `generator` (a
    torch.Generator on `device`) makes the draw reproducible; by default
    one seeded with 0."""

    def __init__(self, cfg, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.llama = LlamaModel(cfg, device=device, dtype=dtype)
        self.lm_head = ColumnParallelLinear(
            cfg.hidden_size, cfg.vocab_size, has_bias=False,
            sequence_parallel=_sp(cfg), device=device, dtype=dtype) \
            if cfg.tensor_parallel else \
            nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                      device=device, dtype=dtype)
        self.reset_parameters(generator if generator is not None
                              else make_generator(0, device))

    @torch.no_grad()
    def reset_parameters(self, generator):
        std = self.cfg.initializer_range
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                init_normal_(mod, std, generator)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    def forward(self, input_ids, caches=None):
        logits = self.lm_head(self.llama(input_ids, caches))
        return gather_seq_full(logits) if _cp(self.cfg) else logits

    def new_caches(self, batch_size, dtype=None, max_length=None):
        """Concat-style caches or, with `max_length`, preallocated ones,
        of `num_kv_heads` heads (see `GPTForCausalLM.new_caches`)."""
        return _new_caches(self, self.cfg.num_kv_heads, batch_size, dtype,
                           max_length)

    def generate(self, input_ids, max_new_tokens=20, use_jit=True, **kw):
        """`decode.jit_generate` (the captured decode step) or, with
        `use_jit=False`, the eager `generation.generate`."""
        return _generate(self, input_ids, max_new_tokens, use_jit, **kw)
