"""Transformer encoder layers (counterpart: `paddle_tpu/nn/transformer.py:19-145`).

`MultiHeadAttention` keeps the JAX layer's surface: separate q / k / v /
out projections, a concat `Cache` or a `StaticCache` of projected
cross-attention k / v, and the attention core through
`functional.scaled_dot_product_attention` (the flash kernels on the card
inside their gate; dropout applies to the attention OUTPUT, as the JAX
package applies it).  `TransformerEncoderLayer` takes `normalize_before`
both ways, looks `activation` up by name in `nn.functional`, and has
`attn_dropout` / `act_dropout`; its LayerNorms take Paddle's default
epsilon 1e-5.  `TransformerEncoder` deep-copies the first layer
(`:132-135`), so every layer starts with the same weights, as in the JAX
package.  The decoder classes and `Transformer` are not ported yet.

Parameters are drawn as the JAX package draws them: every Linear weight
Xavier-uniform (limit sqrt(6 / (fan_in + fan_out))), biases zero, norm
scales one, from `generator` (None: the device's default generator).
Layers are built on `device` (None: PyTorch's default device).
"""
from __future__ import annotations

import collections
import copy
import math

import torch
from torch import nn

from . import Dropout
from . import functional as PF


@torch.no_grad()
def xavier_linear(in_features, out_features, device=None, dtype=None,
                  generator=None):
    """nn.Linear with a Xavier-uniform weight and a zero bias (the JAX
    Linear's default initializers)."""
    lin = nn.Linear(in_features, out_features, device=device, dtype=dtype)
    limit = math.sqrt(6.0 / (in_features + out_features))
    lin.weight.uniform_(-limit, limit, generator=generator)
    lin.bias.zero_()
    return lin


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, device=None, dtype=None,
                 generator=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = xavier_linear(embed_dim, embed_dim, **kw)
        self.k_proj = xavier_linear(kdim or embed_dim, embed_dim, **kw)
        self.v_proj = xavier_linear(vdim or embed_dim, embed_dim, **kw)
        self.out_proj = xavier_linear(embed_dim, embed_dim, **kw)
        self.generator = None       # attention dropout's generator

    def _shape(self, x):
        b, l, _ = x.shape
        return x.reshape(b, l, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """[b, l, embed_dim] -> the same; with a cache, (out, new
        cache).  `attn_mask` is bool (True keeps) or additive, broadcast
        to [b, H, lq, lk] (a key-padding mask is [b, 1, 1, lk])."""
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            # cross-attention: k / v were projected once from the memory
            k, v = cache.k, cache.v
            new_cache = cache
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if cache is not None:
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                new_cache = self.Cache(k, v)
        out = PF.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, generator=self.generator)
        b, l = out.shape[:2]
        out = self.out_proj(out.reshape(b, l, self.embed_dim))
        return out if cache is None else (out, new_cache)

    def gen_cache(self, key, value=None, type=None):
        """An empty `Cache` [b, 0, H, D] for self-attention decoding, or
        with `type=StaticCache` the projected k / v of `key` / `value`."""
        if type is self.StaticCache:
            value = key if value is None else value
            return self.StaticCache(self._shape(self.k_proj(key)),
                                    self._shape(self.v_proj(value)))
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        return self.Cache(key.new_zeros(shape), key.new_zeros(shape))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.normalize_before = normalize_before
        kw = dict(device=device, dtype=dtype)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout if attn_dropout is not None
            else dropout, generator=generator, **kw)
        self.linear1 = xavier_linear(d_model, dim_feedforward,
                                     generator=generator, **kw)
        self.linear2 = xavier_linear(dim_feedforward, d_model,
                                     generator=generator, **kw)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, **kw)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = getattr(PF, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is not None:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        else:
            src = self.self_attn(src, src, src, src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out
