"""Transformer layers (counterpart: `paddle_tpu/nn/transformer.py`).

`MultiHeadAttention` keeps the JAX layer's surface: separate q / k / v /
out projections (`Linear`), a concat `Cache` or a `StaticCache` of
projected cross-attention k / v, and the attention core through
`functional.scaled_dot_product_attention` (the flash kernels on the card
inside their gate; dropout applies to the attention OUTPUT, as the JAX
package applies it).  The encoder and decoder layers take
`normalize_before` both ways and look `activation` up by name in
`nn.functional`; their LayerNorms take Paddle's default epsilon 1e-5.
`TransformerEncoder` and `TransformerDecoder` deep-copy the first layer,
so every layer starts with the same weights, as in the JAX package.

What the JAX classes do, the port does, quirks included:
* `TransformerEncoderLayer` takes `weight_attr` / `bias_attr` and does
  not pass them on; `TransformerDecoderLayer` takes `attn_dropout` /
  `act_dropout` and uses `dropout` for both attentions, with no dropout
  after the activation;
* `Transformer` builds its encoder and decoder without a final norm,
  also with `normalize_before=True` (`:237-254`).

Parameters are drawn as the JAX package draws them: every Linear weight
Xavier-uniform, biases zero, norm scales one, from `generator` (None:
the device's default generator), on `device` (None: the current CUDA
device, see `device.resolve_device`).
"""
from __future__ import annotations

import collections
import copy
import math

import torch
from torch import nn

from . import functional as PF
from .common import Dropout, Linear
from .container import LayerList
from .layer import Layer
from .norm import LayerNorm


@torch.no_grad()
def xavier_linear(in_features, out_features, device=None, dtype=None,
                  generator=None):
    """torch.nn.Linear with a Xavier-uniform weight and a zero bias (the
    JAX Linear's default initializers), for the models' heads."""
    lin = nn.Linear(in_features, out_features, device=device, dtype=dtype)
    limit = math.sqrt(6.0 / (in_features + out_features))
    lin.weight.uniform_(-limit, limit, generator=generator)
    lin.bias.zero_()
    return lin


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, dtype=None, generator=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)
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


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.normalize_before = normalize_before
        kw = dict(device=device, dtype=dtype)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout if attn_dropout is not None
            else dropout, generator=generator, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, generator=generator,
                              **kw)
        self.linear2 = Linear(dim_feedforward, d_model, generator=generator,
                              **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
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


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
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


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over the memory and the FFN, each
    in a residual with its norm; `attn_dropout` / `act_dropout` are taken
    and unused (see the module note)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.normalize_before = normalize_before
        kw = dict(device=device, dtype=dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout,
                                            generator=generator, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout,
                                             generator=generator, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, generator=generator,
                              **kw)
        self.linear2 = Linear(dim_feedforward, d_model, generator=generator,
                              **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.norm3 = LayerNorm(d_model, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(PF, activation)

    def gen_cache(self, memory):
        """(an empty self-attention Cache, the cross-attention StaticCache
        of `memory`)."""
        inc = self.self_attn.gen_cache(memory, type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return inc, static

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        new_cache = None
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is not None:
            tgt, inc = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                      cache=cache[0])
            new_cache = (inc, cache[1])
        else:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is not None:
            tgt, _ = self.cross_attn(tgt, memory, memory, memory_mask,
                                     cache=cache[1])
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.activation(self.linear1(tgt)))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if new_cache is None else (tgt, new_cache)


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.norm = norm

    def gen_cache(self, memory):
        return [layer.gen_cache(memory) for layer in self.layers]

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out = tgt
        new_caches = [] if cache is not None else None
        for i, layer in enumerate(self.layers):
            if cache is not None:
                out, c = layer(out, memory, tgt_mask, memory_mask,
                               cache=cache[i])
                new_caches.append(c)
            else:
                out = layer(out, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_caches)


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", normalize_before=False, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(normalize_before=normalize_before, device=device,
                  dtype=dtype, generator=generator)
        enc = TransformerEncoderLayer(d_model, nhead, dim_feedforward,
                                      dropout, activation, **kw)
        dec = TransformerDecoderLayer(d_model, nhead, dim_feedforward,
                                      dropout, activation, **kw)
        self.encoder = TransformerEncoder(enc, num_encoder_layers)
        self.decoder = TransformerDecoder(dec, num_decoder_layers)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)
