"""Fused transformer layers.

Counterpart: `paddle_tpu/incubate/nn/fused_transformer.py`.  The raw
parameters keep the JAX names and [in, out] layouts (`qkv_weight`
[d, 3d], `linear_weight` [d, d], `linear1_weight` [d, f], ...), so
`weights.load_paddle_tpu_state` copies them without a transpose.  Weights
are drawn Xavier-uniform from `generator` (None: the device's default
generator), biases zero, norm scales one; a layer is built on `device`
(None: PyTorch's default device).  Attention goes through
`nn.functional.scaled_dot_product_attention`, so on the card the flash
kernels take it.  Dropout draws from the layer's `generator` attribute
(None: the device's default generator).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import functional as PF

__all__ = ["FusedFeedForward", "FusedMultiHeadAttention"]


def _xavier(shape, kw, generator):
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    w = torch.empty(shape, **kw)
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)
    return nn.Parameter(w)


def _const(n, value, kw):
    return nn.Parameter(torch.full((n,), value, **kw))


class _Fused(nn.Module):
    def _norm(self, x):
        return F.layer_norm(x, x.shape[-1:], self.ln_scale, self.ln_bias,
                            self.epsilon)

    def _dropout(self, x, p):
        return PF.dropout(x, p, training=self.training,
                          generator=self.generator)


class FusedMultiHeadAttention(_Fused):
    """Self-attention over [B, S, D] with a packed qkv weight, the residual,
    dropout and layer norm inside: pre-LN with `normalize_before`, else
    post-LN.  `attn_mask` is a bool (True keeps) or additive mask."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, linear_weight_attr=None,
                 epsilon=1e-5, name=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("num_heads must evenly divide embed_dim")
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.epsilon = epsilon
        self.generator = None           # dropout's generator
        kw = dict(device=device, dtype=dtype)
        self.qkv_weight = _xavier((embed_dim, 3 * embed_dim), kw, generator)
        self.qkv_bias = _const(3 * embed_dim, 0.0, kw)
        self.linear_weight = _xavier((embed_dim, embed_dim), kw, generator)
        self.linear_bias = _const(embed_dim, 0.0, kw)
        self.ln_scale = _const(embed_dim, 1.0, kw)
        self.ln_bias = _const(embed_dim, 0.0, kw)

    def forward(self, x, attn_mask=None):
        residual = x
        if self.normalize_before:
            x = self._norm(x)
        b, s, d = x.shape
        qkv = F.linear(x, self.qkv_weight.t(), self.qkv_bias)
        q, k, v = qkv.view(b, s, 3, self.num_heads, self.head_dim).unbind(2)
        out = PF.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_dropout_rate,
            training=self.training, generator=self.generator)
        out = F.linear(out.reshape(b, s, d), self.linear_weight.t(),
                       self.linear_bias)
        out = residual + self._dropout(out, self.dropout_rate)
        return out if self.normalize_before else self._norm(out)


class FusedFeedForward(_Fused):
    """Two-layer FFN with the residual, dropout and layer norm inside:
    pre-LN with `normalize_before`, else post-LN.  `activation` names a
    function of `nn.functional` (relu, gelu, silu, tanh)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear2_weight_attr=None, name=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = dropout_rate if act_dropout_rate is None \
            else act_dropout_rate
        self.activation = activation
        self._act = getattr(PF, activation)
        self.epsilon = epsilon
        self.generator = None           # dropout's generator
        kw = dict(device=device, dtype=dtype)
        self.linear1_weight = _xavier((d_model, dim_feedforward), kw,
                                      generator)
        self.linear1_bias = _const(dim_feedforward, 0.0, kw)
        self.linear2_weight = _xavier((dim_feedforward, d_model), kw,
                                      generator)
        self.linear2_bias = _const(d_model, 0.0, kw)
        self.ln_scale = _const(d_model, 1.0, kw)
        self.ln_bias = _const(d_model, 0.0, kw)

    def forward(self, x):
        residual = x
        if self.normalize_before:
            x = self._norm(x)
        h = self._act(F.linear(x, self.linear1_weight.t(),
                               self.linear1_bias))
        h = self._dropout(h, self.act_dropout_rate)
        h = F.linear(h, self.linear2_weight.t(), self.linear2_bias)
        out = residual + self._dropout(h, self.dropout_rate)
        return out if self.normalize_before else self._norm(out)
