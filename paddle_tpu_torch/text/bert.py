"""BERT (counterpart: `paddle_tpu/text/bert.py:9-123`).

The same module tree and parameter names as the JAX package
(`bert.embeddings.word_embeddings.weight`,
`bert.encoder.layers.0.self_attn.q_proj.weight`, `bert.pooler.weight`,
`classifier.weight`, ...), so `weights.load_paddle_tpu_state` carries a
JAX model's weights across name for name (Linear weights transposed).

What the JAX model does, kept here:
- an attention mask [b, s] of 1 (keep) / 0 (pad) becomes the additive
  `(1 - m) * -1e4` in the activations' dtype (so -1e4 rounds to -9984 in
  bfloat16, as it does in JAX), shaped [b, 1, 1, s] (`:73-75`); it is an
  input, not a trained tensor, so on the card it goes to the flash
  kernels (in bf16 / fp16 the sm90 forward, dK/dV and dQ take it, the
  backward kernels in their key-vector instantiation; float32 runs the
  fp32 forward and the sm80 dK/dV and dQ);
- the pooled output is tanh(pooler(seq[:, 0]));
- the encoder deep-copies its first layer, so every layer starts with
  the same weights;
- `BertLMPredictionHead.decoder_weight` IS the word embedding weight
  (tied): `named_parameters()` lists it once, under the embedding's name,
  and `state_dict()` under both; the loader takes the embedding's name.

Models are built on `device` (the CUDA device unless told otherwise;
raises when there is none) in `dtype`, the weights drawn like the JAX
package's from `generator` (default: one seeded with 0 on `device`):
embeddings Normal(0, initializer_range), Linear weights Xavier-uniform,
biases zero, norm scales one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import generator as make_generator
from ..device import resolve_device
from ..nn import Dropout, TransformerEncoder, TransformerEncoderLayer
from ..nn import functional as PF
from ..nn.transformer import xavier_linear


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, pad_token_id=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.pad_token_id = pad_token_id


@torch.no_grad()
def normal_embedding(num, dim, std, device, dtype, generator):
    """nn.Embedding with weights drawn Normal(0, std) from `generator`."""
    emb = nn.Embedding(num, dim, device=device, dtype=dtype)
    emb.weight.normal_(0.0, std, generator=generator)
    return emb


def _setup(device, generator):
    """(device, generator) of a model: the CUDA device unless told
    otherwise, and a generator seeded with 0 there unless given."""
    device = resolve_device(device)
    return device, (generator if generator is not None
                    else make_generator(0, device))


def additive_mask(attention_mask, dtype):
    """[b, s] 1 / 0 -> additive [b, 1, 1, s] in `dtype`: (1 - m) * -1e4."""
    am = (1.0 - attention_mask.to(dtype)) * -1e4
    return am[:, None, None, :]


class BertEmbeddings(nn.Module):
    def __init__(self, cfg, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        std, h = cfg.initializer_range, cfg.hidden_size
        self.word_embeddings = normal_embedding(cfg.vocab_size, h, std, **kw)
        self.position_embeddings = normal_embedding(
            cfg.max_position_embeddings, h, std, **kw)
        self.token_type_embeddings = normal_embedding(
            cfg.type_vocab_size, h, std, **kw)
        self.layer_norm = nn.LayerNorm(h, eps=1e-12, device=device,
                                       dtype=dtype)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def embed(self, input_ids, token_type_ids=None, position_ids=None):
        """word + position + token type embeddings, before the norm."""
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        return (self.word_embeddings(input_ids)
                + self.position_embeddings(position_ids)
                + self.token_type_embeddings(token_type_ids))

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        return self.dropout(self.layer_norm(
            self.embed(input_ids, token_type_ids, position_ids)))


class BertModel(nn.Module):
    def __init__(self, cfg=None, device=None, dtype=torch.float32,
                 generator=None, **kw):
        super().__init__()
        cfg = cfg or BertConfig(**kw)
        self.cfg = cfg
        device, generator = _setup(device, generator)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embeddings = BertEmbeddings(cfg, **kw)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob, **kw)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_hidden_layers)
        self.pooler = xavier_linear(cfg.hidden_size, cfg.hidden_size, **kw)

    def encode(self, x, attention_mask=None):
        """(seq, pooled) of the embedded x under a [b, s] 1 / 0 mask."""
        if attention_mask is not None:
            attention_mask = additive_mask(attention_mask, x.dtype)
        seq = self.encoder(x, attention_mask)
        return seq, torch.tanh(self.pooler(seq[:, 0]))

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        return self.encode(x, attention_mask)


class BertForSequenceClassification(nn.Module):
    def __init__(self, cfg=None, num_classes=2, device=None,
                 dtype=torch.float32, generator=None, **kw):
        super().__init__()
        device, generator = _setup(device, generator)
        self.bert = BertModel(cfg, device=device, dtype=dtype,
                              generator=generator, **kw)
        c = self.bert.cfg
        self.dropout = Dropout(c.hidden_dropout_prob)
        self.classifier = xavier_linear(c.hidden_size, num_classes,
                                        device=device, dtype=dtype,
                                        generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))


class BertLMPredictionHead(nn.Module):
    """transform -> GELU -> LayerNorm -> the tied decoder: logits =
    x @ embedding_weights.T + decoder_bias."""

    def __init__(self, cfg, embedding_weights, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.transform = xavier_linear(cfg.hidden_size, cfg.hidden_size,
                                       device=device, dtype=dtype,
                                       generator=generator)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-12,
                                       device=device, dtype=dtype)
        self.decoder_weight = embedding_weights
        self.decoder_bias = nn.Parameter(torch.zeros(
            cfg.vocab_size, device=device, dtype=dtype))

    def forward(self, x):
        x = self.layer_norm(PF.gelu(self.transform(x)))
        return F.linear(x, self.decoder_weight, self.decoder_bias)


class BertForPretraining(nn.Module):
    def __init__(self, cfg=None, device=None, dtype=torch.float32,
                 generator=None, **kw):
        super().__init__()
        device, generator = _setup(device, generator)
        self.bert = BertModel(cfg, device=device, dtype=dtype,
                              generator=generator, **kw)
        c = self.bert.cfg
        self.cls = BertLMPredictionHead(
            c, self.bert.embeddings.word_embeddings.weight, device=device,
            dtype=dtype, generator=generator)
        self.nsp = xavier_linear(c.hidden_size, 2, device=device,
                                 dtype=dtype, generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        return self.cls(seq), self.nsp(pooled)


def bert_loss_fn(model, input_ids, token_type_ids, labels):
    """The fine-tune loss `bench.py::run_bert` drives: cross entropy of a
    sequence classifier's logits (float32, mean over the batch)."""
    return PF.cross_entropy(model(input_ids, token_type_ids), labels,
                            reduction="mean")
