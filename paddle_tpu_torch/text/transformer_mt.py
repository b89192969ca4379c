"""Seq2seq Transformer for machine translation (counterpart:
`paddle_tpu/text/transformer_mt.py`): token and sinusoidal position
embeddings, `nn.Transformer` with pre-norm layers, a tied or separate
generator head, teacher-forced training with a label-smoothed loss and a
greedy decode through per-layer caches.

The decoder's causal mask is an additive float32 [1, 1, s, s] of -1e9
above the diagonal, and the source padding mask an additive [b, 1, 1, s],
as the JAX model builds them: so a training step's self-attention takes
the masked flash kernels, and cross-attention (Lq != Lk) too.  `generate`
encodes once, then feeds one token a step: self-attention reads a
concat cache that grows one key a step, cross-attention the memory's
k / v projected once (`StaticCache`); both run the decode kernel at
Lq 1 on the card.  The loop runs eagerly and reads `finished.all()` on
the host each step, as the JAX model's eager loop does.

With `weight_sharing` the logits are `out @ trg_embed.weight.T`: a plain
product, outside any Pallas kernel in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import nn
from ..nn import functional as F


def sinusoidal_positions(max_len, d_model):
    """The sin / cos table [max_len, d_model] (float32, made on the host
    once)."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    dim = np.arange(0, d_model, 2).astype(np.float64)
    div = np.exp(-math.log(10000.0) * dim / d_model)
    table = np.zeros((max_len, d_model), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    # odd d_model: the cos half has one column fewer
    table[:, 1::2] = np.cos(pos * div)[:, :d_model // 2]
    return table


class TransformerModel(nn.Layer):
    """Encoder-decoder MT model: returns [b, tgt_len, trg_vocab] logits.
    Embeddings are drawn from N(0, d_model^-0.5), the rest as
    `nn.Transformer` draws it, from `generator` on `device` (None: the
    current CUDA device)."""

    def __init__(self, src_vocab_size, trg_vocab_size, max_length=256,
                 d_model=512, n_head=8, num_encoder_layers=6,
                 num_decoder_layers=6, d_inner_hid=2048, dropout=0.1,
                 weight_sharing=False, bos_id=0, eos_id=1, device=None,
                 dtype=None, generator=None):
        super().__init__(device=device, generator=generator)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.d_model = d_model
        self.bos_id, self.eos_id = bos_id, eos_id
        init = nn.initializer.Normal(0.0, d_model ** -0.5)
        self.src_embed = nn.Embedding(src_vocab_size, d_model,
                                      weight_attr=init, **kw)
        if weight_sharing:
            if src_vocab_size != trg_vocab_size:
                raise ValueError(
                    "weight_sharing requires equal src/trg vocab sizes")
            self.trg_embed = self.src_embed
        else:
            self.trg_embed = nn.Embedding(trg_vocab_size, d_model,
                                          weight_attr=init, **kw)
        self.register_buffer(
            "pos_table", torch.from_numpy(sinusoidal_positions(
                max_length, d_model)).to(self._resolved_device()),
            persistable=False)
        self.dropout = nn.Dropout(dropout)
        self.transformer = nn.Transformer(
            d_model=d_model, nhead=n_head,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers,
            dim_feedforward=d_inner_hid, dropout=dropout,
            activation="relu", normalize_before=True, **kw)
        self.weight_sharing = weight_sharing
        if not weight_sharing:
            self.generator = nn.Linear(d_model, trg_vocab_size, **kw)

    def _embed(self, table, ids, offset=0):
        s = ids.shape[1]
        if offset + s > self.pos_table.shape[0]:
            raise ValueError(
                f"sequence length {offset + s} exceeds the model's "
                f"max_length {self.pos_table.shape[0]}")
        x = table(ids) * (self.d_model ** 0.5)
        return self.dropout(x + self.pos_table[offset:offset + s])

    def _causal_mask(self, s):
        m = torch.full((s, s), -1e9, dtype=torch.float32,
                       device=self.pos_table.device)
        return torch.triu(m, diagonal=1)[None, None]

    @staticmethod
    def _pad_mask(ids, pad_id):
        # [b, 1, 1, s] additive mask: -1e9 on pad positions
        m = (ids == pad_id).to(torch.float32) * -1e9
        return m[:, None, None, :]

    def _logits(self, out):
        if self.weight_sharing:
            return torch.matmul(out, self.trg_embed.weight.t())
        return self.generator(out)

    def forward(self, src_word, trg_word, src_pad_id=None):
        src_mask = None if src_pad_id is None else \
            self._pad_mask(src_word, src_pad_id)
        tgt_mask = self._causal_mask(trg_word.shape[1])
        out = self.transformer(
            self._embed(self.src_embed, src_word),
            self._embed(self.trg_embed, trg_word),
            src_mask=src_mask, tgt_mask=tgt_mask, memory_mask=src_mask)
        return self._logits(out)

    # --------------------------------------------------------- inference
    @torch.no_grad()
    def generate(self, src_word, max_length=32, src_pad_id=None):
        """Greedy decode with incremental caches, in eval mode: [b, 1 +
        steps] tokens starting with bos; rows that emitted eos keep
        emitting it, and the loop ends when every row has."""
        limit = self.pos_table.shape[0]
        if max_length > limit:
            raise ValueError(
                f"generate(max_length={max_length}) exceeds the model's "
                f"positional table ({limit}); rebuild with a larger "
                "max_length")
        was_training = self.training
        self.eval()
        try:
            b = src_word.shape[0]
            src_mask = None if src_pad_id is None else \
                self._pad_mask(src_word, src_pad_id)
            memory = self.transformer.encoder(
                self._embed(self.src_embed, src_word), src_mask)
            caches = self.transformer.decoder.gen_cache(memory)
            out = torch.full((b, 1), self.bos_id, dtype=torch.int32,
                             device=src_word.device)
            finished = torch.zeros(b, dtype=torch.bool,
                                   device=src_word.device)
            cur = out
            for step in range(max_length):
                dec, caches = self.transformer.decoder(
                    self._embed(self.trg_embed, cur, offset=step),
                    memory, None, src_mask, cache=caches)
                nxt = self._logits(dec[:, -1]).argmax(-1).to(torch.int32)
                nxt = torch.where(finished, torch.full_like(
                    nxt, self.eos_id), nxt)
                finished = finished | (nxt == self.eos_id)
                cur = nxt[:, None]
                out = torch.cat([out, cur], 1)
                if bool(finished.all()):
                    break
            return out
        finally:
            if was_training:
                self.train()


def transformer_mt_loss(model, src, trg, label_smooth_eps=0.1,
                        pad_id=None):
    """Teacher-forced MT loss: predict trg[:, 1:] from trg[:, :-1], label
    smoothing `label_smooth_eps`, the mean over the non-pad targets."""
    logits = model(src, trg[:, :-1], src_pad_id=pad_id)
    return F.cross_entropy(
        logits, trg[:, 1:], reduction="mean",
        ignore_index=-100 if pad_id is None else pad_id,
        label_smoothing=label_smooth_eps)
