"""ERNIE-3.0 (counterpart: `paddle_tpu/text/ernie.py:13-172`).

A BERT encoder with task-type embeddings: `ErnieModel` holds a
`BertModel` under `bert` (its embeddings, encoder and pooler) and adds
`task_type_embeddings` (drawn Normal(0, 1), the JAX Embedding's default)
to the word, position and token-type embeddings before the norm.  The
heads are those of the JAX package: sequence and token classification,
question answering (start / end logits), and the masked-LM head, whose
decoder is the word embedding weight (held by reference and not
registered, so it appears in no state dict under the head's name), with
pretraining's sentence-order head.  `ERNIE3_PRESETS` are the released
sizes.  The names match the JAX package's, so `weights.
load_paddle_tpu_state` carries its weights across.

The deployment path is `jit.save_inference` -> `inference.
create_predictor`, which runs the exported program on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import Dropout
from ..nn import functional as PF
from ..nn.transformer import xavier_linear
from .bert import BertConfig, BertModel, _setup, normal_embedding


class ErnieConfig(BertConfig):
    def __init__(self, task_type_vocab_size=3, use_task_id=True, **kw):
        kw.setdefault("vocab_size", 40000)
        super().__init__(**kw)
        self.task_type_vocab_size = task_type_vocab_size
        self.use_task_id = use_task_id


# ERNIE-3.0 released sizes (PaddleNLP ernie-3.0-{nano..base})
ERNIE3_PRESETS = {
    "ernie-3.0-nano-zh": dict(hidden_size=312, num_hidden_layers=4,
                              num_attention_heads=12,
                              intermediate_size=1248),
    "ernie-3.0-micro-zh": dict(hidden_size=384, num_hidden_layers=4,
                               num_attention_heads=12,
                               intermediate_size=1536),
    "ernie-3.0-mini-zh": dict(hidden_size=384, num_hidden_layers=6,
                              num_attention_heads=12,
                              intermediate_size=1536),
    "ernie-3.0-medium-zh": dict(hidden_size=768, num_hidden_layers=6,
                                num_attention_heads=12,
                                intermediate_size=3072),
    "ernie-3.0-base-zh": dict(hidden_size=768, num_hidden_layers=12,
                              num_attention_heads=12,
                              intermediate_size=3072),
}


def ernie_config_from_preset(name, **kw):
    return ErnieConfig(**{**ERNIE3_PRESETS[name], **kw})


class ErnieModel(nn.Module):
    def __init__(self, cfg=None, device=None, dtype=torch.float32,
                 generator=None, **kw):
        super().__init__()
        cfg = cfg or ErnieConfig(**kw)
        self.cfg = cfg
        device, generator = _setup(device, generator)
        self.bert = BertModel(cfg, device=device, dtype=dtype,
                              generator=generator)
        if cfg.use_task_id:
            self.task_type_embeddings = normal_embedding(
                cfg.task_type_vocab_size, cfg.hidden_size, 1.0, device,
                dtype, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        emb = self.bert.embeddings
        x = emb.embed(input_ids, token_type_ids, position_ids)
        if self.cfg.use_task_id:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            x = x + self.task_type_embeddings(task_type_ids)
        x = emb.dropout(emb.layer_norm(x))
        return self.bert.encode(x, attention_mask)


class _ErnieHead(nn.Module):
    """An ErnieModel and a Linear classifier of `n_out` outputs."""

    def __init__(self, cfg, n_out, dropout, device, dtype, generator, kw):
        super().__init__()
        device, generator = _setup(device, generator)
        self.ernie = ErnieModel(cfg, device=device, dtype=dtype,
                                generator=generator, **kw)
        c = self.ernie.cfg
        if dropout:
            self.dropout = Dropout(c.hidden_dropout_prob)
        self.classifier = xavier_linear(c.hidden_size, n_out, device=device,
                                        dtype=dtype, generator=generator)


class ErnieForSequenceClassification(_ErnieHead):
    def __init__(self, cfg=None, num_classes=2, device=None,
                 dtype=torch.float32, generator=None, **kw):
        super().__init__(cfg, num_classes, True, device, dtype, generator,
                         kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask)
        return self.classifier(self.dropout(pooled))


class ErnieForTokenClassification(_ErnieHead):
    def __init__(self, cfg=None, num_classes=2, device=None,
                 dtype=torch.float32, generator=None, **kw):
        super().__init__(cfg, num_classes, True, device, dtype, generator,
                         kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, _ = self.ernie(input_ids, token_type_ids, position_ids,
                            attention_mask)
        return self.classifier(self.dropout(seq))


class ErnieForQuestionAnswering(_ErnieHead):
    """Start / end span logits, each [b, s]."""

    def __init__(self, cfg=None, device=None, dtype=torch.float32,
                 generator=None, **kw):
        super().__init__(cfg, 2, False, device, dtype, generator, kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, _ = self.ernie(input_ids, token_type_ids, position_ids,
                            attention_mask)
        logits = self.classifier(seq)            # [b, s, 2]
        return logits[:, :, 0], logits[:, :, 1]


class ErnieLMHead(nn.Module):
    """transform -> GELU -> LayerNorm (epsilon 1e-5) -> the word
    embedding weight, tied by reference: logits = h @ W_emb.T + bias."""

    def __init__(self, ernie, device=None, dtype=None, generator=None):
        super().__init__()
        c = ernie.cfg
        self.transform = xavier_linear(c.hidden_size, c.hidden_size,
                                       device=device, dtype=dtype,
                                       generator=generator)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=1e-5,
                                       device=device, dtype=dtype)
        self.decoder_bias = nn.Parameter(torch.zeros(
            c.vocab_size, device=device, dtype=dtype))
        # a list, so the embedding is not registered a second time
        self._word_emb = [ernie.bert.embeddings.word_embeddings]

    def forward(self, seq):
        h = self.layer_norm(PF.gelu(self.transform(seq)))
        return F.linear(h, self._word_emb[0].weight, self.decoder_bias)


class ErnieForMaskedLM(nn.Module):
    def __init__(self, cfg=None, device=None, dtype=torch.float32,
                 generator=None, **kw):
        super().__init__()
        device, generator = _setup(device, generator)
        self.ernie = ErnieModel(cfg, device=device, dtype=dtype,
                                generator=generator, **kw)
        self.lm_head = ErnieLMHead(self.ernie, device, dtype, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, _ = self.ernie(input_ids, token_type_ids, position_ids,
                            attention_mask)
        return self.lm_head(seq)


class ErnieForPretraining(ErnieForMaskedLM):
    """The masked-LM head and a sentence-order head on the pooled output."""

    def __init__(self, cfg=None, device=None, dtype=torch.float32,
                 generator=None, **kw):
        device, generator = _setup(device, generator)
        super().__init__(cfg, device, dtype, generator, **kw)
        self.sop_head = xavier_linear(self.ernie.cfg.hidden_size, 2,
                                      device=device, dtype=dtype,
                                      generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                 attention_mask)
        return self.lm_head(seq), self.sop_head(pooled)
