"""HuggingFace checkpoint conversion into the port's models.

Counterpart: `paddle_tpu/text/convert.py:33-235` —
`convert_hf_llama`, `convert_hf_qwen2`, `convert_hf_gpt2`,
`convert_hf_bert` and `convert_hf_ernie`.  The
source is a `transformers` model or its state dict, of torch tensors or
numpy arrays; nothing here imports `transformers`.  The target's
parameters are overwritten in place, each in its own dtype and on its
own device.

Layouts.  The port's Linear is `torch.nn.Linear`, [out, in] as HF's, so
LLaMA-family, BERT and ERNIE weights are NOT transposed (the JAX package
transposes them into its [in, out]).  HF applies rotary embeddings to half-split
pairs (i, i + d/2) and the port to interleaved pairs (2i, 2i + 1), as the
JAX package does, so the q / k projection rows (and q / k biases) are
permuted per head (`_rope_perm`).  GPT-2's Conv1D is [in, out], so its
weights ARE transposed here; its fused c_attn maps onto the fused
qkv_proj ([q | k | v] rows) and the head stays tied to wte.

One intended divergence (ROADMAP.md C2): the JAX converter takes
`attention_bias` from the entry point (off for LLaMA, on for Qwen2), so
a LLaMA config with biases converted by `convert_hf_llama` keeps zero
biases.  Here the flag is the target config's `attention_bias`, and the
conversion raises ValueError when the checkpoint's q / k / v bias keys
disagree with it.  BERT and ERNIE convert the encoder, embeddings and
pooler and leave the task heads as they are, as the JAX converter does.
"""
from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["convert_hf_bert", "convert_hf_ernie", "convert_hf_gpt2",
           "convert_hf_llama", "convert_hf_qwen2"]


def _np(t):
    """A torch tensor or numpy array -> float32 numpy (a bfloat16
    tensor, which numpy cannot hold, is upcast in torch first)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _state(hf):
    sd = hf.state_dict() if hasattr(hf, "state_dict") else hf
    return {k: _np(v) for k, v in sd.items()}


def _check_layer_count(sd, pattern, n_target, arch):
    """A deeper checkpoint must not silently convert its prefix."""
    layers = {int(m.group(1)) for k in sd
              for m in [re.match(pattern, k)] if m}
    if layers and max(layers) + 1 != n_target:
        raise ValueError(
            f"convert_{arch}: source checkpoint has {max(layers) + 1} "
            f"layers but the target model has {n_target} — configure the "
            f"target to match the checkpoint")


@torch.no_grad()
def _assign(model, mapping):
    params = dict(model.named_parameters())
    missing = [k for k in mapping if k not in params]
    if missing:
        raise KeyError(f"convert: no such target params {missing[:4]}")
    for name, arr in mapping.items():
        p = params[name]
        if tuple(p.shape) != arr.shape:
            raise ValueError(
                f"convert: {name} shape {tuple(p.shape)} != source "
                f"{arr.shape}")
        p.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return model


def _rope_perm(w_out_in, n_heads, head_dim):
    """Reorder [out, in] q / k rows from HF's half-split rope layout to the
    interleaved one: row 2i <- HF row i, row 2i + 1 <- HF row i + d/2,
    within each head."""
    perm = np.empty(head_dim, np.int64)
    half = head_dim // 2
    perm[0::2] = np.arange(half)
    perm[1::2] = np.arange(half) + half
    w = w_out_in.reshape(n_heads, head_dim, -1)[:, perm]
    return w.reshape(n_heads * head_dim, -1)


def _convert_llama_family(model, hf, label):
    sd = _state(hf)
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    cfg = model.cfg
    _check_layer_count(sd, rf"{re.escape(pre)}layers\.(\d+)\.",
                       cfg.num_layers, label)
    bias = bool(cfg.attention_bias)

    def has(proj):
        return any(re.match(rf"{re.escape(pre)}layers\.\d+\.self_attn\."
                            rf"{proj}\.bias$", k) for k in sd)

    if has("[qkv]_proj") != bias:
        raise ValueError(
            f"convert_{label}: the target config has attention_bias="
            f"{bias} but the checkpoint "
            f"{'has' if not bias else 'has no'} q/k/v biases")
    if has("o_proj"):
        raise ValueError(f"convert_{label}: the checkpoint has o_proj "
                         f"biases, which the LLaMA block does not have")
    dh = cfg.hidden_size // cfg.num_heads
    out = {"llama.embed_tokens.weight": sd[pre + "embed_tokens.weight"],
           "llama.norm.weight": sd[pre + "norm.weight"],
           # a tied or stripped checkpoint has no lm_head: the head is a
           # separate parameter here, so it takes the embedding
           "lm_head.weight": sd.get("lm_head.weight",
                                    sd[pre + "embed_tokens.weight"])}
    for i in range(cfg.num_layers):
        h, o = f"{pre}layers.{i}.", f"llama.layers.{i}."
        a, oa = h + "self_attn.", o + "self_attn."
        out[o + "input_layernorm.weight"] = sd[h + "input_layernorm.weight"]
        out[o + "post_attention_layernorm.weight"] = \
            sd[h + "post_attention_layernorm.weight"]
        out[oa + "q_proj.weight"] = _rope_perm(sd[a + "q_proj.weight"],
                                               cfg.num_heads, dh)
        out[oa + "k_proj.weight"] = _rope_perm(sd[a + "k_proj.weight"],
                                               cfg.num_kv_heads, dh)
        out[oa + "v_proj.weight"] = sd[a + "v_proj.weight"]
        out[oa + "o_proj.weight"] = sd[a + "o_proj.weight"]
        if bias:
            # a bias is one more rope-rotated row
            out[oa + "q_proj.bias"] = _rope_perm(
                sd[a + "q_proj.bias"][:, None], cfg.num_heads,
                dh).reshape(-1)
            out[oa + "k_proj.bias"] = _rope_perm(
                sd[a + "k_proj.bias"][:, None], cfg.num_kv_heads,
                dh).reshape(-1)
            out[oa + "v_proj.bias"] = sd[a + "v_proj.bias"]
        for w in ("gate_proj", "up_proj", "down_proj"):
            out[o + f"mlp.{w}.weight"] = sd[h + f"mlp.{w}.weight"]
    return _assign(model, out)


def convert_hf_llama(model, hf):
    """transformers Llama{Model,ForCausalLM} (or its state dict) -> the
    port's LlamaForCausalLM (also Mistral)."""
    return _convert_llama_family(model, hf, "hf_llama")


def convert_hf_qwen2(model, hf):
    """transformers Qwen2{Model,ForCausalLM} (or its state dict) -> the
    port's Qwen2ForCausalLM (the LLaMA mapping with rope-permuted q / k
    biases)."""
    return _convert_llama_family(model, hf, "hf_qwen2")


def convert_hf_gpt2(model, hf):
    """transformers GPT2{Model,LMHeadModel} (or its state dict) -> the
    port's GPTForCausalLM; Conv1D weights [in, out] are transposed."""
    sd = _state(hf)
    pre = "transformer." if any(k.startswith("transformer.")
                                for k in sd) else ""
    cfg = model.cfg
    _check_layer_count(sd, rf"{re.escape(pre)}h\.(\d+)\.",
                       cfg.num_layers, "hf_gpt2")
    out = {"gpt.wte.weight": sd[pre + "wte.weight"],
           "gpt.wpe.weight": sd[pre + "wpe.weight"],
           "gpt.ln_f.weight": sd[pre + "ln_f.weight"],
           "gpt.ln_f.bias": sd[pre + "ln_f.bias"]}
    pairs = (("ln_1", "ln_1"), ("ln_2", "ln_2"),
             ("attn.qkv_proj", "attn.c_attn"),
             ("attn.out_proj", "attn.c_proj"),
             ("mlp.fc_in", "mlp.c_fc"), ("mlp.fc_out", "mlp.c_proj"))
    for i in range(cfg.num_layers):
        h, o = f"{pre}h.{i}.", f"gpt.h.{i}."
        for ours, theirs in pairs:
            w = sd[h + theirs + ".weight"]
            out[o + ours + ".weight"] = w if ours.startswith("ln") else w.T
            out[o + ours + ".bias"] = sd[h + theirs + ".bias"]
    return _assign(model, out)


def convert_hf_bert(model, hf):
    """transformers Bert{Model,For*} (or its state dict) -> the port's
    BERT-bearing model (anything with `bert.*` parameters: BertModel's
    parent heads, or an ErnieModel); the task heads are left as they
    are.  HF's [out, in] Linear weights go across untransposed."""
    sd = _state(hf)
    pre = "bert." if any(k.startswith("bert.") for k in sd) else ""
    n_layers = model.bert.cfg.num_hidden_layers
    _check_layer_count(sd, rf"{re.escape(pre)}encoder\.layer\.(\d+)\.",
                       n_layers, "hf_bert")
    emb = pre + "embeddings."
    out = {f"bert.embeddings.{n}.weight": sd[f"{emb}{n}.weight"]
           for n in ("word_embeddings", "position_embeddings",
                     "token_type_embeddings")}
    out["bert.embeddings.layer_norm.weight"] = sd[emb + "LayerNorm.weight"]
    out["bert.embeddings.layer_norm.bias"] = sd[emb + "LayerNorm.bias"]
    if pre + "pooler.dense.weight" in sd:
        out["bert.pooler.weight"] = sd[pre + "pooler.dense.weight"]
        out["bert.pooler.bias"] = sd[pre + "pooler.dense.bias"]
    for i in range(n_layers):
        h, o = pre + f"encoder.layer.{i}.", f"bert.encoder.layers.{i}."
        att = h + "attention."
        pairs = ((o + "self_attn.q_proj", att + "self.query"),
                 (o + "self_attn.k_proj", att + "self.key"),
                 (o + "self_attn.v_proj", att + "self.value"),
                 (o + "self_attn.out_proj", att + "output.dense"),
                 (o + "linear1", h + "intermediate.dense"),
                 (o + "linear2", h + "output.dense"),
                 (o + "norm1", att + "output.LayerNorm"),
                 (o + "norm2", h + "output.LayerNorm"))
        for ours, theirs in pairs:
            out[ours + ".weight"] = sd[theirs + ".weight"]
            out[ours + ".bias"] = sd[theirs + ".bias"]
    return _assign(model, out)


def convert_hf_ernie(model, hf):
    """transformers Ernie{Model,For*} (or its state dict) -> the port's
    ErnieModel or an ERNIE head: the BERT mapping for the body, then the
    task-type embeddings when both sides have them."""
    sd = _state(hf)
    pre = "ernie." if any(k.startswith("ernie.") for k in sd) else ""
    sub = {k[len(pre):]: v for k, v in sd.items()} if pre else sd
    core = model.ernie if hasattr(model, "ernie") else model
    convert_hf_bert(core, sub)
    tt = "embeddings.task_type_embeddings.weight"
    if tt in sub and getattr(core.cfg, "use_task_id", False):
        _assign(core, {"task_type_embeddings.weight": sub[tt]})
    return model
