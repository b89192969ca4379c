"""The port's HF conversion against `transformers` and against the JAX
package's converter, on the CPU (the LLaMA, Qwen2 and GPT-2 cases of
tests/test_hf_convert.py and tests/test_qwen_swa.py; BERT and ERNIE from
synthetic HF-named state dicts made with numpy).

Tiny `transformers` models are built in the process with random weights
(nothing is downloaded).  The converted port model's float32 logits are
held to the HF forward and to the JAX model converted by the JAX
package, at the JAX test's own tolerance (1e-4 relative, 1e-5
absolute); GPT-2's greedy chain token for token.  Then the layer-count
and shape checks, a bfloat16 checkpoint and a numpy state dict, and the
intended divergence C2 (ROADMAP.md): the port takes `attention_bias`
from the target config and refuses a checkpoint whose bias keys
disagree, where the JAX `convert_hf_llama` silently keeps zero biases.
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import paddle_tpu as pt  # noqa: E402
from paddle_tpu.text import GPTConfig as JaxGPTConfig  # noqa: E402
from paddle_tpu.text import GPTForCausalLM as JaxGPT  # noqa: E402
from paddle_tpu.text import convert as jconvert  # noqa: E402
from paddle_tpu.text.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from paddle_tpu.text.llama import LlamaForCausalLM as JaxLlama  # noqa: E402
from paddle_tpu.text.qwen import Qwen2Config as JaxQwen2Config  # noqa: E402
from paddle_tpu.text.qwen import Qwen2ForCausalLM as JaxQwen2  # noqa: E402
from paddle_tpu_torch.text import (GPTConfig, GPTForCausalLM,  # noqa: E402
                                   LlamaConfig, LlamaForCausalLM,
                                   Qwen2Config, Qwen2ForCausalLM)
from paddle_tpu.text.bert import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.text.bert import (  # noqa: E402
    BertForSequenceClassification as JaxBertCls)
from paddle_tpu.text.ernie import ErnieConfig as JaxErnieConfig  # noqa: E402
from paddle_tpu.text.ernie import (  # noqa: E402
    ErnieForSequenceClassification as JaxErnieCls)
from paddle_tpu_torch.text import (BertConfig,  # noqa: E402
                                   BertForSequenceClassification,
                                   ErnieConfig,
                                   ErnieForSequenceClassification)
from paddle_tpu_torch.text.convert import (convert_hf_bert,  # noqa: E402
                                           convert_hf_ernie,
                                           convert_hf_gpt2,
                                           convert_hf_llama,
                                           convert_hf_qwen2)

TOL = dict(rtol=1e-4, atol=1e-5)
LLAMA = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_size=128,
             max_position_embeddings=64, rms_norm_eps=1e-6,
             rope_theta=10000.0)


def _hf_cfg(**kw):
    return dict(vocab_size=kw["vocab_size"], hidden_size=kw["hidden_size"],
                intermediate_size=kw["intermediate_size"],
                num_hidden_layers=kw["num_layers"],
                num_attention_heads=kw["num_heads"],
                num_key_value_heads=kw["num_kv_heads"],
                max_position_embeddings=kw["max_position_embeddings"],
                rope_theta=kw["rope_theta"], rms_norm_eps=kw["rms_norm_eps"],
                attention_dropout=0.0,
                **({"attention_bias": True} if kw.get("attention_bias")
                   else {}))


def _hf(arch, seed=0, **over):
    from transformers import LlamaConfig as HFL, LlamaForCausalLM as HFLM
    from transformers import Qwen2Config as HFQ, Qwen2ForCausalLM as HFQM
    torch.manual_seed(seed)
    cfg, cls = {"llama": (HFL, HFLM), "qwen2": (HFQ, HFQM)}[arch]
    return cls(cfg(**_hf_cfg(**dict(LLAMA, **over)))).eval()


def _ids(vocab=128, b=2, n=16):
    return np.random.RandomState(0).randint(0, vocab, (b, n))


def _port_logits(model, ids):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(ids)).numpy()


def _hf_logits(hf, ids):
    with torch.no_grad():
        return hf(torch.from_numpy(ids)).logits.numpy()


def _jax_logits(jm, ids):
    jm.eval()
    return np.asarray(jm(pt.to_tensor(ids.astype("int64")))._array)


@pytest.mark.parametrize("arch", ["llama", "qwen2"])
def test_llama_family_matches_transformers_and_jax(arch):
    hf = _hf(arch)
    ids = _ids()
    want = _hf_logits(hf, ids)
    if arch == "llama":
        ours = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu")
        convert_hf_llama(ours, hf)
        pt.seed(0)
        jm = JaxLlama(JaxLlamaConfig(tensor_parallel=False, **LLAMA))
        jconvert.convert_hf_llama(jm, hf)
    else:
        ours = Qwen2ForCausalLM(Qwen2Config(**LLAMA), device="cpu")
        convert_hf_qwen2(ours, hf)
        pt.seed(0)
        jm = JaxQwen2(JaxQwen2Config(tensor_parallel=False, **LLAMA))
        jconvert.convert_hf_qwen2(jm, hf)
    got = _port_logits(ours, ids)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _jax_logits(jm, ids), **TOL)
    # the port's q projection rows are HF's permuted per head, and not
    # transposed ([out, in] on both sides)
    q = dict(ours.named_parameters())["llama.layers.0.self_attn.q_proj.weight"]
    hq = hf.state_dict()["model.layers.0.self_attn.q_proj.weight"]
    assert q.shape == hq.shape
    torch.testing.assert_close(q[1], hq[8], rtol=0, atol=0)   # 2i+1 <- i+d/2


def test_gpt2_matches_transformers_jax_and_greedy_decode():
    from transformers import GPT2Config as HFC, GPT2LMHeadModel as HFM
    torch.manual_seed(0)
    hf = HFM(HFC(vocab_size=130, n_embd=48, n_layer=2, n_head=4,
                 n_positions=64, resid_pdrop=0.0, embd_pdrop=0.0,
                 attn_pdrop=0.0)).eval()
    cfg = dict(vocab_size=130, hidden_size=48, num_layers=2, num_heads=4,
               max_position_embeddings=64, hidden_dropout=0.0,
               attention_dropout=0.0)
    ours = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    convert_hf_gpt2(ours, hf)
    pt.seed(0)
    jm = JaxGPT(JaxGPTConfig(tensor_parallel=False, **cfg))
    jconvert.convert_hf_gpt2(jm, hf)
    ids = _ids(130)
    got = _port_logits(ours, ids)
    np.testing.assert_allclose(got, _hf_logits(hf, ids), **TOL)
    np.testing.assert_allclose(got, _jax_logits(jm, ids), **TOL)
    cur = torch.from_numpy(ids[:1])
    for _ in range(6):
        with torch.no_grad():
            ref = hf(cur).logits[:, -1].argmax(-1)
            mine = ours(cur)[:, -1].argmax(-1)
        assert int(ref[0]) == int(mine[0])
        cur = torch.cat([cur, ref[:, None]], 1)


def test_convert_rejects_layer_count_and_shape_mismatches():
    hf = _hf("llama", num_layers=3)
    with pytest.raises(ValueError, match="layers"):
        convert_hf_llama(LlamaForCausalLM(LlamaConfig(**LLAMA),
                                          device="cpu"), hf)
    wrong = LlamaForCausalLM(LlamaConfig(**dict(LLAMA, num_layers=3,
                                                intermediate_size=96)),
                             device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert_hf_llama(wrong, hf)


def test_convert_bf16_checkpoint_and_numpy_state_dict():
    hf = _hf("llama").to(torch.bfloat16)
    ours = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu")
    convert_hf_llama(ours, hf)
    w = ours.llama.embed_tokens.weight
    assert torch.isfinite(w).all() and w.abs().sum() > 0
    torch.testing.assert_close(
        w, hf.model.embed_tokens.weight.float(), rtol=0, atol=0)
    sd = {k: v.float().numpy() for k, v in hf.state_dict().items()
          if k != "lm_head.weight"}            # a tied / stripped head
    again = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu",
                             dtype=torch.bfloat16)
    convert_hf_llama(again, sd)
    assert again.lm_head.weight.dtype == torch.bfloat16
    torch.testing.assert_close(again.lm_head.weight.float(), w)


def test_attention_bias_follows_the_config_c2_divergence():
    """HF Qwen2 (biased q/k/v, no o bias) converted with convert_hf_llama
    into a LLaMA with attention_bias=True: the port carries the biases
    and matches HF; the JAX converter keeps zero biases and does not.
    A checkpoint whose bias keys disagree with the config raises, and so
    does an o_proj bias, which the LLaMA block cannot hold."""
    hf = _hf("qwen2")
    with torch.no_grad():                     # HF initialises them to 0
        for n, p in hf.named_parameters():
            if n.endswith("_proj.bias"):
                p.normal_(0.0, 0.5)
    ids = _ids()
    want = _hf_logits(hf, ids)
    cfg = dict(LLAMA, attention_bias=True)
    ours = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    convert_hf_llama(ours, hf)
    np.testing.assert_allclose(_port_logits(ours, ids), want, **TOL)
    pt.seed(0)
    jm = JaxLlama(JaxLlamaConfig(tensor_parallel=False, **cfg))
    jconvert.convert_hf_llama(jm, hf)
    jb = np.asarray(dict(jm.named_parameters())[
        "llama.layers.0.self_attn.q_proj.bias"]._array)
    assert not jb.any()                           # the biases stay zero
    assert np.abs(_jax_logits(jm, ids) - want).max() > 1e-3
    with pytest.raises(ValueError, match="attention_bias=False"):
        convert_hf_llama(LlamaForCausalLM(LlamaConfig(**LLAMA),
                                          device="cpu"), hf)
    with pytest.raises(ValueError, match="attention_bias=True"):
        convert_hf_qwen2(Qwen2ForCausalLM(Qwen2Config(**LLAMA),
                                          device="cpu"), _hf("llama"))
    with pytest.raises(ValueError, match="o_proj"):
        convert_hf_llama(ours, _hf("llama", attention_bias=True))


# ------------------------------------------------------------ BERT, ERNIE
BERT = dict(vocab_size=90, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=40, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def _hf_bert_state(prefix="bert.", layers=2, task_types=False, seed=0):
    """An HF-named BERT state dict ([out, in] Linear weights), drawn with
    numpy: embeddings, every encoder layer and the pooler."""
    rng = np.random.default_rng(seed)
    h, f = BERT["hidden_size"], BERT["intermediate_size"]

    def w(*shape, scale=0.2):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    e = prefix + "embeddings."
    sd = {e + "word_embeddings.weight": w(BERT["vocab_size"], h),
          e + "position_embeddings.weight": w(BERT[
              "max_position_embeddings"], h),
          e + "token_type_embeddings.weight": w(2, h),
          e + "LayerNorm.weight": 1 + w(h, scale=0.1),
          e + "LayerNorm.bias": w(h, scale=0.1),
          prefix + "pooler.dense.weight": w(h, h),
          prefix + "pooler.dense.bias": w(h, scale=0.1)}
    if task_types:
        sd[e + "task_type_embeddings.weight"] = w(3, h)
    for i in range(layers):
        L = f"{prefix}encoder.layer.{i}."
        for name, (o, n) in {"attention.self.query": (h, h),
                             "attention.self.key": (h, h),
                             "attention.self.value": (h, h),
                             "attention.output.dense": (h, h),
                             "intermediate.dense": (f, h),
                             "output.dense": (h, f)}.items():
            sd[f"{L}{name}.weight"] = w(o, n)
            sd[f"{L}{name}.bias"] = w(o, scale=0.1)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{L}{ln}.weight"] = 1 + w(h, scale=0.1)
            sd[f"{L}{ln}.bias"] = w(h, scale=0.1)
    return sd


def _jax_cls_logits(jm, ids):
    jm.eval()
    return np.asarray(jm(pt.to_tensor(ids.astype("int64")))._array)


@pytest.mark.parametrize("prefix", ["bert.", ""])
def test_bert_matches_the_jax_converter(prefix):
    """The same synthetic checkpoint through both converters; the task
    head (left untouched by both) carried from the JAX model.  The
    port's Linear weights are HF's, untransposed."""
    sd = _hf_bert_state(prefix)
    pt.seed(0)
    jm = JaxBertCls(JaxBertConfig(**BERT), num_classes=3)
    jconvert.convert_hf_bert(jm, sd)
    ours = BertForSequenceClassification(BertConfig(**BERT), num_classes=3,
                                         device="cpu")
    with torch.no_grad():
        ours.classifier.weight.copy_(torch.from_numpy(
            np.array(jm.classifier.weight._array).T))
        ours.classifier.bias.zero_()
    convert_hf_bert(ours, {k: torch.from_numpy(v) for k, v in sd.items()})
    q = ours.bert.encoder.layers[1].self_attn.q_proj.weight
    np.testing.assert_array_equal(
        q.detach().numpy(), sd[prefix + "encoder.layer.1.attention.self."
                               "query.weight"])
    ids = _ids(BERT["vocab_size"], 3, 12)
    np.testing.assert_allclose(_port_logits(ours, ids),
                               _jax_cls_logits(jm, ids), **TOL)


def test_ernie_matches_the_jax_converter_with_task_types():
    sd = _hf_bert_state("ernie.", task_types=True, seed=1)
    cfg = dict(BERT)
    pt.seed(1)
    jm = JaxErnieCls(JaxErnieConfig(**cfg), num_classes=2)
    jconvert.convert_hf_ernie(jm, sd)
    ours = ErnieForSequenceClassification(ErnieConfig(**cfg), num_classes=2,
                                          device="cpu")
    with torch.no_grad():
        ours.classifier.weight.copy_(torch.from_numpy(
            np.array(jm.classifier.weight._array).T))
        ours.classifier.bias.zero_()
    convert_hf_ernie(ours, sd)
    np.testing.assert_array_equal(
        ours.ernie.task_type_embeddings.weight.detach().numpy(),
        sd["ernie.embeddings.task_type_embeddings.weight"])
    ids = _ids(BERT["vocab_size"], 2, 10)
    np.testing.assert_allclose(_port_logits(ours, ids),
                               _jax_cls_logits(jm, ids), **TOL)


def test_bert_and_ernie_reject_a_layer_count_mismatch():
    """A deeper checkpoint raises rather than converting its prefix (and
    a shallower one rather than leaving layers as they were)."""
    for layers in (3, 1):
        with pytest.raises(ValueError, match="layers"):
            convert_hf_bert(BertForSequenceClassification(
                BertConfig(**BERT), device="cpu"),
                _hf_bert_state(layers=layers))
        with pytest.raises(ValueError, match="layers"):
            convert_hf_ernie(ErnieForSequenceClassification(
                ErnieConfig(**BERT), device="cpu"),
                _hf_bert_state("ernie.", layers=layers))
