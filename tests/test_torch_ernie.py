"""The port's ERNIE-3.0 and its deployment path against the JAX package's,
on the CPU.

Models are built in the JAX package from a seed and their weights carried
into the port (`load_paddle_tpu_state`); inputs are made with numpy.

* Every head (`ErnieModel`, sequence and token classification, question
  answering, masked LM with the decoder tied to the word embeddings,
  pretraining) against the JAX head, with and without a padding mask.
* Every preset: the port's config equals the JAX one field for field,
  and a model at the preset's width (one layer, a small vocabulary)
  matches JAX.
* The deployment path as `bench.py::run_ernie_infer` drives it:
  `save_inference` -> `inference.create_predictor` -> `copy_from_cpu` /
  `run` / `copy_to_cpu`.  The predictor's logits equal the port's eager
  model bit for bit (the exported program runs the same operators on
  the same device) and match the JAX predictor's; an `InputSpec` with a
  `None` batch dim gives one program that takes two batch sizes;
  `load_inference` runs the program alone; the export leaves the model's
  train / eval modes as they were; `aot=True` over a `None` dim raises
  ValueError (the AOT packages themselves: `test_torch_aot.py`).

Tolerance against JAX: float32 on both sides, summed in another order:
rtol 1e-5, atol 1e-5 (1e-4 absolute for the masked-LM logits, which sum
over the hidden width twice more).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import inference as jinference
from paddle_tpu.jit.save_load import InputSpec as JaxInputSpec
from paddle_tpu.jit.save_load import save_inference as jax_save_inference
from paddle_tpu.text import ernie as jernie
from paddle_tpu_torch import inference
from paddle_tpu_torch.jit import (InputSpec, is_inference_dir, load_inference,
                                  save_inference)
from paddle_tpu_torch.text import ernie as ternie
from paddle_tpu_torch.weights import load_paddle_tpu_state

TINY = dict(vocab_size=80, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
TOL = dict(rtol=1e-5, atol=1e-5)
HEADS = ["ErnieModel", "ErnieForSequenceClassification",
         "ErnieForTokenClassification", "ErnieForQuestionAnswering",
         "ErnieForMaskedLM", "ErnieForPretraining"]


def _np(t):
    return np.asarray(t._array.astype(jnp.float32))


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _pair(head, seed=0, **cfg):
    pt.seed(seed)
    cfg = dict(TINY, **cfg)
    jm = getattr(jernie, head)(jernie.ErnieConfig(**cfg))
    tm = getattr(ternie, head)(ternie.ErnieConfig(**cfg), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v)
                               for k, v in jm.state_dict().items()})
    jm.eval()
    tm.eval()
    return jm, tm


def _ids(b=3, s=16, vocab=TINY["vocab_size"], seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int64)
    lens = rng.integers(s // 2, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int64)
    return ids, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("head", HEADS)
def test_every_head_matches_jax(head, masked):
    jm, tm = _pair(head)
    ids, mask = _ids()
    kw = dict(attention_mask=mask) if masked else {}
    jout = _outs(jm(pt.to_tensor(ids),
                    **{k: pt.to_tensor(v) for k, v in kw.items()}))
    with torch.no_grad():
        tout = _outs(tm(torch.from_numpy(ids),
                        **{k: torch.from_numpy(v) for k, v in kw.items()}))
    assert len(jout) == len(tout)
    atol = 1e-4 if head in ("ErnieForMaskedLM", "ErnieForPretraining") \
        else TOL["atol"]
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), _np(j), rtol=TOL["rtol"],
                                   atol=atol)


def test_lm_head_decoder_is_the_word_embedding():
    """The masked-LM decoder reads the word embedding weight by reference
    and registers no parameter of its own for it."""
    _, tm = _pair("ErnieForMaskedLM")
    assert tm.lm_head._word_emb[0] is tm.ernie.bert.embeddings.word_embeddings
    assert not any("word" in n for n, _ in tm.lm_head.named_parameters())


@pytest.mark.parametrize("preset", sorted(jernie.ERNIE3_PRESETS))
def test_every_preset_matches_jax(preset):
    jcfg = jernie.ernie_config_from_preset(preset)
    tcfg = ternie.ernie_config_from_preset(preset)
    assert vars(tcfg) == vars(jcfg)
    assert ternie.ERNIE3_PRESETS[preset] == jernie.ERNIE3_PRESETS[preset]
    width = {k: jernie.ERNIE3_PRESETS[preset][k] for k in (
        "hidden_size", "num_attention_heads", "intermediate_size")}
    jm, tm = _pair("ErnieForSequenceClassification", num_hidden_layers=1,
                   **width)
    ids, mask = _ids(b=2, s=12, seed=1)
    jlog = jm(pt.to_tensor(ids), attention_mask=pt.to_tensor(mask))
    with torch.no_grad():
        tlog = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **TOL)


# ------------------------------------------------------- deployment path
def _predict(predictor, ids):
    h = predictor.get_input_handle(predictor.get_input_names()[0])
    h.copy_from_cpu(ids)
    predictor.run()
    return [predictor.get_output_handle(n).copy_to_cpu()
            for n in predictor.get_output_names()]


def test_predictor_equals_eager_and_matches_the_jax_predictor(tmp_path):
    """run_ernie_infer's calls, on the CPU, at a tiny size: a static
    [batch, seq] int64 spec named input_ids."""
    jm, tm = _pair("ErnieForSequenceClassification")
    ids, _ = _ids(b=4, s=16)
    jax_save_inference(jm, str(tmp_path / "jax"),
                       [JaxInputSpec([4, 16], "int64", "input_ids")])
    jlogits = _predict(jinference.create_predictor(
        jinference.Config(str(tmp_path / "jax"))), ids)[0]
    tm.train()                              # restored after the export
    tm.ernie.bert.encoder.layers[1].eval()
    save_inference(tm, str(tmp_path / "port"),
                   [InputSpec([4, 16], "int64", "input_ids")])
    assert tm.training and not tm.ernie.bert.encoder.layers[1].training
    assert tm.ernie.bert.encoder.layers[0].training
    assert is_inference_dir(str(tmp_path / "port"))
    assert not is_inference_dir(str(tmp_path / "jax"))
    predictor = inference.create_predictor(
        inference.Config(str(tmp_path / "port")))
    assert predictor.get_input_names() == ["input_ids"]
    assert predictor.get_output_names() == ["output_0"]
    logits = _predict(predictor, ids)[0]
    tm.eval()
    with torch.no_grad():
        eager = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(logits, eager)
    np.testing.assert_allclose(logits, jlogits, **TOL)


def test_dynamic_batch_program_takes_two_batch_sizes(tmp_path):
    """A None batch dim: one exported program for batches 2 and 5; two
    outputs (question answering) come back as two handles; the loaded
    program runs alone through load_inference."""
    _, tm = _pair("ErnieForQuestionAnswering", seed=3)
    save_inference(tm, str(tmp_path), [InputSpec([None, 16], "int64",
                                                 "input_ids")])
    predictor = inference.create_predictor(inference.Config(str(tmp_path)))
    assert predictor.get_output_names() == ["output_0", "output_1"]
    layer = load_inference(str(tmp_path))
    for b in (2, 5):
        ids, _ = _ids(b=b, s=16, seed=b)
        start, end = _predict(predictor, ids)
        with torch.no_grad():
            want = tm(torch.from_numpy(ids))
        np.testing.assert_array_equal(start, want[0].numpy())
        np.testing.assert_array_equal(end, want[1].numpy())
        got = layer(ids)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(RuntimeError):
        layer.train()


def test_predictor_refuses_a_run_before_its_input_and_aot(tmp_path):
    """A run before any input is refused, and so is an AOT export of a
    `None` dim (a compiled package is specialized to its shapes), as the
    JAX package refuses it."""
    _, tm = _pair("ErnieForSequenceClassification", seed=4)
    spec = [InputSpec([2, 8], "int64", "input_ids")]
    with pytest.raises(ValueError, match="concrete input shapes"):
        save_inference(tm, str(tmp_path / "dyn"),
                       [InputSpec([None, 8], "int64", "input_ids")],
                       aot=True)
    assert not (tmp_path / "dyn").exists()
    save_inference(tm, str(tmp_path), spec)
    predictor = inference.create_predictor(inference.Config(str(tmp_path)))
    with pytest.raises(ValueError, match="copy_from_cpu"):
        predictor.run()
