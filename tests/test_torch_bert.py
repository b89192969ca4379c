"""The port's BERT against the JAX package's, on the CPU.

A tiny BERT is built in the JAX package from a seed and its weights
carried into the port (`load_paddle_tpu_state`); inputs are made with
numpy.  Covered:

* `BertModel` (sequence and pooled outputs), `BertForSequenceClassification`
  and `BertForPretraining` (the LM head's decoder tied to the word
  embeddings, and the NSP head), with and without the padding mask;
* the fine-tune as `bench.py::run_bert` runs it: a 3-step `TrainStep`
  loss series and the final parameters against `pt.jit.train_step`
  under AdamW with a `LinearWarmup(PolynomialDecay)` schedule stepped by
  the caller, two parameter groups (biases and norms: no decay, half the
  rate) and `apply_decay_param_fun`, on padded rows, in float32 and in
  pure bfloat16 (AMP O2 without master weights).

Tolerances.  float32: the same formulas summed in another order: losses
rtol 1e-5 / atol 1e-6, outputs rtol 1e-5 / atol 1e-5, parameters after
the steps atol 1e-3 x lr x steps (Adam normalises each update to about
the rate, ill-conditioned where a gradient nearly cancels, as
tests/test_torch_gpt_training.py states).  bfloat16: the sides round at
other places (torch's LayerNorm and GELU in one float32 kernel, the JAX
ops in bf16 steps), which moves a loss of ~0.7 over two classes by a few
units of 2**-8: atol 2e-2 (measured on the CPU: below 1e-2).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as JF
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.text.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.bert import BertForPretraining as JaxBertPretraining
from paddle_tpu.text.bert import BertForSequenceClassification as JaxBertCls
from paddle_tpu.text.bert import BertModel as JaxBertModel
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.text import (BertConfig, BertForPretraining,
                                   BertForSequenceClassification, BertModel)
from paddle_tpu_torch.weights import load_paddle_tpu_state

TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_LOSS_ATOL = 2e-2
LR, STEPS = 1e-2, 3


def _np(t):
    import jax.numpy as jnp
    return np.asarray(t._array.astype(jnp.float32))


def _arrays(jax_model):
    return {k: np.asarray(v) for k, v in jax_model.state_dict().items()}


def _pair(jax_cls, port_cls, seed=0, **kw):
    pt.seed(seed)
    jm = jax_cls(JaxBertConfig(**TINY), **kw)
    tm = port_cls(BertConfig(**TINY), device="cpu", **kw)
    load_paddle_tpu_state(tm, _arrays(jm))
    jm.eval()
    tm.eval()
    return jm, tm


def _batch(seed=0, b=3, s=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], (b, s))
    seg = rng.integers(0, 2, (b, s))
    lens = rng.integers(s // 2, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int64)
    labels = rng.integers(0, 2, b)
    return ids, seg, mask, labels


def _jt(x):
    return pt.to_tensor(np.asarray(x).astype("int64"))


def _tt(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("masked", [False, True])
def test_bert_model_outputs_match_jax(masked):
    jm, tm = _pair(JaxBertModel, BertModel)
    ids, seg, mask, _ = _batch()
    m = mask if masked else None
    jseq, jpooled = jm(_jt(ids), _jt(seg),
                       attention_mask=None if m is None else _jt(m))
    with torch.no_grad():
        tseq, tpooled = tm(_tt(ids), _tt(seg),
                           attention_mask=None if m is None else _tt(m))
    np.testing.assert_allclose(tseq.numpy(), _np(jseq), **OUT_TOL)
    np.testing.assert_allclose(tpooled.numpy(), _np(jpooled), **OUT_TOL)


def test_sequence_classifier_matches_jax():
    jm, tm = _pair(JaxBertCls, BertForSequenceClassification,
                   num_classes=3)
    ids, seg, mask, _ = _batch(1)
    jlog = jm(_jt(ids), _jt(seg), attention_mask=_jt(mask))
    with torch.no_grad():
        tlog = tm(_tt(ids), _tt(seg), attention_mask=_tt(mask))
    assert tuple(tlog.shape) == (3, 3)
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **OUT_TOL)


def test_pretraining_heads_with_the_tied_decoder_match_jax():
    """The JAX state dict lists the tied decoder once, under the word
    embedding's name; the port's names it twice (state_dict) and the
    loader fills both from it.  The MLM and NSP logits then agree, and
    the decoder follows the embedding."""
    jm, tm = _pair(JaxBertPretraining, BertForPretraining)
    arrays = _arrays(jm)
    assert "cls.decoder_weight" not in arrays
    assert "cls.decoder_weight" in tm.state_dict()
    assert tm.cls.decoder_weight is tm.bert.embeddings.word_embeddings.weight
    assert len(list(tm.parameters())) == len(list(jm.parameters()))
    ids, seg, mask, _ = _batch(2)
    jmlm, jnsp = jm(_jt(ids), _jt(seg), attention_mask=_jt(mask))
    with torch.no_grad():
        tmlm, tnsp = tm(_tt(ids), _tt(seg), attention_mask=_tt(mask))
    np.testing.assert_allclose(tmlm.numpy(), _np(jmlm), **OUT_TOL)
    np.testing.assert_allclose(tnsp.numpy(), _np(jnsp), **OUT_TOL)
    with torch.no_grad():
        tm.bert.embeddings.word_embeddings.weight.mul_(2.0)
    assert torch.equal(tm.cls.decoder_weight,
                       tm.bert.embeddings.word_embeddings.weight)
    # a state without the shared tensor under any of its names is missing
    del arrays["bert.embeddings.word_embeddings.weight"]
    with pytest.raises(KeyError, match="word_embeddings"):
        load_paddle_tpu_state(tm, arrays)


def test_attention_mask_is_additive_in_the_activation_dtype():
    """(1 - m) * -1e4 built in x's dtype: -1e4 rounds to -9984 in bf16,
    as in JAX, shaped [b, 1, 1, s]."""
    from paddle_tpu_torch.text.bert import additive_mask
    m = torch.tensor([[1, 1, 0]])
    am = additive_mask(m, torch.bfloat16)
    assert tuple(am.shape) == (1, 1, 1, 3) and am.dtype == torch.bfloat16
    assert am[0, 0, 0].float().tolist() == [0.0, 0.0, -9984.0]


# ------------------------------------------------------------- fine-tune
def _decay_fun(name):
    return "pooler" not in name


def _groups(named):
    """Two groups: weights (the global rate and decay), and biases and
    norms (no decay, half the rate)."""
    plain = [p for n, p in named if n.endswith("weight") and "norm" not in n]
    rest = [p for n, p in named if not (n.endswith("weight")
                                        and "norm" not in n)]
    return [{"params": plain},
            {"params": rest, "weight_decay": 0.0, "learning_rate": 0.5}]


def _schedule(lr_module):
    return lr_module.LinearWarmup(
        lr_module.PolynomialDecay(LR, decay_steps=10, end_lr=LR / 10),
        warmup_steps=2, start_lr=0.0, end_lr=LR)


def _jax_finetune(bf16):
    pt.seed(0)
    jm = JaxBertCls(JaxBertConfig(**TINY), num_classes=2)
    weights = _arrays(jm)
    sched = _schedule(jlr)
    jopt = pt.optimizer.AdamW(
        learning_rate=sched, weight_decay=0.1,
        parameters=_groups(list(jm.named_parameters())),
        apply_decay_param_fun=_decay_fun)
    if bf16:
        jm, jopt = pt.amp.decorate(models=jm, optimizers=jopt,
                                   dtype="bfloat16", master_weight=False)

    def loss_fn(m, ids, seg, mask, y):
        return JF.cross_entropy(m(ids, seg, attention_mask=mask), y,
                                reduction="mean")

    step = pt.jit.train_step(jm, loss_fn, jopt)
    ids, seg, mask, y = _batch(3)
    losses = []
    for _ in range(STEPS):
        losses.append(float(step(_jt(ids), _jt(seg), _jt(mask), _jt(y))))
        sched.step()
    final = {n: np.asarray(p.astype("float32"))
             for n, p in jm.state_dict().items()}
    return weights, losses, final


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_finetune(request):
    return request.param, _jax_finetune(request.param == "bfloat16")


def _port_finetune(weights, bf16):
    tm = BertForSequenceClassification(BertConfig(**TINY), num_classes=2,
                                       device="cpu")
    load_paddle_tpu_state(tm, weights)
    sched = _schedule(tlr)
    opt = optimizer.AdamW(learning_rate=sched, weight_decay=0.1,
                          parameters=_groups(list(tm.named_parameters())),
                          apply_decay_param_fun=_decay_fun)
    if bf16:
        tm, opt = amp.decorate(models=tm, optimizers=opt, dtype="bfloat16",
                               master_weight=False)

    def loss_fn(m, ids, seg, mask, y):
        return PF.cross_entropy(m(ids, seg, attention_mask=mask), y,
                                reduction="mean")

    step = train_step(tm, loss_fn, opt)
    ids, seg, mask, y = (_tt(x) for x in _batch(3))
    losses, rates = [], []
    for _ in range(STEPS):
        rates.append(opt.get_lr())
        losses.append(float(step(ids, seg, mask, y)))
        sched.step()
    return tm, opt, losses, rates


def test_finetune_loss_series_matches_jax(jax_finetune):
    dtype, (weights, jlosses, final) = jax_finetune
    tm, opt, losses, rates = _port_finetune(weights, dtype == "bfloat16")
    assert rates == pytest.approx([0.0, LR / 2, LR])
    assert opt._step_count == STEPS
    if dtype == "bfloat16":
        assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
        np.testing.assert_allclose(losses, jlosses, rtol=0,
                                   atol=BF16_LOSS_ATOL)
        return
    np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for n, p in tm.named_parameters():
        if n.endswith("k_proj.bias"):
            # its gradient is zero in exact arithmetic (it shifts every
            # score of a row alike, which the softmax ignores), so each
            # side moves it by rounding noise alone
            continue
        want = final[n].T if n in linear else final[n]
        np.testing.assert_allclose(p.detach().numpy(), want, err_msg=n,
                                   rtol=1e-4, atol=1e-3 * LR * STEPS)


def test_parameter_groups_scale_the_rate_and_override_the_decay():
    """With zero grads AdamW moves a parameter by its decay alone: lr x
    coefficient x wd x p.  Group one takes the global rate and decay
    (0.1), group two half the rate and its own decay (0.2); a name that
    apply_decay_param_fun refuses does not move."""
    tm = BertForSequenceClassification(BertConfig(**TINY), num_classes=2,
                                       device="cpu")
    named = list(tm.named_parameters())
    groups = _groups(named)
    groups[1]["weight_decay"] = 0.2
    opt = optimizer.AdamW(learning_rate=LR, weight_decay=0.1,
                          parameters=groups, apply_decay_param_fun=_decay_fun)
    names = {id(p): n for n, p in named}
    opt._param_names = [names[id(p)] for p in opt._parameters]
    before = {n: p.detach().clone() for n, p in named}
    for p in tm.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    second = {id(p) for p in groups[1]["params"]}
    for n, p in named:
        shrink = (LR * 0.5 * 0.2 if id(p) in second else LR * 0.1) \
            if _decay_fun(n) else 0.0
        torch.testing.assert_close(p.detach(), before[n] * (1 - shrink),
                                   rtol=1e-6, atol=0, msg=n)
