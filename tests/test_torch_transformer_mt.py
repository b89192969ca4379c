"""The decoder half of the port's `nn.Transformer` and the MT model
(`text.TransformerModel`) against the JAX package's, on the CPU.

Small size: d_model 32, 4 heads, 2 + 2 layers, d_inner 64, vocabulary 50,
dropout 0.  The JAX model is built from a seed, its weights carried into
the port (`load_paddle_tpu_state`; the tied embedding is listed once,
the non-persistable `pos_table` not at all), and both run on the same
token ids made with numpy.  One case runs the JAX side with its Pallas
flash kernels in interpret mode (`PADDLE_TPU_PALLAS=interpret`).

Tolerances.  float32: rtol 1e-5, atol 1e-5, as `test_torch_transformer.py`
(the same formulas summed in another order).  The Adam step: atol 1e-3
x the rate (Adam normalises each update to about the rate, so rounding
in a near-zero gradient moves a weight by up to the rate; the key
projections' biases, whose gradient is zero in exact arithmetic, are left
out).  AMP O1 bf16 losses: rtol 1e-2 (the two round the bf16 products at
other places; measured below 2e-3).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.text.transformer_mt import TransformerModel as JaxMT
from paddle_tpu.text.transformer_mt import transformer_mt_loss as jax_loss
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.text import (TransformerModel, sinusoidal_positions,
                                   transformer_mt_loss)
from paddle_tpu_torch.weights import (load_paddle_tpu_optimizer_state,
                                      load_paddle_tpu_state)

TOL = dict(rtol=1e-5, atol=1e-5)
V, D, H, FF, L, MAXLEN, PAD = 50, 32, 4, 64, 2, 32, 2
CFG = dict(src_vocab_size=V, trg_vocab_size=V, max_length=MAXLEN,
           d_model=D, n_head=H, num_encoder_layers=L, num_decoder_layers=L,
           d_inner_hid=FF, dropout=0.0)
LR = 1e-3


def _state(jax_layer):
    return {k: np.asarray(v) for k, v in jax_layer.state_dict().items()}


def _pair(tied, seed=0):
    pt.seed(seed)
    jm = JaxMT(**CFG, weight_sharing=tied)
    tm = TransformerModel(**CFG, weight_sharing=tied, device="cpu")
    load_paddle_tpu_state(tm, _state(jm))
    return jm, tm


def _batch(seed=0, b=3, s=10, t=9):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, V, (b, s))
    src[0, 6:] = PAD
    src[2, 8:] = PAD
    trg = rng.integers(3, V, (b, t))
    trg[:, 0] = 0
    return src, trg


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ----------------------------------------------------------- decoder half
def _masks(b=2, s=7, m=9):
    causal = np.triu(np.full((s, s), -1e9, np.float32), 1)[None, None]
    pad = np.zeros((b, 1, 1, m), np.float32)
    pad[0, ..., 6:] = -1e9
    return causal, pad


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer_matches_jax(normalize_before, masked):
    pt.seed(1)
    kw = dict(dropout=0.0, normalize_before=normalize_before)
    jl = pt.nn.TransformerDecoderLayer(D, H, FF, **kw)
    tl = tnn.TransformerDecoderLayer(D, H, FF, device="cpu", **kw)
    load_paddle_tpu_state(tl, _state(jl))
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((2, 7, D)).astype(np.float32)
    mem = rng.standard_normal((2, 9, D)).astype(np.float32)
    causal, pad = _masks()
    masks = (causal, pad) if masked else (None, None)
    jo = jl(pt.to_tensor(tgt), pt.to_tensor(mem),
            *[None if m is None else pt.to_tensor(m) for m in masks])
    with torch.no_grad():
        to = tl(_t(tgt), _t(mem), *[None if m is None else _t(m)
                                    for m in masks])
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)


def test_decoder_cache_equals_the_full_pass_and_jax():
    """Step by step through gen_cache (a concat Cache per layer and the
    memory's StaticCache) equals the causal full pass, on both sides."""
    pt.seed(2)
    jd = pt.nn.TransformerDecoder(pt.nn.TransformerDecoderLayer(
        D, H, FF, dropout=0.0, normalize_before=True), L)
    td = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
        D, H, FF, dropout=0.0, normalize_before=True, device="cpu"), L)
    load_paddle_tpu_state(td, _state(jd))
    rng = np.random.default_rng(2)
    tgt = rng.standard_normal((2, 5, D)).astype(np.float32)
    mem = rng.standard_normal((2, 9, D)).astype(np.float32)
    causal, pad = _masks(s=5)
    with torch.no_grad():
        full = td(_t(tgt), _t(mem), _t(causal), _t(pad)).numpy()
        caches, steps = td.gen_cache(_t(mem)), []
        for i in range(5):
            out, caches = td(_t(tgt[:, i:i + 1]), _t(mem), None, _t(pad),
                             cache=caches)
            steps.append(out.numpy())
    assert tuple(caches[0][0].k.shape) == (2, 5, H, D // H)
    np.testing.assert_allclose(np.concatenate(steps, 1), full, **TOL)
    jfull = jd(pt.to_tensor(tgt), pt.to_tensor(mem), pt.to_tensor(causal),
               pt.to_tensor(pad))
    np.testing.assert_allclose(full, jfull.numpy(), **TOL)


def test_transformer_matches_jax_without_final_norms():
    """The JAX quirk: no final norm after the encoder or the decoder, also
    under normalize_before."""
    pt.seed(3)
    kw = dict(d_model=D, nhead=H, num_encoder_layers=L,
              num_decoder_layers=L, dim_feedforward=FF, dropout=0.0,
              normalize_before=True)
    jt = pt.nn.Transformer(**kw)
    tt = tnn.Transformer(**kw, device="cpu")
    assert tt.encoder.norm is None and tt.decoder.norm is None
    load_paddle_tpu_state(tt, _state(jt))
    rng = np.random.default_rng(3)
    src = rng.standard_normal((2, 9, D)).astype(np.float32)
    tgt = rng.standard_normal((2, 7, D)).astype(np.float32)
    causal, pad = _masks()
    jo = jt(*[pt.to_tensor(a) for a in (src, tgt)], pt.to_tensor(pad),
            pt.to_tensor(causal), pt.to_tensor(pad))
    with torch.no_grad():
        to = tt(_t(src), _t(tgt), _t(pad), _t(causal), _t(pad))
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)


# ---------------------------------------------------------------- the model
def test_sinusoidal_positions_equal_jax():
    from paddle_tpu.text.transformer_mt import sinusoidal_positions as jsp
    for shape in ((16, 32), (7, 9)):
        np.testing.assert_array_equal(sinusoidal_positions(*shape),
                                      jsp(*shape))


@pytest.mark.parametrize("tied", [False, True])
def test_state_lists_the_tied_embedding_once_and_no_positions(tied):
    jm, tm = _pair(tied)
    names = set(_state(jm))
    assert "pos_table" not in names and "pos_table" not in tm.state_dict()
    assert ("trg_embed.weight" in names) == (not tied)
    assert "trg_embed.weight" in tm.state_dict()   # torch lists both names
    assert tm.trg_embed.weight is tm.src_embed.weight if tied else \
        tm.trg_embed.weight is not tm.src_embed.weight


@pytest.mark.parametrize("pad", [None, PAD])
@pytest.mark.parametrize("tied", [False, True])
def test_logits_match_jax(tied, pad):
    jm, tm = _pair(tied)
    src, trg = _batch()
    jo = jm(pt.to_tensor(src), pt.to_tensor(trg), src_pad_id=pad)
    with torch.no_grad():
        to = tm(_t(src), _t(trg), src_pad_id=pad)
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)


def test_logits_match_jax_on_its_pallas_kernels(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
    jm, tm = _pair(True, seed=4)
    src, trg = _batch(4)
    jo = jm(pt.to_tensor(src), pt.to_tensor(trg), src_pad_id=PAD)
    with torch.no_grad():
        to = tm(_t(src), _t(trg), src_pad_id=PAD)
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("pad", [None, PAD])
def test_label_smoothed_loss_matches_jax(pad, eps):
    """The mean runs over the targets that are not `pad`."""
    jm, tm = _pair(True)
    src, trg = _batch(5)
    trg[1, 6:] = PAD
    jl = jax_loss(jm, pt.to_tensor(src), pt.to_tensor(trg), eps, pad)
    with torch.no_grad():
        tl = transformer_mt_loss(tm, _t(src), _t(trg), eps, pad)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


def test_loss_under_amp_o1_matches_jax():
    jm, tm = _pair(True, seed=6)
    src, trg = _batch(6)
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        jl = float(jax_loss(jm, pt.to_tensor(src), pt.to_tensor(trg), 0.1,
                            PAD))
    with torch.no_grad(), amp.auto_cast(level="O1", dtype="bfloat16"):
        tl = float(transformer_mt_loss(tm, _t(src), _t(trg), 0.1, PAD))
    np.testing.assert_allclose(tl, jl, rtol=1e-2)


def _jax_adam(params):
    return pt.optimizer.Adam(learning_rate=LR, beta1=0.9, beta2=0.98,
                             epsilon=1e-9, parameters=params)


def _port_adam(params):
    return Adam(learning_rate=LR, beta1=0.9, beta2=0.98, epsilon=1e-9,
                parameters=params)


def _assert_params_match(tm, jm):
    arrays = _state(jm)
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for n, p in tm.named_parameters():
        if n.endswith("k_proj.bias"):
            continue
        want = arrays[n].T if n in linear else arrays[n]
        np.testing.assert_allclose(p.detach().numpy(), want, err_msg=n,
                                   rtol=1e-4, atol=1e-3 * LR)


@pytest.mark.parametrize("tied", [False, True])
def test_adam_steps_and_optimizer_state_match_jax(tied):
    """One TrainStep of Adam (beta2 0.98, eps 1e-9) on both sides, then the
    JAX optimizer state carried into the port and a second step on each."""
    jm, tm = _pair(tied, seed=7)
    src, trg = _batch(7)

    def jloss(m, s, t):
        return jax_loss(m, s, t, 0.1, PAD)

    def tloss(m, s, t):
        return transformer_mt_loss(m, s, t, 0.1, PAD)

    jstep = pt.jit.train_step(jm, jloss, _jax_adam(jm.parameters()))
    tstep = train_step(tm, tloss, _port_adam(tm.parameters()))
    jb, tb = (pt.to_tensor(src), pt.to_tensor(trg)), (_t(src), _t(trg))
    np.testing.assert_allclose(float(tstep(*tb)), float(jstep(*jb)), **TOL)
    _assert_params_match(tm, jm)
    # a fresh port model and optimizer from the JAX weights and slots
    fresh = TransformerModel(**CFG, weight_sharing=tied, device="cpu")
    load_paddle_tpu_state(fresh, _state(jm))
    names = [n for n, _ in jm.named_parameters()]
    opt = _port_adam(fresh.parameters())
    load_paddle_tpu_optimizer_state(opt, fresh, dict(
        {n: {s: np.asarray(a) for s, a in slots.items()}
         for n, slots in zip(names, jstep._opt_state)}, step=jstep._step))
    fstep = train_step(fresh, tloss, opt)
    np.testing.assert_allclose(float(fstep(*tb)), float(jstep(*jb)),
                               **TOL)
    _assert_params_match(fresh, jm)


@pytest.mark.parametrize("tied", [False, True])
def test_generate_matches_jax_and_a_full_prefix_rerun(tied):
    """Greedy tokens equal the JAX model's; each cached step's token is
    the argmax of a full-prefix forward of the port."""
    jm, tm = _pair(tied, seed=8)
    src, _ = _batch(8)
    jout = jm.generate(pt.to_tensor(src), max_length=8, src_pad_id=PAD)
    tout = tm.generate(_t(src), max_length=8, src_pad_id=PAD)
    np.testing.assert_array_equal(tout.numpy(), jout.numpy())
    with torch.no_grad():
        for i in range(1, tout.shape[1]):
            logits = tm(_t(src), tout[:, :i], src_pad_id=PAD)
            np.testing.assert_array_equal(
                logits[:, -1].argmax(-1).numpy(), tout[:, i].numpy())
    assert tm.training                       # generate leaves it as found


def test_generate_stops_when_every_row_ended_and_checks_the_table():
    _, tm = _pair(False, seed=9)
    with torch.no_grad():                     # every step picks eos (1)
        tm.generator.bias[1] = 1e4
    src, _ = _batch(9)
    out = tm.generate(_t(src), max_length=10, src_pad_id=PAD)
    assert out.shape == (3, 2) and bool((out[:, 1] == 1).all())
    with pytest.raises(ValueError, match="positional table"):
        tm.generate(_t(src), max_length=MAXLEN + 1)
    with pytest.raises(ValueError, match="max_length"):
        tm(_t(src), _t(np.zeros((3, MAXLEN + 1), np.int64)))
