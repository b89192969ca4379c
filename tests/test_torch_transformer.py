"""The port's transformer encoder layers against the JAX package's, on the CPU.

`MultiHeadAttention`, `TransformerEncoderLayer` (post- and pre-norm, relu
and gelu, with and without BERT's additive key-padding mask [b, 1, 1, s])
and `TransformerEncoder` are built in the JAX package from a seed, their
weights carried into the port (`load_paddle_tpu_state`), and both run on
the same inputs made with numpy, in float32 and in bfloat16 (AMP O2 on
both sides).  One case runs the JAX side with its Pallas flash kernels
in interpret mode (`PADDLE_TPU_PALLAS=interpret`).

Tolerances.  float32: both sides compute the same formulas in float32,
summed in another order: rtol 1e-5, atol 1e-5.  bfloat16: the two round
at other places (torch's LayerNorm and GELU compute in float32 inside one
kernel and round once; the JAX ops round between steps), so outputs of
magnitude below 8 may differ by 2 units in the last place of bfloat16 at
that scale: atol 2 * 2**-5 = 0.0625 (measured: up to 0.03125).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.weights import load_paddle_tpu_state

B, S, E, H, F = 2, 12, 32, 4, 64
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0, atol=0.0625)


def _np32(t):
    return np.asarray(t._array.astype(jnp.float32))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    m = np.ones((B, S), np.float32)
    m[0, 8:] = 0.0
    m[1, 11:] = 0.0
    return x, ((1.0 - m) * -1e4)[:, None, None, :].astype(np.float32)


def _carry(jax_layer, port_layer, dtype):
    """Weights from JAX into the port, both evaluated in `dtype`."""
    jax_layer.eval()
    load_paddle_tpu_state(port_layer, {k: np.asarray(v) for k, v in
                                       jax_layer.state_dict().items()})
    port_layer.eval()
    if dtype == "bfloat16":
        jax_layer = pt.amp.decorate(models=jax_layer, dtype="bfloat16")
        amp.decorate(models=port_layer, dtype="bfloat16")
    return jax_layer, port_layer


def _run(jax_layer, port_layer, dtype, *arrays):
    jargs = [None if a is None else pt.to_tensor(a).astype(dtype)
             for a in arrays]
    targs = [None if a is None else torch.from_numpy(a).to(
        getattr(torch, dtype)) for a in arrays]
    with torch.no_grad():
        return _np32(jax_layer(*jargs)), port_layer(*targs).float().numpy()


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_matches_jax(masked, dtype):
    pt.seed(1)
    jl, tl = _carry(pt.nn.MultiHeadAttention(E, H), tnn.MultiHeadAttention(
        E, H, device="cpu"), dtype)
    x, mask = _inputs()
    jo, to = _run(jl, tl, dtype, x, None, None, mask if masked else None)
    np.testing.assert_allclose(to, jo, **_tol(dtype))


def test_multi_head_attention_caches_match_jax():
    """A concat Cache grows by the step's keys; a StaticCache holds the
    projected memory, the same on both sides."""
    pt.seed(2)
    jl, tl = _carry(pt.nn.MultiHeadAttention(E, H), tnn.MultiHeadAttention(
        E, H, device="cpu"), "float32")
    x, _ = _inputs()
    jx, tx = pt.to_tensor(x), torch.from_numpy(x)
    with torch.no_grad():
        jo, jc = jl(jx[:, :5], cache=jl.gen_cache(jx))
        to, tc = tl(tx[:, :5], cache=tl.gen_cache(tx))
        assert tuple(tc.k.shape) == (B, 5, H, E // H)
        np.testing.assert_allclose(to.numpy(), _np32(jo), **F32_TOL)
        np.testing.assert_allclose(tc.v.numpy(), _np32(jc.v), **F32_TOL)
        js = jl.gen_cache(jx, type=jl.StaticCache)
        ts = tl.gen_cache(tx, type=tl.StaticCache)
        jo, _ = jl(jx[:, :3], cache=js)
        to, _ = tl(tx[:, :3], cache=ts)
    np.testing.assert_allclose(to.numpy(), _np32(jo), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_matches_jax(normalize_before, activation, masked,
                                   dtype):
    pt.seed(3)
    kw = dict(dropout=0.0, activation=activation,
              normalize_before=normalize_before)
    jl, tl = _carry(pt.nn.TransformerEncoderLayer(E, H, F, **kw),
                    tnn.TransformerEncoderLayer(E, H, F, device="cpu",
                                                **kw), dtype)
    x, mask = _inputs()
    jo, to = _run(jl, tl, dtype, x, mask if masked else None)
    np.testing.assert_allclose(to, jo, **_tol(dtype))


def test_encoder_layer_matches_jax_on_its_pallas_kernels(monkeypatch):
    """The JAX layer's attention through its Pallas flash kernels
    (interpret mode on the CPU), under the key-padding mask."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
    pt.seed(4)
    kw = dict(dropout=0.0, activation="gelu")
    jl, tl = _carry(pt.nn.TransformerEncoderLayer(E, H, F, **kw),
                    tnn.TransformerEncoderLayer(E, H, F, device="cpu",
                                                **kw), "float32")
    x, mask = _inputs(1)
    jo, to = _run(jl, tl, "float32", x, mask)
    np.testing.assert_allclose(to, jo, **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax_and_copies_its_first_layer(dtype):
    """Every layer starts as a deep copy of the first (the JAX quirk), so
    all layers hold the same weights; the stack with a final norm runs as
    the JAX one does."""
    pt.seed(5)
    kw = dict(dropout=0.0, activation="gelu")
    jenc = pt.nn.TransformerEncoder(pt.nn.TransformerEncoderLayer(
        E, H, F, **kw), 3, norm=pt.nn.LayerNorm(E))
    tenc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        E, H, F, device="cpu", **kw),
                                  3, norm=torch.nn.LayerNorm(E, eps=1e-5))
    first = tenc.layers[0].state_dict()
    for layer in tenc.layers[1:]:
        for k, v in layer.state_dict().items():
            assert torch.equal(v, first[k]), k
        assert layer.linear1.weight is not tenc.layers[0].linear1.weight
    jenc, tenc = _carry(jenc, tenc, dtype)
    x, mask = _inputs(2)
    jo, to = _run(jenc, tenc, dtype, x, mask)
    np.testing.assert_allclose(to, jo, **_tol(dtype))


def test_encoder_layer_dropout_and_activation_names():
    """attn_dropout / act_dropout default to dropout; the activation is
    looked up by name in the port's functional module; dropout acts in
    training only."""
    layer = tnn.TransformerEncoderLayer(E, H, F, dropout=0.3, device="cpu",
                                        activation="relu", act_dropout=0.5)
    assert layer.self_attn.dropout == 0.3 and layer.act_dropout.p == 0.5
    assert layer.activation is tnn.functional.relu
    x = torch.from_numpy(_inputs()[0])
    layer.eval()
    assert torch.equal(layer(x), layer(x))
    layer.train()
    assert not torch.equal(layer(x), layer(x))
    with pytest.raises(ValueError):
        tnn.MultiHeadAttention(30, 4, device="cpu")
