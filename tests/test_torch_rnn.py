"""The port's recurrent layers (`nn/rnn.py`: SimpleRNN, LSTM, GRU, their
cells, BiRNN; `nn/extras_r3.py`: RNN over a cell, RNNCellBase,
BeamSearchDecoder, SpectralNorm) against the JAX package's, on the CPU.

The JAX layers are built from a seed and their weights carried into the
port (`load_paddle_tpu_state` copies the [gates * H, in] weights as they
are); both run on the same numpy inputs: outputs, final states and the
input's gradient.

Tolerances.  float32: rtol 1e-5, atol 1e-5 (the same gate formulas, the
time loop a Python loop here and a scan there).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.weights import load_paddle_tpu_state

TOL = dict(rtol=1e-5, atol=1e-5)
IN, HID, B, T = 5, 6, 3, 7


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _state(jax_layer):
    return {k: np.asarray(v) for k, v in jax_layer.state_dict().items()}


def _pair(build, seed=0):
    pt.seed(seed)
    jl = build(pt.nn, {})
    tl = build(tnn, {"device": "cpu"})
    load_paddle_tpu_state(tl, _state(jl))
    return jl, tl


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _close(to, jo):
    for a, b in zip(_flat(to), _flat(jo)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
def test_rnn_matches_jax(cls, direction, time_major):
    jl, tl = _pair(lambda nn, kw: getattr(nn, cls)(
        IN, HID, num_layers=2, direction=direction, time_major=time_major,
        **kw))
    shape = (T, B, IN) if time_major else (B, T, IN)
    x = _x(*shape)
    jx = pt.to_tensor(x)
    jx.stop_gradient = False
    tx = torch.from_numpy(x).requires_grad_()
    jo, to = jl(jx), tl(tx)
    _close(to, jo)
    jo[0].sum().backward()
    to[0].sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL)


@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
def test_rnn_takes_initial_states_like_jax(cls):
    jl, tl = _pair(lambda nn, kw: getattr(nn, cls)(IN, HID, **kw))
    h0 = _x(1, B, HID, seed=1)
    init = (h0, _x(1, B, HID, seed=2)) if cls == "LSTM" else h0

    def wrap(a, f):
        return tuple(map(f, a)) if isinstance(a, tuple) else f(a)
    x = _x(B, T, IN)
    jo = jl(pt.to_tensor(x), wrap(init, pt.to_tensor))
    with torch.no_grad():
        to = tl(torch.from_numpy(x), wrap(init, torch.from_numpy))
    _close(to, jo)


def test_simple_rnn_relu_and_gate_layout():
    jl, tl = _pair(lambda nn, kw: nn.SimpleRNN(IN, HID, activation="relu",
                                               **kw))
    x = _x(B, T, IN)
    with torch.no_grad():
        _close(tl(torch.from_numpy(x)), jl(pt.to_tensor(x)))
    lstm = tnn.LSTM(IN, HID, device="cpu")
    assert tuple(lstm.weight_ih_l0.shape) == (4 * HID, IN)
    assert tuple(tnn.GRU(IN, HID, device="cpu").weight_hh_l0.shape) == \
        (3 * HID, HID)


@pytest.mark.parametrize("cls", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_cells_match_jax(cls):
    jl, tl = _pair(lambda nn, kw: getattr(nn, cls)(IN, HID, **kw))
    x = _x(B, IN)
    with torch.no_grad():
        _close(tl(torch.from_numpy(x)), jl(pt.to_tensor(x)))
        h = _x(B, HID, seed=1)
        state = (h, _x(B, HID, seed=2)) if cls == "LSTMCell" else h
        jstate = tuple(map(pt.to_tensor, state)) if cls == "LSTMCell" \
            else pt.to_tensor(state)
        tstate = tuple(map(torch.from_numpy, state)) if cls == "LSTMCell" \
            else torch.from_numpy(state)
        _close(tl(torch.from_numpy(x), tstate), jl(pt.to_tensor(x), jstate))


@pytest.mark.parametrize("time_major", [False, True])
def test_birnn_and_rnn_over_cells_match_jax(time_major):
    def build(nn, kw):
        return nn.LayerList([nn.BiRNN(nn.GRUCell(IN, HID, **kw),
                                      nn.GRUCell(IN, HID, **kw),
                                      time_major=time_major),
                             nn.RNN(nn.SimpleRNNCell(IN, HID, **kw),
                                    is_reverse=True,
                                    time_major=time_major)])
    jl, tl = _pair(build)
    x = _x(T, B, IN) if time_major else _x(B, T, IN)
    h = _x(B, HID, seed=3)
    with torch.no_grad():
        _close(tl[0](torch.from_numpy(x)), jl[0](pt.to_tensor(x)))
        _close(tl[1](torch.from_numpy(x), torch.from_numpy(h)),
               jl[1](pt.to_tensor(x), pt.to_tensor(h)))


def test_cell_base_initial_states_and_rnn_default_state():
    class Cell(tnn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.hidden_size = HID
            self.lin = tnn.Linear(IN + HID, HID, device="cpu")

        def forward(self, x, h):
            h = torch.tanh(self.lin(torch.cat([x, h], -1)))
            return h, h

    cell = Cell()
    x = torch.from_numpy(_x(B, T, IN))
    h0 = cell.get_initial_states(x[:, 0])
    assert h0.shape == (B, HID) and not h0.any()
    out, h = tnn.RNN(cell)(x)
    assert out.shape == (B, T, HID)
    torch.testing.assert_close(out[:, -1], h)


def test_spectral_norm_layer_matches_jax_from_the_same_vectors():
    pt.seed(4)
    jl = pt.nn.SpectralNorm([4, 3, 2], dim=1, power_iters=3)
    tl = tnn.SpectralNorm([4, 3, 2], dim=1, power_iters=3, device="cpu")
    load_paddle_tpu_state(tl, _state(jl))
    w = _x(4, 3, 2)
    _close(tl(torch.from_numpy(w)), jl(pt.to_tensor(w)))


def test_beam_search_decoder_matches_jax():
    """gather_tree over the beam's ids and parents, scores summed."""
    def build(nn, kw):
        return nn.LayerList([nn.GRUCell(4, HID, **kw),
                             nn.Embedding(9, 4, **kw),
                             nn.Linear(HID, 9, **kw)])
    jl, tl = _pair(build, seed=5)
    h = _x(2 * 3, HID, seed=6)
    jd = pt.nn.BeamSearchDecoder(jl[0], 0, 1, 3, embedding_fn=jl[1],
                                 output_fn=jl[2])
    td = tnn.BeamSearchDecoder(tl[0], 0, 1, 3, embedding_fn=tl[1],
                               output_fn=tl[2])
    with torch.no_grad():
        tids, tscores = td.decode(torch.from_numpy(h), 2, max_steps=5)
    jids, jscores = jd.decode(pt.to_tensor(h), 2, max_steps=5)
    np.testing.assert_array_equal(tids.numpy(), jids.numpy())
    np.testing.assert_allclose(tscores.numpy(), jscores.numpy(), **TOL)
