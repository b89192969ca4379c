"""Recurrent layers (counterpart: `paddle_tpu/nn/rnn.py`).

`SimpleRNN`, `LSTM` and `GRU` hold, for each layer l and direction, the
JAX package's parameters `weight_ih_l{l}[_reverse]` [gates * H, in],
`weight_hh_l{l}` [gates * H, H] and the two biases [gates * H], all
drawn from U(-1/sqrt(H), 1/sqrt(H)); the layout is torch's too, so
`weights.load_paddle_tpu_state` copies them as they are.  LSTM's gates
split i, f, g, o; GRU's r, z, n, with the reset gate applied to the
hidden product (n = tanh(W_in x + b_in + r * (W_hn h + b_hn))).  The
time loop is a Python loop of torch ops (the JAX package scans it in one
XLA while-loop).  Inputs are [B, T, C] (time_major: [T, B, C]);
`sequence_length` and `dropout` are taken and unused, as in the JAX
package.
"""
from __future__ import annotations

import math

import torch

from . import initializer as I
from .common import _kw
from .layer import Layer


def _lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    gates = x @ w_ih.t() + b_ih + h @ w_hh.t() + b_hh
    i, f, g, o = gates.chunk(4, -1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c2), c2


def _gru_cell(x, h, w_ih, w_hh, b_ih, b_hh):
    ir, iz, in_ = (x @ w_ih.t() + b_ih).chunk(3, -1)
    hr, hz, hn = (h @ w_hh.t() + b_hh).chunk(3, -1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1.0 - z) * n + z * h


def _activation(name):
    return torch.tanh if name == "tanh" else torch.relu


class _CellParams(Layer):
    """weight_ih [g * H, in], weight_hh [g * H, H], bias_ih, bias_hh."""

    GATES = 1

    def __init__(self, input_size, hidden_size, device=None, dtype=None,
                 generator=None):
        super().__init__(**_kw(device, dtype, generator))
        self.input_size = input_size
        self.hidden_size = hidden_size
        g, std = self.GATES * hidden_size, 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-std, std)
        self.weight_ih = self.create_parameter([g, input_size],
                                               default_initializer=init)
        self.weight_hh = self.create_parameter([g, hidden_size],
                                               default_initializer=init)
        self.bias_ih = self.create_parameter([g], default_initializer=init)
        self.bias_hh = self.create_parameter([g], default_initializer=init)

    def _zeros(self, x):
        return x.new_zeros(x.shape[0], self.hidden_size)

    def _params(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)


class SimpleRNNCell(_CellParams):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 device=None, dtype=None, generator=None):
        super().__init__(input_size, hidden_size, device, dtype, generator)
        self.activation = activation

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        w_ih, w_hh, b_ih, b_hh = self._params()
        h2 = _activation(self.activation)(
            inputs @ w_ih.t() + b_ih + h @ w_hh.t() + b_hh)
        return h2, h2


class LSTMCell(_CellParams):
    GATES = 4

    def __init__(self, input_size, hidden_size, device=None, dtype=None,
                 generator=None):
        super().__init__(input_size, hidden_size, device, dtype, generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = (self._zeros(inputs), self._zeros(inputs))
        h2, c2 = _lstm_cell(inputs, *states, *self._params())
        return h2, (h2, c2)


class GRUCell(_CellParams):
    GATES = 3

    def __init__(self, input_size, hidden_size, device=None, dtype=None,
                 generator=None):
        super().__init__(input_size, hidden_size, device, dtype, generator)

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        h2 = _gru_cell(inputs, h, *self._params())
        return h2, h2


class _RNNBase(Layer):
    MODE = "RNN_TANH"
    GATES = 1

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, device=None,
                 dtype=None, generator=None):
        super().__init__(**_kw(device, dtype, generator))
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        g = self.GATES * hidden_size
        init = I.Uniform(-1.0 / math.sqrt(hidden_size),
                         1.0 / math.sqrt(hidden_size))
        for l in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if l == 0 else \
                    hidden_size * self.num_directions
                sfx = self._suffix(l, d)
                for name, shape in (("weight_ih", [g, in_sz]),
                                    ("weight_hh", [g, hidden_size]),
                                    ("bias_ih", [g]), ("bias_hh", [g])):
                    self.add_parameter(name + sfx, self.create_parameter(
                        shape, default_initializer=init))

    @staticmethod
    def _suffix(l, d):
        return f"_l{l}" + ("_reverse" if d else "")

    def _step(self, x, h, c, params):
        raise NotImplementedError

    def forward(self, inputs, initial_states=None, sequence_length=None):
        has_cell = self.MODE == "LSTM"
        x = inputs.transpose(0, 1) if self.time_major else inputs
        L, ND, H = self.num_layers, self.num_directions, self.hidden_size
        if initial_states is None:
            h0 = x.new_zeros(L * ND, x.shape[0], H)
            c0 = h0
        elif has_cell:
            h0, c0 = initial_states
        else:
            h0, c0 = initial_states, None
        last_h, last_c = [], []
        for l in range(L):
            outs = []
            for d in range(ND):
                sfx = self._suffix(l, d)
                params = [getattr(self, p + sfx) for p in
                          ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
                h = h0[l * ND + d]
                c = c0[l * ND + d] if has_cell else None
                steps = range(x.shape[1] - 1, -1, -1) if d else \
                    range(x.shape[1])
                ys = [None] * x.shape[1]
                for t in steps:
                    h, c = self._step(x[:, t], h, c, params)
                    ys[t] = h
                outs.append(torch.stack(ys, 1))
                last_h.append(h)
                last_c.append(c)
            x = torch.cat(outs, -1) if ND == 2 else outs[0]
        out = x.transpose(0, 1) if self.time_major else x
        hs = torch.stack(last_h, 0)
        if has_cell:
            return out, (hs, torch.stack(last_c, 0))
        return out, hs


class SimpleRNN(_RNNBase):
    MODE = "RNN_TANH"
    GATES = 1

    def __init__(self, *args, activation="tanh", **kwargs):
        self._act = _activation(activation)
        super().__init__(*args, **kwargs)

    def _step(self, x, h, c, params):
        w_ih, w_hh, b_ih, b_hh = params
        return self._act(x @ w_ih.t() + b_ih + h @ w_hh.t() + b_hh), c


class LSTM(_RNNBase):
    MODE = "LSTM"
    GATES = 4

    def _step(self, x, h, c, params):
        return _lstm_cell(x, h, c, *params)


class GRU(_RNNBase):
    MODE = "GRU"
    GATES = 3

    def _step(self, x, h, c, params):
        return _gru_cell(x, h, *params), c


class BiRNN(Layer):
    """Two cells over the sequence, forward and backward: outputs
    concatenated on the feature axis, states (forward, backward)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major

    @staticmethod
    def _scan(cell, x, state, reverse):
        steps = range(x.shape[1] - 1, -1, -1) if reverse \
            else range(x.shape[1])
        outs = [None] * x.shape[1]
        for t in steps:
            outs[t], state = cell(x[:, t], state)
        return torch.stack(outs, 1), state

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        sf = sb = None
        if initial_states is not None:
            sf, sb = initial_states
        of, sf = self._scan(self.cell_fw, x, sf, reverse=False)
        ob, sb = self._scan(self.cell_bw, x, sb, reverse=True)
        out = torch.cat([of, ob], -1)
        if self.time_major:
            out = out.transpose(0, 1)
        return out, (sf, sb)
