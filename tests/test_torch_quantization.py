"""The port's quantization (`paddle_tpu_torch.quantization`) against the
JAX package's (`paddle_tpu.quantization`), on the CPU.

The same seeded numpy inputs and weights (`load_paddle_tpu_state`) go
through both: `fake_quantize` and its straight-through gradient, a
`FakeQuanterWithAbsMax`'s moving scale, QAT's training steps (losses,
weights and every quanter's scale after each), `convert` (an
`Int8Linear`'s int8 weight, scales and output; a conv's folded weight),
PTQ's calibration and conversion, and `Int8Linear`'s int32 product at
shapes `torch._int_mm` takes only padded (M <= 16, K and N not multiples
of 8).  Then the cases of `tests/test_quantization.py` on the port.

Tolerances: the int8 weights and int32 products are exact (the same
rounding of the same float32 values); float outputs to 1e-5 relative
with a 1e-5 floor, training steps 1e-4 (summation order), and the
reference's own bounds where its cases state them.
"""
import numpy as np
import pytest
import torch

import torch_cpu_threads

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import quantization as JQ
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import quantization as Q
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import SGD, Adam
from paddle_tpu_torch.weights import load_paddle_tpu_state

torch_cpu_threads.limit()

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def cpu_place():
    """Quanters build on the current place: the CPU here, restored after."""
    before = tdevice._current_place[0]
    tdevice.set_device("cpu")
    yield
    tdevice._current_place[0] = before


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t._array)


def _state(jm):
    return {k: _np(v) for k, v in jm.state_dict().items()}


def _mlp(seed):
    pt.seed(seed)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tm = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.ReLU(),
                        tnn.Linear(16, 4, device="cpu"))
    load_paddle_tpu_state(tm, _state(jm))
    return jm, tm


def _data(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("scale", [1.0, 0.37])
def test_fake_quantize_values_and_ste_match_jax(scale):
    x, w = _data(0, (64,), (64,))
    x *= 0.6
    jx = pt.to_tensor(x)
    jx.stop_gradient = False
    jy = JQ.fake_quantize(jx, scale)
    (jy * pt.to_tensor(w)).sum().backward()
    tx = torch.tensor(x, requires_grad=True)
    ty = Q.fake_quantize(tx, scale)
    (ty * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_array_equal(tx.grad.numpy(), _np(jx.grad))
    assert 0 < (tx.grad == 0).sum() < 64          # clipped ones get none


def test_fake_quanter_moving_scale_matches_jax():
    jq, tq = JQ.FakeQuanterWithAbsMax(0.8), Q.FakeQuanterWithAbsMax(0.8)
    for i, (x,) in enumerate(_data(s, (5, 7)) for s in range(3)):
        x = x * (i + 1)
        np.testing.assert_allclose(_np(tq(torch.from_numpy(x))),
                                   _np(jq(pt.to_tensor(x))), **TOL)
        np.testing.assert_allclose(float(tq.scale), float(jq.scale._array),
                                   rtol=1e-6)
    jq.eval()
    tq.eval()
    x, = _data(7, (5, 7))
    np.testing.assert_allclose(_np(tq(torch.from_numpy(x))),
                               _np(jq(pt.to_tensor(x))), **TOL)


def test_qat_training_steps_match_jax():
    jm, tm = _mlp(0)
    jm, tm = JQ.QAT().quantize(jm), Q.QAT().quantize(tm)
    assert isinstance(tm[0], Q.QuantedLinear)
    jopt = pt.optimizer.SGD(learning_rate=0.05, parameters=jm.parameters())
    topt = SGD(learning_rate=0.05, parameters=tm.parameters())
    jstep = pt.jit.train_step(
        jm, lambda mm, a, b: JF.mse_loss(mm(a), b), jopt)
    tstep = train_step(tm, lambda mm, a, b: TF.mse_loss(mm(a), b), topt)
    x, y = _data(1, (16, 8), (16, 4))
    for _ in range(3):
        np.testing.assert_allclose(
            float(tstep(torch.from_numpy(x), torch.from_numpy(y))),
            float(jstep(pt.to_tensor(x), pt.to_tensor(y))), **STEP_TOL)
    js, ts = _state(jm), tm.state_dict()
    assert set(js) == set(ts)
    for k, v in js.items():
        got = _np(ts[k])
        got = got.T if k.endswith("inner.weight") else got
        np.testing.assert_allclose(got, v, **STEP_TOL, err_msg=k)


def test_qat_convert_matches_jax_and_carries_int8_weights():
    jm, tm = _mlp(1)
    jq, tq = JQ.QAT(), Q.QAT()
    jm, tm = jq.quantize(jm), tq.quantize(tm)
    x, = _data(2, (6, 8))
    jm.train()
    tm.train()
    jm(pt.to_tensor(x))
    tm(torch.from_numpy(x))
    jm.eval()
    tm.eval()
    ref = _np(tm(torch.from_numpy(x)))
    jc, tc = jq.convert(jm), tq.convert(tm)
    assert isinstance(tc[0], Q.Int8Linear) and isinstance(tc[2],
                                                          Q.Int8Linear)
    assert tc[0].w_int8.dtype == torch.int8
    assert tuple(tc[0].w_int8.shape) == (8, 16)            # [in, out]
    js = _state(jc)
    for k in ("0.w_int8", "2.w_int8"):
        np.testing.assert_array_equal(tc.state_dict()[k].numpy(), js[k])
    for k in ("0.w_scale", "0.act_scale", "2.w_scale", "2.act_scale"):
        np.testing.assert_allclose(float(tc.state_dict()[k]), float(js[k]),
                                   rtol=1e-6)
    out = _np(tc(torch.from_numpy(x)))
    np.testing.assert_allclose(out, _np(jc(pt.to_tensor(x))), **TOL)
    assert np.abs(out - ref).max() < 0.06
    # a converted JAX model's state carries into a converted port model
    _, other = _mlp(5)
    other = Q.QAT().quantize(other)
    other.train()
    other(torch.from_numpy(x))
    other = Q.QAT().convert(other)
    load_paddle_tpu_state(other, js)
    np.testing.assert_array_equal(_np(other(torch.from_numpy(x))), out)


def test_ptq_calibrate_and_convert_match_jax():
    jm, tm = _mlp(2)
    x, = _data(3, (32, 8))
    jp, tp = JQ.PTQ(), Q.PTQ()
    jm, tm = jp.quantize(jm), tp.quantize(tm)
    jm.eval()
    tm.eval()
    for i in range(4):
        jm(pt.to_tensor(x[i * 8:(i + 1) * 8]))
        tm(torch.from_numpy(x[i * 8:(i + 1) * 8]))
    for k, v in _state(jm).items():
        if k.endswith("scale"):
            np.testing.assert_allclose(float(tm.state_dict()[k]), float(v),
                                       rtol=1e-6, err_msg=k)
    jc, tc = jp.convert(jm), tp.convert(tm)
    np.testing.assert_allclose(_np(tc(torch.from_numpy(x))),
                               _np(jc(pt.to_tensor(x))), **TOL)


@pytest.mark.parametrize("m, k, n", [(1, 64, 4), (3, 13, 5), (20, 24, 16),
                                     (40, 7, 9)])
def test_int8_linear_int32_product_and_padding_match_jax(m, k, n):
    """Shapes `_int_mm` takes only padded with zeros (M <= 16, K or N not
    a multiple of 8) give the JAX package's int32 product exactly."""
    pt.seed(m + k)
    jl = jnn.Linear(k, n)
    tl = tnn.Linear(k, n, device="cpu")
    w, x = _data(m, (k, n), (3, m, k))
    jl.weight.set_value(pt.to_tensor(w))
    load_paddle_tpu_state(tl, _state(jl))
    ji = JQ.Int8Linear(jl, w_scale=float(np.abs(w).max()), act_scale=2.5)
    ti = Q.Int8Linear(tl, w_scale=float(np.abs(w).max()), act_scale=2.5)
    np.testing.assert_array_equal(ti.w_int8.numpy(), _np(ji.w_int8))
    np.testing.assert_allclose(_np(ti(torch.from_numpy(x))),
                               _np(ji(pt.to_tensor(x))), **TOL)
    a = torch.from_numpy(np.random.RandomState(k).randint(
        -127, 128, (m, k)).astype(np.int8))
    acc = Q.int8_matmul(a, ti.w_int8)
    assert acc.dtype == torch.int32 and acc.shape == (m, n)
    np.testing.assert_array_equal(
        acc.numpy(), a.numpy().astype(np.int64) @ ti.w_int8.numpy().astype(
            np.int64))


def test_convert_folds_conv_weight_as_jax():
    pt.seed(5)
    jm = jnn.Sequential(jnn.Conv2D(2, 3, 3, padding=1), jnn.ReLU())
    tm = tnn.Sequential(tnn.Conv2D(2, 3, 3, padding=1, device="cpu"),
                        tnn.ReLU())
    load_paddle_tpu_state(tm, _state(jm))
    jp, tp = JQ.PTQ(), Q.PTQ()
    jm, tm = jp.quantize(jm), tp.quantize(tm)
    x, = _data(6, (2, 2, 8, 8))
    jm.eval()
    tm.eval()
    np.testing.assert_allclose(_np(tm(torch.from_numpy(x))),
                               _np(jm(pt.to_tensor(x))), **TOL)
    jc, tc = jp.convert(jm), tp.convert(tm)
    assert isinstance(tc[0], tnn.Conv2D)
    np.testing.assert_allclose(_np(tc[0].weight), _np(jc[0].weight), **TOL)
    np.testing.assert_allclose(_np(tc(torch.from_numpy(x))),
                               _np(jc(pt.to_tensor(x))), **TOL)


# -------------------------------- the JAX package's cases, on the port
def test_reference_case_fake_quantize_values_and_ste():
    x = torch.tensor([-2.0, -0.5, 0.3, 1.0], requires_grad=True)
    y = Q.fake_quantize(x, 1.0)
    np.testing.assert_allclose(_np(y), [-1.0, -0.5039, 0.2992, 1.0],
                               atol=2e-3)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [0.0, 1.0, 1.0, 1.0])


def test_reference_case_qat_trains():
    _, m = _mlp(0)
    m = Q.QAT().quantize(m)
    opt = Adam(learning_rate=5e-3, parameters=m.parameters())
    step = train_step(m, lambda mm, a, b: TF.mse_loss(mm(a), b), opt)
    x, y = (torch.from_numpy(a) for a in _data(4, (16, 8), (16, 4)))
    losses = [float(step(x, y)) for _ in range(40)]
    assert losses[-1] < losses[0] * 0.5
    assert float(m[0].act_q.scale) > 0


def test_reference_case_int8_linear_accumulates_in_int32():
    lin = tnn.Linear(64, 4, device="cpu")
    with torch.no_grad():
        lin.weight.fill_(1.0)
    il = Q.Int8Linear(lin, w_scale=1.0, act_scale=1.0)
    out = il(torch.ones(1, 64))
    np.testing.assert_allclose(_np(out)[0, 0] - float(lin.bias[0]), 64.0,
                               rtol=1e-2)


def test_reference_case_inplace_false_keeps_float_model():
    _, m = _mlp(4)
    mq = Q.QAT().quantize(m, inplace=False)
    assert isinstance(mq[0], Q.QuantedLinear)
    assert isinstance(m[0], tnn.Linear)
    m(torch.randn(2, 8))


def test_reference_case_convert_uncalibrated_raises():
    _, m = _mlp(6)
    ptq = Q.PTQ()
    with pytest.raises(ValueError, match="uncalibrated"):
        ptq.convert(ptq.quantize(m))


def test_reference_case_per_type_config():
    cfg = Q.QuantConfig()
    cfg.add_type_config(tnn.Conv2D, activation=Q.AbsmaxObserver)
    m = tnn.Sequential(tnn.Linear(4, 4, device="cpu"),
                       tnn.Conv2D(1, 1, 3, device="cpu"))
    mq = Q.QAT(cfg).quantize(m)
    assert isinstance(mq[0], Q.QuantedLinear)
    assert isinstance(mq[0].act_q, Q.FakeQuanterWithAbsMax)
    assert isinstance(mq[1].act_q, Q.AbsmaxObserver)
