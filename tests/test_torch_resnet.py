"""The port's ResNet path against the JAX package's, on the CPU.

The same inputs, made with numpy, go through a JAX layer and the port's
layer carrying its weights (`load_paddle_tpu_state`), in NCHW and NHWC:

* `Conv2D` (stride, padding, groups, bias), `BatchNorm2D` in train mode
  (output and the running statistics it updates, the JAX momentum
  convention) and in eval mode, `MaxPool2D`, `AvgPool2D` (exclusive,
  ceil_mode) and `AdaptiveAvgPool2D` (bins that do not divide);
* the space-to-depth stem against the plain 7x7 / stride-2 conv and
  against the JAX package's op;
* resnet18 and resnet50 forwards at small images, in eval and in train
  mode (the running statistics after the forward too), `s2d_stem` on;
* `Momentum` (heavy-ball and Nesterov, with and without weight decay);
* a 3-step resnet18 `TrainStep` series in float32 with `Momentum`: the
  losses, the parameters and every running statistic.

Tolerances: float32 on both sides, the convolutions summed in another
order by XLA and by oneDNN, so outputs agree to 1e-4 relative with an
absolute floor of 1e-5 per unit of output scale; pooling is exact up
to one rounding.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.nn_kernels import s2d_stem_conv_k, s2d_stem_conv_nhwc_k
from paddle_tpu.vision.models import resnet18 as jax_resnet18
from paddle_tpu.vision.models import resnet50 as jax_resnet50
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import ops
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.jit import train_step
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision.models import resnet18, resnet50
from paddle_tpu_torch.weights import load_paddle_tpu_state

FORMATS = ["NCHW", "NHWC"]
TOL = dict(rtol=1e-4, atol=1e-5)


def _arrays(jm):
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _image(shape, fmt, seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return x.transpose(0, 2, 3, 1).copy() if fmt == "NHWC" else x


def _both(x):
    return pt.to_tensor(x), torch.from_numpy(x)


@pytest.mark.parametrize("fmt", FORMATS)
def test_conv2d_matches_jax(fmt):
    pt.seed(1)
    jc = pt.nn.Conv2D(4, 6, 3, stride=2, padding=1, groups=2,
                      data_format=fmt)
    tc = tnn.Conv2D(4, 6, 3, stride=2, padding=1, groups=2, data_format=fmt,
                    device="cpu")
    load_paddle_tpu_state(tc, _arrays(jc))
    jx, tx = _both(_image((2, 4, 9, 9), fmt))
    got = tc(tx)
    np.testing.assert_allclose(got.detach().numpy(), jc(jx).numpy(), **TOL)
    assert got.shape == tuple(jc(jx).shape)
    # asymmetric padding (top, bottom, left, right) and no bias
    jc = pt.nn.Conv2D(4, 3, 2, padding=[0, 1, 1, 0], bias_attr=False,
                      data_format=fmt)
    tc = tnn.Conv2D(4, 3, 2, padding=[0, 1, 1, 0], bias_attr=False,
                    data_format=fmt, device="cpu")
    load_paddle_tpu_state(tc, _arrays(jc))
    np.testing.assert_allclose(tc(tx).detach().numpy(), jc(jx).numpy(),
                               **TOL)


@pytest.mark.parametrize("fmt", FORMATS)
def test_batch_norm_train_and_eval_match_jax(fmt):
    """Two training forwards (the running statistics move by the JAX
    package's momentum convention, the variance unbiased), then eval."""
    jb = pt.nn.BatchNorm2D(5, momentum=0.8, data_format=fmt)
    tb = tnn.BatchNorm2D(5, momentum=0.8, data_format=fmt, device="cpu")
    rng = np.random.RandomState(2)
    w = rng.randn(5).astype(np.float32)
    arrays = dict(_arrays(jb), weight=w, bias=w[::-1].copy())
    jb.set_state_dict({k: pt.to_tensor(v) for k, v in arrays.items()})
    load_paddle_tpu_state(tb, arrays)
    assert tb._mean.dtype == tb._variance.dtype == torch.float32
    for seed in (3, 4):
        jx, tx = _both(3.0 + 2.0 * _image((4, 5, 6, 7), fmt, seed))
        np.testing.assert_allclose(tb(tx).detach().numpy(), jb(jx).numpy(),
                                   **TOL)
    np.testing.assert_allclose(tb._mean.numpy(), jb._mean.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb._variance.numpy(), jb._variance.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not np.allclose(tb._mean.numpy(), 0.0)
    jb.eval()
    tb.eval()
    np.testing.assert_allclose(tb(tx).detach().numpy(), jb(jx).numpy(),
                               **TOL)


def test_batch_norm_bfloat16_input_keeps_float32_statistics():
    tb = tnn.BatchNorm2D(3, device="cpu", dtype=torch.bfloat16)
    x = torch.from_numpy(_image((2, 3, 4, 4), "NCHW")).bfloat16()
    out = tb(x)
    assert out.dtype == torch.bfloat16
    assert tb._mean.dtype == torch.float32
    want = (x.float().mean(dim=(0, 2, 3))) * 0.1
    torch.testing.assert_close(tb._mean, want, rtol=1e-6, atol=1e-6)


POOLS = [
    ("max", dict(kernel_size=3, stride=2, padding=1)),
    ("max", dict(kernel_size=3, stride=2, padding=0, ceil_mode=True)),
    ("max", dict(kernel_size=2, padding=[1, 0, 0, 1])),
    ("avg", dict(kernel_size=3, stride=2, padding=1)),
    ("avg", dict(kernel_size=3, stride=2, padding=1, exclusive=False)),
    ("avg", dict(kernel_size=2, stride=2, ceil_mode=True)),
    ("adaptive", dict(output_size=(3, 2))),
    ("adaptive", dict(output_size=1)),
]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind,kw", POOLS)
def test_pooling_matches_jax(kind, kw, fmt):
    jcls, tcls = {"max": (pt.nn.MaxPool2D, tnn.MaxPool2D),
                  "avg": (pt.nn.AvgPool2D, tnn.AvgPool2D),
                  "adaptive": (pt.nn.AdaptiveAvgPool2D,
                               tnn.AdaptiveAvgPool2D)}[kind]
    jx, tx = _both(_image((2, 3, 7, 8), fmt, seed=5))
    want = jcls(data_format=fmt, **kw)(jx).numpy()
    got = tcls(data_format=fmt, **kw)(tx).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_max_pool_mask_matches_jax():
    """Unpadded windows: the JAX package's mask takes its patches through
    a convolution, where a -inf padding element times 0 gives NaN and
    wins the argmax, so its indices at padded borders point into the
    padding; the comparison stays inside the map."""
    jx, tx = _both(_image((2, 3, 7, 8), "NCHW", seed=6))
    for kw in (dict(kernel_size=3, stride=2), dict(kernel_size=2)):
        jo, jm = JF.max_pool2d(jx, return_mask=True, **kw)
        to, tm = PF.max_pool2d(tx, return_mask=True, **kw)
        np.testing.assert_array_equal(to.numpy(), jo.numpy())
        np.testing.assert_array_equal(tm.numpy(), jm.numpy())
    with pytest.raises(NotImplementedError):
        PF.max_pool2d(tx, 2, padding=[1, 0, 0, 1], return_mask=True)


@pytest.mark.parametrize("fmt", FORMATS)
def test_s2d_stem_equals_the_plain_stem_and_jax(fmt):
    rng = np.random.RandomState(7)
    x = _image((2, 3, 16, 12), fmt, seed=7)
    w = rng.randn(8, 3, 7, 7).astype(np.float32)
    stem = ops.s2d_stem_conv_nhwc if fmt == "NHWC" else ops.s2d_stem_conv
    got = stem(torch.from_numpy(x), torch.from_numpy(w))
    plain = PF.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=2,
                      padding=3, data_format=fmt)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    jstem = s2d_stem_conv_nhwc_k if fmt == "NHWC" else s2d_stem_conv_k
    np.testing.assert_allclose(got.numpy(), np.asarray(jstem(x, w)), **TOL)


# ---------------------------------------------------------------- models
def _jax_model(make, fmt, seed=0, **kw):
    pt.seed(seed)
    return make(num_classes=10, data_format=fmt, **kw)


@pytest.fixture(scope="module")
def jax_resnets():
    return {(name, fmt): _jax_model(b, fmt, s2d_stem=True)
            for name, b in (("resnet18", jax_resnet18),
                            ("resnet50", jax_resnet50))
            for fmt in FORMATS}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_forward_matches_jax(jax_resnets, name, fmt):
    """Eval, then a train-mode forward (batch statistics, and the running
    statistics it leaves), batch 4 at 64 x 64: layer4 normalises over 16
    values a channel, so its batch statistics amplify the two packages'
    rounding differences less than at smaller sizes."""
    jm = jax_resnets[(name, fmt)]
    before = _arrays(jm)
    tm = {"resnet18": resnet18, "resnet50": resnet50}[name](
        num_classes=10, data_format=fmt, s2d_stem=True, device="cpu")
    load_paddle_tpu_state(tm, before)
    jx, tx = _both(_image((4, 3, 64, 64), fmt, seed=8))
    jm.eval()
    tm.eval()
    want = jm(jx).numpy()
    with torch.no_grad():
        got = tm(tx).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    jm.train()
    tm.train()
    want = jm(jx).numpy()
    with torch.no_grad():
        got = tm(tx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())
    after = _arrays(jm)
    for n, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), after[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    jm.set_state_dict({k: pt.to_tensor(v) for k, v in before.items()})


def test_resnet_entry_point_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet50()
    assert next(resnet18(num_classes=4, device="cpu").parameters()).device \
        == torch.device("cpu")


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("nesterov,wd", [(False, None), (True, None),
                                         (False, 1e-2), (True, 1e-2)])
def test_momentum_matches_jax(nesterov, wd):
    """A small MLP, 4 TrainStep steps of Momentum on each side."""
    pt.seed(9)
    jm = pt.nn.Sequential(pt.nn.Linear(6, 8), pt.nn.ReLU(),
                          pt.nn.Linear(8, 3))
    tm = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                             torch.nn.Linear(8, 3))
    load_paddle_tpu_state(tm, _arrays(jm))
    rng = np.random.RandomState(10)
    x = rng.randn(5, 6).astype(np.float32)
    y = rng.randint(0, 3, size=5)
    kw = dict(learning_rate=0.1, momentum=0.9, use_nesterov=nesterov,
              weight_decay=wd)
    jstep = pt.jit.train_step(
        jm, lambda m, a, b: JF.cross_entropy(m(a), b),
        pt.optimizer.Momentum(parameters=jm.parameters(), **kw))
    opt = optimizer.Momentum(parameters=tm.parameters(), **kw)
    tstep = train_step(tm, lambda m, a, b: PF.cross_entropy(m(a), b), opt)
    jl = [float(jstep(pt.to_tensor(x), pt.to_tensor(y.astype("int64"))))
          for _ in range(4)]
    tl = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(4)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    assert set(opt._state[0]) == {"velocity"}
    final = _arrays(jm)
    for n, p in tm.named_parameters():
        want = final[n].T if n.endswith("weight") else final[n]
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6, err_msg=n)


# ------------------------------------------------------------ train step
def test_resnet18_train_step_series_matches_jax():
    """3 steps of resnet18 (float32, Momentum(0.01, 0.9), cross entropy,
    batch 4 at 64 x 64): losses, parameters and running statistics."""
    jm = _jax_model(jax_resnet18, "NCHW", seed=11)
    tm = resnet18(num_classes=10, device="cpu")
    load_paddle_tpu_state(tm, _arrays(jm))
    rng = np.random.RandomState(12)
    x = rng.randn(4, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, size=4)
    jstep = pt.jit.train_step(
        jm, lambda m, a, b: JF.cross_entropy(m(a), b),
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                              parameters=jm.parameters()))
    tstep = train_step(tm, lambda m, a, b: PF.cross_entropy(m(a), b),
                       optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                          parameters=tm.parameters()))
    jl = [float(jstep(pt.to_tensor(x), pt.to_tensor(y.astype("int64"))))
          for _ in range(3)]
    tl = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    assert tl[-1] < tl[0]
    final = _arrays(jm)
    for n, t in list(tm.named_parameters()) + list(tm.named_buffers()):
        want = final[n].T if n == "fc.weight" else final[n]
        got = t.detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-3),
                                   err_msg=n)
