"""The port's common layers (`nn/common.py`: Linear, Embedding, the
dropouts, the activation layers, resampling, padding, shuffles,
distances, Fold / Unfold, PReLU, Bilinear) against the JAX package's, on
the CPU, and `load_paddle_tpu_state` over a LayerList of every layer
that holds parameters.

Each layer is built in both packages (the JAX one from a seed), its
weights carried into the port, and both run in eval mode on the same
inputs made with numpy.  Random layers (the dropouts) are held by what
they fix: the identity in eval, the kept share and the 1 / (1 - p)
scale in training.

Tolerances.  float32: rtol 1e-5, atol 1e-5 (the same formulas in
another order); resampling with a kernel (bilinear / bicubic) 1e-4:
`jax.image.resize` sums its weights as a matrix product, torch as a
separable loop.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.weights import load_paddle_tpu_state

TOL = dict(rtol=1e-5, atol=1e-5)
RESIZE_TOL = dict(rtol=1e-4, atol=1e-4)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _state(jax_layer):
    return {k: np.asarray(v) for k, v in jax_layer.state_dict().items()}


def _both(build, *arrays, tol=TOL, seed=0):
    pt.seed(seed)
    jl = build(pt.nn, {})
    tl = build(tnn, {"device": "cpu"} if _takes_device(build) else {})
    load_paddle_tpu_state(tl, _state(jl))
    jl.eval()
    tl.eval()
    jo = jl(*[pt.to_tensor(a) for a in arrays])
    with torch.no_grad():
        to = tl(*[torch.from_numpy(a) for a in arrays])
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **tol)
    return jl, tl


def _takes_device(build):
    return getattr(build, "device", True)


def _nodev(fn):
    fn.device = False
    return fn


LAYERS = {
    "linear": (lambda nn, kw: nn.Linear(5, 4, **kw), [(3, 5)]),
    "linear_no_bias": (lambda nn, kw: nn.Linear(5, 4, bias_attr=False,
                                                **kw), [(2, 3, 5)]),
    "bilinear": (lambda nn, kw: nn.Bilinear(3, 4, 5, **kw),
                 [(6, 3), (6, 4)]),
    "prelu": (lambda nn, kw: nn.PReLU(**kw), [(2, 3, 4)]),
    "prelu_channels": (lambda nn, kw: nn.PReLU(3, init=0.1, **kw),
                       [(2, 3, 4, 5)]),
    "flatten": (_nodev(lambda nn, kw: nn.Flatten(1, 2)), [(2, 3, 4, 5)]),
    "identity": (_nodev(lambda nn, kw: nn.Identity()), [(2, 3)]),
    "softmax2d": (_nodev(lambda nn, kw: nn.Softmax2D()), [(2, 3, 4, 4)]),
    "cosine": (_nodev(lambda nn, kw: nn.CosineSimilarity(axis=1)),
               [(4, 6), (4, 6)]),
    "pairwise": (_nodev(lambda nn, kw: nn.PairwiseDistance()),
                 [(4, 6), (4, 6)]),
    "pairwise_l1": (_nodev(lambda nn, kw: nn.PairwiseDistance(
        p=1.0, keepdim=True)), [(4, 6), (4, 6)]),
    "pixel_shuffle": (_nodev(lambda nn, kw: nn.PixelShuffle(2)),
                      [(2, 8, 3, 3)]),
    "pixel_unshuffle": (_nodev(lambda nn, kw: nn.PixelUnshuffle(2)),
                        [(2, 2, 4, 6)]),
    "channel_shuffle": (_nodev(lambda nn, kw: nn.ChannelShuffle(2)),
                        [(2, 4, 3, 3)]),
    "fold": (_nodev(lambda nn, kw: nn.Fold([4, 5], 2)), [(2, 12, 12)]),
    "unfold": (_nodev(lambda nn, kw: nn.Unfold(2, paddings=1)),
               [(2, 3, 4, 5)]),
    "pad1d": (_nodev(lambda nn, kw: nn.Pad1D([1, 2])), [(2, 3, 6)]),
    "pad1d_reflect": (_nodev(lambda nn, kw: nn.Pad1D([2, 1],
                                                      mode="reflect")),
                      [(2, 3, 6)]),
    "pad2d_replicate": (_nodev(lambda nn, kw: nn.Pad2D(
        [1, 2, 0, 1], mode="replicate")), [(2, 3, 5, 6)]),
    "pad2d_circular": (_nodev(lambda nn, kw: nn.Pad2D(
        [1, 0, 2, 1], mode="circular")), [(2, 3, 5, 6)]),
    "pad2d_value": (_nodev(lambda nn, kw: nn.Pad2D(1, value=3.0)),
                    [(2, 3, 5, 6)]),
    "zeropad2d": (_nodev(lambda nn, kw: nn.ZeroPad2D([1, 0, 2, 3])),
                  [(2, 3, 5, 6)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    build, shapes = LAYERS[name]
    _both(build, *[_x(*s, seed=i) for i, s in enumerate(shapes)])


RESIZES = {
    "nearest_up": (lambda nn: nn.Upsample(scale_factor=2), False),
    "nearest_down": (lambda nn: nn.UpsamplingNearest2D(size=(3, 5)), False),
    "nearest_odd": (lambda nn: nn.Upsample(size=(7, 9)), False),
    "bilinear_up": (lambda nn: nn.Upsample(size=(9, 13), mode="bilinear"),
                    True),
    "bilinear_down": (lambda nn: nn.Upsample(size=(3, 4), mode="bilinear"),
                      True),
    "bicubic_up": (lambda nn: nn.Upsample(size=(11, 14), mode="bicubic"),
                   True),
    "bicubic_down": (lambda nn: nn.Upsample(size=(2, 3), mode="bicubic"),
                     True),
    "bilinear_corners": (lambda nn: nn.UpsamplingBilinear2D(
        scale_factor=2), True),
    "bilinear_corners_size": (lambda nn: nn.Upsample(
        size=(4, 9), mode="bilinear", align_corners=True), True),
}


@pytest.mark.parametrize("name", sorted(RESIZES))
def test_resize_follows_jax_image_resize(name):
    """Half-pixel centres, antialiased shrinking, cubic a = -0.5; the
    corner grid only for align_corners bilinear."""
    build, kernel = RESIZES[name]
    _both(_nodev(lambda nn, kw: build(nn)), _x(2, 3, 5, 6),
          tol=RESIZE_TOL if kernel else TOL)


ACTIVATIONS = {
    "ReLU": {}, "ReLU6": {}, "GELU": {}, "SiLU": {}, "Silu": {},
    "Swish": {}, "Mish": {}, "Sigmoid": {}, "Tanh": {}, "Hardswish": {},
    "Hardsigmoid": {}, "SELU": {}, "Softsign": {}, "Tanhshrink": {},
    "LogSigmoid": {}, "LogSoftmax": {},
    "GELU-tanh": {"approximate": True},
    "Hardtanh": {"min": -0.5, "max": 0.7},
    "LeakyReLU": {"negative_slope": 0.2}, "ELU": {"alpha": 0.7},
    "CELU": {"alpha": 1.3}, "Softplus": {"beta": 2.0, "threshold": 5.0},
    "Softshrink": {"threshold": 0.3}, "Hardshrink": {"threshold": 0.4},
    "Softmax": {"axis": 1}, "GLU": {"axis": 1},
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_layer_matches_jax(name):
    cls, kw = name.split("-")[0], ACTIVATIONS[name]
    x = _x(2, 4, 6) * 3
    _both(_nodev(lambda nn, _: getattr(nn, cls)(**kw)), x)


def test_embedding_zeroes_its_padding_row_and_its_gradient():
    pt.seed(1)
    je = pt.nn.Embedding(10, 4, padding_idx=2)
    te = tnn.Embedding(10, 4, padding_idx=2, device="cpu")
    assert not te.weight[2].any() and not je.weight.numpy()[2].any()
    load_paddle_tpu_state(te, _state(je))
    ids = np.array([[1, 2, 3], [2, 2, 9]])
    out = te(torch.from_numpy(ids))
    jout = je(pt.to_tensor(ids))
    np.testing.assert_allclose(out.detach().numpy(), jout.numpy(), **TOL)
    (out * 3).sum().backward()
    (jout * 3).sum().backward()
    np.testing.assert_allclose(te.weight.grad.numpy(),
                               je.weight.grad.numpy(), **TOL)
    assert not te.weight.grad[2].any()


@pytest.mark.parametrize("cls", ["Dropout", "Dropout2D", "AlphaDropout"])
def test_dropouts_are_the_identity_in_eval(cls):
    x = _x(2, 3, 4, 5)
    for layer in (getattr(pt.nn, cls)(0.4), getattr(tnn, cls)(0.4)):
        layer.eval()
    _both(_nodev(lambda nn, _: getattr(nn, cls)(0.4)), x)


def test_dropout_layers_in_training():
    """Kept elements (whole channels for Dropout2D) scale by 1 / (1 - p)
    and about p of them drop; the layer's generator makes it repeat."""
    x = torch.ones(64, 32, 4, 4)
    for layer, per_channel in ((tnn.Dropout(0.25), False),
                               (tnn.Dropout2D(0.25), True)):
        layer.generator = torch.Generator().manual_seed(0)
        out = layer(x)
        assert set(out.unique().tolist()) <= {0.0, float(np.float32(1 / 0.75))}
        assert abs(float((out == 0).float().mean()) - 0.25) < 0.02
        if per_channel:
            assert bool((out.amax((2, 3)) == out.amin((2, 3))).all())
        layer.generator = torch.Generator().manual_seed(0)
        assert torch.equal(layer(x), out)


def _param_layers(nn, kw):
    """Every layer that holds parameters (or persistable buffers)."""
    return nn.LayerList([
        nn.Linear(4, 3, **kw), nn.Embedding(7, 4, padding_idx=0, **kw),
        nn.Bilinear(2, 3, 4, **kw), nn.PReLU(3, **kw),
        nn.LayerNorm([3, 4], **kw), nn.RMSNorm(4, **kw),
        nn.GroupNorm(2, 4, **kw), nn.BatchNorm1D(4, **kw),
        nn.BatchNorm3D(4, **kw), nn.SyncBatchNorm(4, **kw),
        nn.InstanceNorm2D(4, **kw), nn.InstanceNorm1D(4, **kw),
        nn.Conv1D(2, 4, 3, **kw), nn.Conv2D(2, 4, 3, **kw),
        nn.Conv3D(2, 4, 3, **kw), nn.Conv2DTranspose(2, 4, 3, **kw),
        nn.Conv1DTranspose(2, 4, 3, **kw),
        nn.Conv3DTranspose(2, 4, 3, **kw),
        nn.SimpleRNN(3, 4, num_layers=2, direction="bidirect", **kw),
        nn.LSTM(3, 4, **kw), nn.GRU(3, 4, **kw), nn.LSTMCell(3, 4, **kw),
        nn.GRUCell(3, 4, **kw), nn.SimpleRNNCell(3, 4, **kw),
        nn.HSigmoidLoss(4, 6, **kw),
        nn.MultiHeadAttention(8, 2, kdim=4, **kw),
        nn.TransformerDecoderLayer(8, 2, 16, **kw),
        nn.Sequential(nn.Linear(4, 4, **kw), nn.ReLU(),
                      nn.Linear(4, 2, **kw))])


def test_load_state_carries_every_parameter_layer():
    pt.seed(2)
    j = _param_layers(pt.nn, {})
    t = _param_layers(tnn, {"device": "cpu"})
    # the same names; torch lists a layer's buffers beside its parameters,
    # the JAX package every buffer after the parameters
    assert sorted(t.state_dict()) == sorted(j.state_dict())
    arrays = _state(j)
    load_paddle_tpu_state(t, arrays)
    linear = {f"{n}.weight" for n, m in t.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for name, v in t.state_dict().items():
        want = arrays[name].T if name in linear else arrays[name]
        np.testing.assert_array_equal(v.numpy(), want, err_msg=name)
