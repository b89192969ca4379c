"""The port's norms, convolutions and pools (`nn/norm.py`, `nn/conv.py`,
`nn/pooling.py`, the 1-D / 3-D ones of `nn/extras_r3.py`) against the JAX
package's, on the CPU.

Layers are built in both packages, weights carried through
`load_paddle_tpu_state`, and both run on the same numpy inputs; batch
norms in training compare their running statistics too, and
`SyncBatchNorm` at world size 1 is `BatchNorm`.  `weight_attr` /
`bias_attr` (a ParamAttr with an initializer, `trainable=False`, or
False) reach Conv2D and the batch norms.

Tolerances.  float32: rtol 1e-5, atol 1e-5 (convolutions 1e-4 absolute:
XLA's and oneDNN's convolutions sum in other orders).  bfloat16 under
AMP O1: the norms compute in float32 on both sides (`layer_norm` is a
deny op), so their outputs agree to float32's 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import ParamAttr
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.weights import load_paddle_tpu_state

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)


def _x(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _state(jax_layer):
    return {k: np.asarray(v) for k, v in jax_layer.state_dict().items()}


def _pair(build, dev=True, seed=0):
    pt.seed(seed)
    jl = build(pt.nn, {})
    tl = build(tnn, {"device": "cpu"} if dev else {})
    load_paddle_tpu_state(tl, _state(jl))
    return jl, tl


def _run(jl, tl, *arrays):
    jo = jl(*[pt.to_tensor(a) for a in arrays])
    with torch.no_grad():
        to = tl(*[torch.from_numpy(a) for a in arrays])
    return to, jo


def _close(to, jo, tol=TOL):
    to = to if isinstance(to, tuple) else (to,)
    jo = jo if isinstance(jo, tuple) else (jo,)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **tol)


# ------------------------------------------------------------------ norms
NORMS = {
    "layer_norm": (lambda nn, kw: nn.LayerNorm(6, **kw), (3, 4, 6)),
    "layer_norm_2d": (lambda nn, kw: nn.LayerNorm([4, 6], epsilon=1e-3,
                                                  **kw), (3, 4, 6)),
    "layer_norm_no_affine": (lambda nn, kw: nn.LayerNorm(
        6, weight_attr=False, bias_attr=False, **kw), (3, 4, 6)),
    "rms_norm": (lambda nn, kw: nn.RMSNorm(6, **kw), (3, 4, 6)),
    "group_norm": (lambda nn, kw: nn.GroupNorm(2, 6, **kw), (3, 6, 4, 5)),
    "group_norm_no_bias": (lambda nn, kw: nn.GroupNorm(
        3, 6, bias_attr=False, **kw), (3, 6, 5)),
    "instance_norm2d": (lambda nn, kw: nn.InstanceNorm2D(6, **kw),
                        (3, 6, 4, 5)),
    "instance_norm1d": (lambda nn, kw: nn.InstanceNorm1D(6, **kw),
                        (3, 6, 7)),
    "instance_norm3d": (lambda nn, kw: nn.InstanceNorm3D(6, **kw),
                        (2, 6, 3, 4, 5)),
    "local_response_norm": (lambda nn, kw: nn.LocalResponseNorm(
        3, alpha=0.1, beta=0.5, k=2.0), (2, 7, 4, 4)),
}


@pytest.mark.parametrize("name", sorted(NORMS))
def test_norm_layer_matches_jax(name):
    build, shape = NORMS[name]
    jl, tl = _pair(build, dev=name != "local_response_norm")
    if name == "layer_norm_no_affine":
        assert tl.weight is None and tl.bias is None
    _close(*_run(jl, tl, _x(*shape, scale=3.0)))


def test_norm_functionals_match_jax():
    x = _x(3, 6, 4, 5, scale=2.0)
    w, b = _x(6, seed=1), _x(6, seed=2)
    for tf, jf, args in (
            (PF.layer_norm, JF.layer_norm, (x, [4, 5])),
            (PF.layer_norm, JF.layer_norm, (x, 5, _x(5), _x(5, seed=1))),
            (PF.group_norm, JF.group_norm, (x, 3, w, b)),
            (PF.instance_norm, JF.instance_norm, (x,)),
            (PF.local_response_norm, JF.local_response_norm, (x, 4))):
        _close(tf(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                    for a in args]),
               jf(*[pt.to_tensor(a) if isinstance(a, np.ndarray) else a
                    for a in args]))


def test_layer_norm_under_amp_o1_computes_in_float32():
    jl, tl = _pair(lambda nn, kw: nn.LayerNorm(6, **kw))
    x = _x(3, 6)
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        jo = jl(pt.to_tensor(x).astype("bfloat16"))
    with torch.no_grad(), amp.auto_cast(level="O1", dtype="bfloat16"):
        to = tl(torch.from_numpy(x).bfloat16())
    assert to.dtype == torch.float32
    _close(to, jo.astype("float32"))


@pytest.mark.parametrize("cls,shape,fmt", [
    ("BatchNorm1D", (8, 4), "NCHW"), ("BatchNorm1D", (8, 4, 5), "NCHW"),
    ("BatchNorm2D", (4, 4, 3, 5), "NHWC"),
    ("BatchNorm3D", (3, 4, 2, 3, 5), "NCHW"),
    ("SyncBatchNorm", (4, 4, 3, 5), "NCHW")])
def test_batch_norm_train_and_eval_match_jax(cls, shape, fmt):
    build = lambda nn, kw: getattr(nn, cls)(  # noqa: E731
        4 if fmt == "NCHW" else shape[-1], momentum=0.8, data_format=fmt,
        **kw)
    jl, tl = _pair(build)
    x = _x(*shape, scale=2.0) + 1.0
    for _ in range(2):
        _close(*_run(jl, tl, x))
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(tl, name).numpy(),
                                   getattr(jl, name).numpy(), **TOL)
    jl.eval()
    tl.eval()
    _close(*_run(jl, tl, x * 0.5))


def test_convert_sync_batchnorm_keeps_parameters_and_statistics():
    net = tnn.Sequential(tnn.Conv2D(3, 4, 3, device="cpu"),
                         tnn.BatchNorm2D(4, device="cpu"))
    net(torch.randn(2, 3, 6, 6))
    want = {k: v.clone() for k, v in net.state_dict().items()}
    tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert type(net[1]) is tnn.SyncBatchNorm
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_param_attrs_reach_conv_and_batch_norm():
    """A ParamAttr's initializer and trainable flag, and False for no
    parameter, as the JAX layers take them."""
    frozen = ParamAttr(trainable=False, initializer=tnn.initializer.Constant(
        0.5))
    conv = tnn.Conv2D(2, 3, 3, weight_attr=frozen, bias_attr=ParamAttr(
        initializer=tnn.initializer.Constant(0.1)), device="cpu")
    assert not conv.weight.requires_grad
    assert torch.equal(conv.weight, torch.full((3, 2, 3, 3), 0.5))
    assert torch.equal(conv.bias, torch.full((3,), 0.1))
    jconv = pt.nn.Conv2D(2, 3, 3, weight_attr=pt.ParamAttr(
        trainable=False, initializer=pt.nn.initializer.Constant(0.5)),
        bias_attr=pt.ParamAttr(initializer=pt.nn.initializer.Constant(0.1)))
    _close(*_run(jconv, conv, _x(2, 2, 5, 5)), CONV_TOL)
    bn = tnn.BatchNorm2D(3, weight_attr=ParamAttr(trainable=False),
                         bias_attr=False, device="cpu")
    assert not bn.weight.requires_grad and bn.bias is None


# ------------------------------------------------------------ convolutions
CONVS = {
    "conv1d": (lambda nn, kw: nn.Conv1D(4, 6, 3, stride=2, padding=1,
                                        **kw), (2, 4, 9)),
    "conv1d_groups_dilation": (lambda nn, kw: nn.Conv1D(
        4, 6, 3, padding=[1, 2], dilation=2, groups=2, **kw), (2, 4, 9)),
    "conv1d_same": (lambda nn, kw: nn.Conv1D(4, 6, 4, stride=2,
                                             padding="SAME", **kw),
                    (2, 4, 9)),
    "conv3d": (lambda nn, kw: nn.Conv3D(3, 4, 3, stride=(1, 2, 1),
                                        padding=1, **kw), (2, 3, 4, 5, 6)),
    "conv3d_no_bias": (lambda nn, kw: nn.Conv3D(
        3, 4, (2, 3, 2), padding=[0, 1, 1, 0, 0, 1], bias_attr=False, **kw),
        (1, 3, 4, 5, 6)),
    "conv2d_transpose": (lambda nn, kw: nn.Conv2DTranspose(
        4, 6, 3, stride=2, padding=1, output_padding=1, **kw),
        (2, 4, 5, 6)),
    "conv2d_transpose_groups": (lambda nn, kw: nn.Conv2DTranspose(
        4, 6, (3, 2), stride=(1, 2), padding=[1, 0, 0, 1], dilation=2,
        groups=2, **kw), (2, 4, 5, 6)),
    "conv1d_transpose": (lambda nn, kw: nn.Conv1DTranspose(
        4, 6, 3, stride=2, padding=1, output_padding=1, **kw), (2, 4, 7)),
    "conv3d_transpose": (lambda nn, kw: nn.Conv3DTranspose(
        3, 4, 3, stride=2, padding=1, **kw), (1, 3, 3, 4, 2)),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_layer_matches_jax(name):
    build, shape = CONVS[name]
    jl, tl = _pair(build)
    assert tuple(tl.weight.shape) == tuple(jl.weight.shape)
    _close(*_run(jl, tl, _x(*shape)), CONV_TOL)


# ------------------------------------------------------------------ pools
POOLS = {
    "max_pool1d": (lambda nn: nn.MaxPool1D(3, stride=2, padding=1),
                   (2, 3, 9)),
    "avg_pool1d": (lambda nn: nn.AvgPool1D(2), (2, 3, 9)),
    "avg_pool1d_pad": (lambda nn: nn.AvgPool1D(3, 2, 1, exclusive=False),
                       (2, 3, 9)),
    "adaptive_max_pool2d": (lambda nn: nn.AdaptiveMaxPool2D(2),
                            (2, 3, 4, 6)),
    "adaptive_avg_pool1d": (lambda nn: nn.AdaptiveAvgPool1D(3), (2, 3, 9)),
    "adaptive_max_pool1d": (lambda nn: nn.AdaptiveMaxPool1D(3), (2, 3, 9)),
    "adaptive_avg_pool3d": (lambda nn: nn.AdaptiveAvgPool3D([1, 2, 3]),
                            (2, 3, 2, 4, 6)),
    "adaptive_max_pool3d": (lambda nn: nn.AdaptiveMaxPool3D(2),
                            (2, 3, 4, 4, 6)),
    "max_pool3d": (lambda nn: nn.MaxPool3D(2, stride=2, padding=1,
                                           ceil_mode=True), (2, 3, 4, 5, 5)),
    "avg_pool3d": (lambda nn: nn.AvgPool3D(3, stride=2, padding=1),
                   (2, 3, 4, 5, 5)),
    "avg_pool3d_ceil": (lambda nn: nn.AvgPool3D(2, ceil_mode=True,
                                                exclusive=False),
                        (2, 3, 3, 5, 5)),
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pool_layer_matches_jax(name):
    build, shape = POOLS[name]
    _close(*_run(build(pt.nn), build(tnn), _x(*shape)))


def test_max_unpool_inverts_max_pool_like_jax():
    x = _x(2, 3, 6, 8)
    jo, jm = JF.max_pool2d(pt.to_tensor(x), 2, return_mask=True)
    to, tm = PF.max_pool2d(torch.from_numpy(x), 2, return_mask=True)
    np.testing.assert_array_equal(tm.numpy(), jm.numpy())
    for cls in ("MaxUnpool2D", "MaxUnPool2D"):
        ju = getattr(pt.nn, cls)(2)(jo, jm)
        tu = getattr(tnn, cls)(2)(to, tm)
        _close(tu, ju)
    _close(PF.max_unpool2d(to, tm, 2, output_size=[7, 9]),
           JF.max_unpool2d(jo, jm, 2, output_size=[7, 9]))
    jo1, jm1 = JF.max_pool1d(pt.to_tensor(x[0]), 2, return_mask=True)
    to1, tm1 = PF.max_pool1d(torch.from_numpy(x[0]), 2, return_mask=True)
    _close((to1, tm1), (jo1, jm1))


def test_sync_batch_norm_reduces_over_two_gloo_ranks(tmp_path):
    """Two ranks, each with half of one batch: rank 0's output, input
    gradient and running statistics equal one BatchNorm's over the whole
    batch (its half of the output and gradient)."""
    from torch_gloo import Ranks
    got = Ranks(2, [{"name": "sbn", "fn": "sync_batch_norm",
                     "kw": {"seed": 3}}], tmp_path)["sbn"]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 3, 5, 2)).astype(
        np.float32) * 2 + 1).requires_grad_()
    proj = torch.from_numpy(rng.standard_normal((4, 3, 5, 2)).astype(
        np.float32))
    bn = tnn.BatchNorm2D(3, momentum=0.8, device="cpu")
    out = bn(x)
    # each rank's loss is its rows times proj; their sum reaches rank 0's
    # rows through the shared statistics
    (out * torch.cat([proj, proj])).sum().backward()
    np.testing.assert_allclose(got["out"], out[:4].detach().numpy(), **TOL)
    np.testing.assert_allclose(got["grad"], x.grad[:4].numpy(), **TOL)
    np.testing.assert_allclose(got["mean"], bn._mean.numpy(), **TOL)
    np.testing.assert_allclose(got["variance"], bn._variance.numpy(), **TOL)


@pytest.mark.parametrize("name,dims", [
    ("adaptive_max_pool2d", 2), ("adaptive_max_pool1d", 1),
    ("adaptive_avg_pool3d", 3), ("adaptive_max_pool3d", 3)])
def test_adaptive_pools_refuse_uneven_bins_like_jax(name, dims):
    x = _x(*(2, 3) + (5,) * dims)
    for fn, arr in ((getattr(JF, name), pt.to_tensor(x)),
                    (getattr(PF, name), torch.from_numpy(x))):
        with pytest.raises(NotImplementedError):
            fn(arr, 2)
