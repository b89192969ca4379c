"""The rest of the port's `nn.functional` against the JAX package's, on
the CPU: activations, one_hot, linear / bilinear / embedding, softmax
with a dtype, label_smooth, sequence_mask, normalize, distances, pad,
grid_sample / affine_grid, unfold / fold, temporal_shift, gather_tree,
maxout and the channel dropouts.  (Losses: `test_torch_nn_loss.py`;
norms, convolutions and pools: `test_torch_nn_norm_conv_pool.py`.)

Each case runs the same numpy inputs through both functions.  Random
functions are held by what they fix (eval results, kept shares, the
straight-through gradient).

Tolerances.  float32: rtol 1e-5, atol 1e-5; grid_sample 1e-5 as well.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as PF

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _cmp(name, args, kw=None, tol=TOL, jname=None):
    kw = kw or {}
    jo = getattr(JF, jname or name)(*[pt.to_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args], **kw)
    to = getattr(PF, name)(*[torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in args], **kw)
    jo = jo if isinstance(jo, (tuple, list)) else (jo,)
    to = to if isinstance(to, (tuple, list)) else (to,)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(np.asarray(a.detach().numpy(),
                                              np.float64),
                                   np.asarray(b.numpy(), np.float64), **tol)


ACT = {
    "relu6": {}, "sigmoid": {}, "swish": {}, "mish": {}, "hardswish": {},
    "selu": {}, "softsign": {}, "tanhshrink": {}, "log_sigmoid": {},
    "hardsigmoid": {"slope": 0.2, "offset": 0.4}, "celu": {"alpha": 0.5},
    "elu": {"alpha": 2.0}, "leaky_relu": {"negative_slope": 0.3},
    "softplus": {"beta": 0.5, "threshold": 3.0},
    "softshrink": {"threshold": 0.7}, "hardshrink": {"threshold": 0.2},
    "hardtanh": {"min": -2.0, "max": 0.5},
    "thresholded_relu": {"threshold": 0.4}, "glu": {"axis": 0},
    "softmax": {"axis": 0}, "log_softmax": {"axis": 1},
    "maxout": {"groups": 2, "axis": 1},
}


@pytest.mark.parametrize("name", sorted(ACT))
def test_activation_matches_jax(name):
    _cmp(name, [_x(4, 6, scale=3.0)], ACT[name])


def test_relu_in_place_prelu_and_rrelu_eval():
    x = _x(3, 4)
    t = torch.from_numpy(x.copy())
    assert PF.relu_(t) is t
    np.testing.assert_array_equal(t.numpy(), np.maximum(x, 0))
    _cmp("prelu", [x, np.full((1, 4), 0.2, np.float32)])
    _cmp("rrelu", [x], {"training": False})


def test_rrelu_and_gumbel_softmax_in_training():
    g = torch.Generator().manual_seed(0)
    x = -torch.ones(20000)
    slope = -PF.rrelu(x, 0.1, 0.3, generator=g)
    assert 0.1 <= float(slope.min()) and float(slope.max()) <= 0.3
    assert abs(float(slope.mean()) - 0.2) < 5e-3
    logits = torch.randn(5, 7, generator=g, requires_grad=True)
    y = PF.gumbel_softmax(logits, hard=True, generator=g)
    assert torch.equal(y.sum(-1), torch.ones(5))
    assert set(y.detach().unique().tolist()) == {0.0, 1.0}
    (y * torch.arange(7.0)).sum().backward()      # the soft gradient
    assert logits.grad is not None and bool(logits.grad.abs().sum() > 0)
    soft = PF.gumbel_softmax(logits, temperature=0.5, generator=g)
    torch.testing.assert_close(soft.sum(-1), torch.ones(5))


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_softmax_casts_to_dtype(dtype):
    out = PF.softmax(torch.from_numpy(_x(2, 5)), dtype=dtype)
    assert out.dtype == getattr(torch, dtype)


def test_linear_bilinear_embedding_one_hot_match_jax():
    x, w, b = _x(3, 5), _x(5, 4, seed=1), _x(4, seed=2)
    _cmp("linear", [x, w, b])            # [in, out], Paddle's layout
    _cmp("bilinear", [_x(3, 2), _x(3, 4, seed=1), _x(5, 2, 4, seed=2),
                      _x(5, seed=3)])
    ids = np.array([[0, 3, 5], [5, 1, 1]])
    _cmp("embedding", [ids, _x(6, 4)], {"padding_idx": 1})
    _cmp("one_hot", [np.array([0, 4, 2, 7]), 5])  # 7: a zero row


def test_label_smooth_sequence_mask_normalize_distances():
    y = np.eye(5, dtype=np.float32)[[0, 3, 1]]
    _cmp("label_smooth", [y], {"epsilon": 0.2})
    _cmp("label_smooth", [y, np.full((1, 5), 0.2, np.float32)])
    lens = np.array([3, 0, 5])
    for kw in ({}, {"maxlen": 7, "dtype": "float32"},
               {"dtype": "int64"}):
        _cmp("sequence_mask", [lens], kw)
    _cmp("normalize", [_x(4, 6)], {"p": 1.0, "axis": 0})
    _cmp("normalize", [_x(4, 6)])
    _cmp("cosine_similarity", [_x(4, 6), _x(4, 6, seed=1)], {"axis": -1})
    _cmp("pairwise_distance", [_x(4, 6), _x(4, 6, seed=1)],
         {"p": 3.0, "keepdim": True})


@pytest.mark.parametrize("case", [
    ([1, 2], "constant", 1.5), ([0, 0, 1, 2, 2, 1], "constant", 0.0),
    ([1, 1, 0, 2], "reflect", 0.0), ([2, 0, 1, 1], "replicate", 0.0),
    ([1, 2, 2, 1], "circular", 0.0)])
def test_pad_matches_jax(case):
    pad, mode, value = case
    x = _x(2, 4, 5) if len(pad) == 6 else _x(2, 3, 4, 5)
    _cmp("pad", [x, pad], {"mode": mode, "value": value})
    if mode == "constant" and len(pad) == 2:
        _cmp("zeropad2d", [_x(2, 3, 4, 5), [1, 2, 0, 3]])


@pytest.mark.parametrize("mode,padding", [
    ("bilinear", "zeros"), ("bilinear", "border"), ("nearest", "zeros"),
    ("bilinear", "reflection")])
@pytest.mark.parametrize("align", [True, False])
def test_grid_sample_and_affine_grid_match_jax(mode, padding, align):
    theta = np.array([[[0.9, 0.2, 0.1], [-0.3, 1.1, -0.2]],
                      [[1.3, 0.0, 0.4], [0.1, 0.8, 0.3]]], np.float32)
    _cmp("affine_grid", [theta, [2, 3, 5, 6]], {"align_corners": align})
    grid = JF.affine_grid(pt.to_tensor(theta), [2, 3, 5, 6],
                          align_corners=align).numpy()
    _cmp("grid_sample", [_x(2, 3, 4, 7), grid],
         {"mode": mode, "padding_mode": padding, "align_corners": align})


def test_unfold_fold_temporal_shift_gather_tree_match_jax():
    x = _x(2, 3, 5, 6)
    _cmp("unfold", [x, [2, 3]], {"strides": [1, 2], "paddings": [1, 0]})
    _cmp("fold", [_x(2, 12, 42), [5, 6], 2], {"paddings": 1})
    _cmp("temporal_shift", [_x(6, 8, 2, 2), 3], {"shift_ratio": 0.25})
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 9, (4, 2, 3))
    parents = rng.integers(0, 3, (4, 2, 3))
    _cmp("gather_tree", [ids, parents])


def test_channel_dropouts():
    x = torch.ones(32, 64, 3, 3, 3)
    for fn in (PF.dropout2d, PF.dropout3d):
        xi = x if fn is PF.dropout3d else x[..., 0]
        out = fn(xi, 0.5, generator=torch.Generator().manual_seed(0))
        per = out.flatten(2)
        assert bool((per.amax(-1) == per.amin(-1)).all())
        assert abs(float((per[..., 0] == 0).float().mean()) - 0.5) < 0.03
        assert torch.equal(fn(xi, 0.5, training=False), xi)
    assert torch.equal(PF.alpha_dropout(x, 0.3, training=False), x)
