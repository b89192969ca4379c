"""The port's losses (the functional ones and the 17 + 3 loss layers)
against the JAX package's, on the CPU.

Every loss runs the same numpy inputs through both packages, under each
reduction it takes; the class-weighted, ignore_index and label-smoothed
forms of the cross entropies, and the gradient of a few with respect to
their input.

Tolerances.  float32: rtol 1e-5, atol 1e-5 (the same formulas in another
order); CTC 1e-4 relative: the JAX kernel runs the alpha recursion in
log space with a -1e30 floor, torch's its own recursion.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as PF

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(0)


def _x(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _pos(*shape, seed=0):
    return np.random.default_rng(seed).uniform(0.05, 0.95, shape).astype(
        np.float32)


def _j(a):
    return pt.to_tensor(a) if isinstance(a, np.ndarray) else a


def _t(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def _close(to, jo, tol=TOL):
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), **tol)


LABELS = np.array([0, 3, 2, 4, 1, 3])
SIGN = np.array([1.0, -1.0, 1.0, 1.0, -1.0, -1.0], np.float32)
CASES = {
    "mse_loss": ([_x(6, 4), _x(6, 4, seed=1)], {}),
    "l1_loss": ([_x(6, 4), _x(6, 4, seed=1)], {}),
    "smooth_l1_loss": ([_x(6, 4, scale=2.0), _x(6, 4, seed=1)],
                       {"delta": 0.7}),
    "nll_loss": ([np.log(_pos(6, 5)), LABELS], {}),
    "binary_cross_entropy": ([_pos(6, 4), (_pos(6, 4, seed=1) > 0.5)
                              .astype(np.float32)], {}),
    "binary_cross_entropy_with_logits": (
        [_x(6, 4, scale=4.0), _pos(6, 4, seed=1)], {}),
    "kl_div": ([np.log(_pos(6, 4)), _pos(6, 4, seed=1)], {}),
    "soft_margin_loss": ([_x(6), SIGN], {}),
    "hinge_embedding_loss": ([_x(6), SIGN], {"margin": 0.5}),
    "poisson_nll_loss": ([_x(6, 3), _pos(6, 3, seed=1) * 4], {}),
    "gaussian_nll_loss": ([_x(6, 3), _x(6, 3, seed=1), _pos(6, 3, seed=2)],
                          {}),
    "multi_label_soft_margin_loss": ([_x(6, 4), (_pos(6, 4, seed=1) > 0.5)
                                      .astype(np.float32)], {}),
    "margin_ranking_loss": ([_x(6), _x(6, seed=1), SIGN], {"margin": 0.2}),
    "cosine_embedding_loss": ([_x(6, 4), _x(6, 4, seed=1), SIGN],
                              {"margin": 0.1}),
    "triplet_margin_loss": ([_x(6, 4), _x(6, 4, seed=1), _x(6, 4, seed=2)],
                            {"swap": True}),
    "triplet_margin_with_distance_loss": (
        [_x(6, 4), _x(6, 4, seed=1), _x(6, 4, seed=2)], {"margin": 0.5}),
    "multi_margin_loss": ([_x(6, 5), LABELS], {"p": 2, "margin": 0.5}),
}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name, reduction):
    args, kw = CASES[name]
    kw = dict(kw, reduction=reduction)
    _close(getattr(PF, name)(*map(_t, args), **kw),
           getattr(JF, name)(*map(_j, args), **kw))


@pytest.mark.parametrize("name,kw", [
    ("poisson_nll_loss", {"log_input": False, "full": True}),
    ("gaussian_nll_loss", {"full": True}),
    ("binary_cross_entropy_with_logits", {"pos_weight": np.array(
        [0.5, 2.0, 1.0, 3.0], np.float32)}),
    ("binary_cross_entropy_with_logits", {"weight": np.array(
        [0.5, 2.0, 1.0, 3.0], np.float32)}),
    ("binary_cross_entropy", {"weight": np.full((6, 4), 0.3, np.float32)}),
    ("nll_loss", {"weight": np.array([1.0, 2.0, 0.5, 1.5, 3.0],
                                     np.float32), "ignore_index": 3}),
    ("kl_div", {"reduction": "batchmean"}),
    ("multi_margin_loss", {"weight": np.array([1.0, 2.0, 0.5, 1.5, 3.0],
                                              np.float32)}),
    ("multi_label_soft_margin_loss", {"weight": np.array(
        [1.0, 2.0, 0.5, 1.5], np.float32)}),
])
def test_loss_options_match_jax(name, kw):
    args = CASES[name][0]
    if name == "poisson_nll_loss":
        args = [np.abs(args[0]) + 0.1, args[1]]
    _close(getattr(PF, name)(*map(_t, args), **{k: _t(v) for k, v in
                                                 kw.items()}),
           getattr(JF, name)(*map(_j, args), **{k: _j(v) for k, v in
                                                kw.items()}))


@pytest.mark.parametrize("smoothing", [0.0, 0.2])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_layer_matches_jax(reduction, weighted, smoothing):
    logits, labels = _x(6, 5, scale=2.0), LABELS.copy()
    labels[2] = -100
    w = np.array([1.0, 2.0, 0.5, 1.5, 3.0], np.float32) if weighted \
        else None
    kw = dict(reduction=reduction, label_smoothing=smoothing)
    jl = pt.nn.CrossEntropyLoss(weight=_j(w), **kw)
    tl = tnn.CrossEntropyLoss(weight=_t(w), **kw)
    _close(tl(_t(logits), _t(labels)), jl(_j(logits), _j(labels)))


def test_soft_label_and_softmax_with_cross_entropy_match_jax():
    logits = _x(6, 5)
    soft = _pos(6, 5, seed=1)
    soft /= soft.sum(-1, keepdims=True)
    _close(PF.cross_entropy(_t(logits), _t(soft), soft_label=True),
           JF.cross_entropy(_j(logits), _j(soft), soft_label=True))
    _close(PF.softmax_with_cross_entropy(_t(logits), _t(LABELS[:, None])),
           JF.softmax_with_cross_entropy(_j(logits), _j(LABELS[:, None])))
    _close(PF.softmax_with_cross_entropy(_t(logits), _t(soft),
                                         soft_label=True),
           JF.softmax_with_cross_entropy(_j(logits), _j(soft),
                                         soft_label=True))


def test_small_losses_match_jax():
    p, y = _pos(6, 4), (_pos(6, 4, seed=1) > 0.5).astype(np.float32)
    _close(PF.square_error_cost(_t(p), _t(y)),
           JF.square_error_cost(_j(p), _j(y)))
    _close(PF.log_loss(_t(p), _t(y)), JF.log_loss(_j(p), _j(y)))
    probs = _pos(3, 4, 5)
    lab = np.random.default_rng(2).integers(0, 5, (3, 4, 1))
    _close(PF.dice_loss(_t(probs), _t(lab)), JF.dice_loss(_j(probs),
                                                          _j(lab)))
    a, b = _x(6, 4), _x(6, 4, seed=1)
    lab6 = np.array([0, 1, 0, 2, 1, 2])
    _close(PF.npair_loss(_t(a), _t(b), _t(lab6)),
           JF.npair_loss(_j(a), _j(b), _j(lab6)))
    for red, norm in (("sum", None), ("mean", np.array(3.0, np.float32))):
        _close(PF.sigmoid_focal_loss(_t(a), _t(y[:, :4]), _t(norm),
                                     reduction=red),
               JF.sigmoid_focal_loss(_j(a), _j(y[:, :4]), _j(norm),
                                     reduction=red))


@pytest.mark.parametrize("num_classes", [6, 8])
def test_hsigmoid_matches_jax(num_classes):
    x = _x(5, 4)
    lab = np.array([0, 5, 2, 3, 1])
    w, b = _x(num_classes - 1, 4, seed=1), _x(num_classes - 1, seed=2)
    _close(PF.hsigmoid_loss(_t(x), _t(lab), num_classes, _t(w), _t(b)),
           JF.hsigmoid_loss(_j(x), _j(lab), num_classes, _j(w), _j(b)))
    layer = tnn.HSigmoidLoss(4, num_classes, device="cpu")
    jlayer = pt.nn.HSigmoidLoss(4, num_classes)
    with torch.no_grad():
        layer.weight.copy_(_t(w))
        layer.bias.copy_(_t(b))
    jlayer.weight.set_value(_j(w))
    jlayer.bias.set_value(_j(b))
    _close(layer(_t(x), _t(lab)), jlayer(_j(x), _j(lab)))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_matches_jax(reduction):
    T, B, C, S = 12, 3, 6, 4
    logits = _x(T, B, C, scale=2.0)
    labels = np.random.default_rng(3).integers(1, C, (B, S))
    in_lens, lab_lens = np.array([12, 10, 9]), np.array([4, 2, 3])
    kw = dict(blank=0, reduction=reduction)
    _close(PF.ctc_loss(*map(_t, (logits, labels, in_lens, lab_lens)), **kw),
           JF.ctc_loss(*map(_j, (logits, labels, in_lens, lab_lens)), **kw),
           dict(rtol=1e-4, atol=1e-4))
    layer = tnn.CTCLoss(reduction=reduction)
    _close(layer(*map(_t, (logits, labels, in_lens, lab_lens)),
                 norm_by_times=True),
           pt.nn.CTCLoss(reduction=reduction)(
               *map(_j, (logits, labels, in_lens, lab_lens)),
               norm_by_times=True), dict(rtol=1e-4, atol=1e-4))


LAYERS = {
    "MSELoss": ({}, "mse_loss"), "L1Loss": ({}, "l1_loss"),
    "SmoothL1Loss": ({"delta": 0.5}, "smooth_l1_loss"),
    "NLLLoss": ({"ignore_index": 2}, "nll_loss"),
    "BCELoss": ({}, "binary_cross_entropy"),
    "BCEWithLogitsLoss": ({}, "binary_cross_entropy_with_logits"),
    "KLDivLoss": ({"reduction": "sum"}, "kl_div"),
    "MarginRankingLoss": ({"margin": 0.3}, "margin_ranking_loss"),
    "CosineEmbeddingLoss": ({"margin": 0.2}, "cosine_embedding_loss"),
    "TripletMarginLoss": ({"p": 1.0}, "triplet_margin_loss"),
    "TripletMarginWithDistanceLoss": ({"swap": True},
                                      "triplet_margin_with_distance_loss"),
    "SoftMarginLoss": ({}, "soft_margin_loss"),
    "HingeEmbeddingLoss": ({"margin": 2.0}, "hinge_embedding_loss"),
    "PoissonNLLLoss": ({}, "poisson_nll_loss"),
    "GaussianNLLLoss": ({"full": True}, "gaussian_nll_loss"),
    "MultiLabelSoftMarginLoss": ({}, "multi_label_soft_margin_loss"),
    "MultiMarginLoss": ({"margin": 2.0}, "multi_margin_loss"),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_loss_layer_matches_jax(name):
    kw, fn = LAYERS[name]
    args = CASES[fn][0]
    _close(getattr(tnn, name)(**kw)(*map(_t, args)),
           getattr(pt.nn, name)(**kw)(*map(_j, args)))


@pytest.mark.parametrize("name", ["smooth_l1_loss", "kl_div",
                                  "binary_cross_entropy_with_logits",
                                  "cross_entropy"])
def test_loss_gradient_matches_jax(name):
    args = (CASES[name][0] if name in CASES
            else [_x(6, 5), LABELS])
    ta = _t(args[0].copy()).requires_grad_()
    getattr(PF, name)(ta, *map(_t, args[1:])).backward()
    ja = _j(args[0])
    ja.stop_gradient = False
    getattr(JF, name)(ja, *map(_j, args[1:])).backward()
    _close(ta.grad, ja.grad)
