"""The port's `nn.functional.dropout` and `cross_entropy` against the JAX
package's, on the CPU.

dropout: the two packages draw their keep masks from different
generators, so the tests compare what does not depend on the draw: the
values a kept element takes in each mode (x / (1 - p), or x), the
inference result (exact), the keep pattern's structure under `axis` (the
port draws over those axes and broadcasts; the JAX package takes the
argument and draws every element), and the parameter order: the third
positional argument is `axis`, so `dropout(x, 0.5, None)` trains.

cross_entropy: logits and labels made with numpy from a seed go through
both; both compute log-softmax in float32 and sum in another order:
within 1e-6 (rtol and atol).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as PF

TOL = dict(rtol=1e-6, atol=1e-6)
P = 0.4


def _x(shape=(4, 6, 5), seed=0):
    return np.random.default_rng(seed).uniform(
        1.0, 2.0, shape).astype(np.float32)


def _port_dropout(x, *args, **kw):
    g = torch.Generator().manual_seed(0)
    return PF.dropout(torch.from_numpy(x), *args, generator=g, **kw).numpy()


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_modes_scale_as_the_jax_package(mode):
    """Training: kept elements are x / (1 - p) (upscale) or x (downscale)
    on both sides, dropped ones 0; inference: x, or x * (1 - p), equal to
    the JAX package's."""
    x = _x()
    scale = 1.0 / (1.0 - P) if mode == "upscale_in_train" else 1.0
    port = _port_dropout(x, P, mode=mode)
    ref = np.asarray(JF.dropout(pt.to_tensor(x), P, mode=mode)._array)
    for out in (port, ref):
        kept = out != 0
        assert 0 < kept.mean() < 1
        np.testing.assert_allclose(out[kept], x[kept] * np.float32(scale),
                                   **TOL)
    for out in (_port_dropout(x, P, training=False, mode=mode),
                np.asarray(JF.dropout(pt.to_tensor(x), P, training=False,
                                      mode=mode)._array)):
        want = x * np.float32(1 - P) if mode == "downscale_in_infer" else x
        np.testing.assert_allclose(out, want, **TOL)
    np.testing.assert_array_equal(
        _port_dropout(x, P, training=False, mode=mode),
        np.asarray(JF.dropout(pt.to_tensor(x), P, training=False,
                              mode=mode)._array))


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("axis", [1, [0, 2], -1])
def test_dropout_axis_draws_the_mask_over_its_axes(axis, mode):
    """With `axis`, the keep pattern is constant along the other axes and
    still mixes kept and dropped along the named ones; kept values scale
    as the mode says."""
    x = _x((6, 8, 7), seed=1)
    out = _port_dropout(x, P, axis, mode=mode)
    keep = out != 0
    axes = {a % 3 for a in ([axis] if isinstance(axis, int) else axis)}
    for a in set(range(3)) - axes:
        assert (keep == keep.take([0], axis=a)).all()
    assert 0 < keep.mean() < 1
    scale = 1.0 / (1.0 - P) if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(out[keep], x[keep] * np.float32(scale), **TOL)


def test_dropout_third_positional_argument_is_axis():
    """`dropout(x, 0.5, None)` trains in both packages (the third
    argument is `axis`): some elements drop, the rest double."""
    x = _x(seed=2)
    port = PF.dropout(torch.from_numpy(x), 0.5, None).numpy()
    ref = np.asarray(JF.dropout(pt.to_tensor(x), 0.5, None)._array)
    for out in (port, ref):
        kept = out != 0
        assert 0 < kept.mean() < 1
        np.testing.assert_allclose(out[kept], 2 * x[kept], **TOL)


def test_dropout_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        PF.dropout(torch.ones(3), 0.5, mode="scale")


CE_CASES = {
    # name: (logits shape, class axis, kwargs)
    "weight": ((6, 5), -1, dict(weight=True)),
    "weight_ignore": ((8, 4), -1, dict(weight=True, ignore_index=1)),
    "soft_label": ((6, 5), -1, dict(soft_label=True)),
    "soft_label_smoothing": ((6, 5), -1, dict(soft_label=True,
                                              label_smoothing=0.1)),
    "axis1": ((3, 5, 4), 1, {}),
    "axis1_soft": ((3, 5, 4), 1, dict(soft_label=True)),
    "smoothing": ((2, 7, 9), -1, dict(label_smoothing=0.2)),
    "smoothing_weight_axis0": ((5, 6), 0, dict(label_smoothing=0.1,
                                               weight=True)),
    "ignore_smoothing": ((10, 3), -1, dict(ignore_index=2,
                                           label_smoothing=0.05)),
}


def _ce_inputs(shape, axis, kw, seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    n = shape[axis]
    lshape = tuple(s for i, s in enumerate(shape) if i != axis % len(shape))
    if kw.get("soft_label"):
        lab = rng.random(shape).astype(np.float32)
        label = lab / lab.sum(axis=axis, keepdims=True)
    else:
        label = rng.integers(0, n, lshape).astype(np.int64)
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32) \
        if kw.get("weight") else None
    return logits, label, weight


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", sorted(CE_CASES))
def test_cross_entropy_matches_jax(name, reduction):
    shape, axis, kw = CE_CASES[name]
    logits, label, weight = _ce_inputs(shape, axis, kw, seed=len(name))
    args = {k: v for k, v in kw.items() if k != "weight"}
    port = PF.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label),
        weight=None if weight is None else torch.from_numpy(weight),
        reduction=reduction, axis=axis, **args)
    ref = JF.cross_entropy(
        pt.to_tensor(logits), pt.to_tensor(label),
        weight=None if weight is None else pt.to_tensor(weight),
        reduction=reduction, axis=axis, **args)
    ref = np.asarray(ref._array)
    assert tuple(port.shape) == ref.shape
    np.testing.assert_allclose(port.numpy(), ref, **TOL)


def test_cross_entropy_gradient_matches_jax():
    """The gradient of the weighted, smoothed mean loss with an ignored
    label, through autograd on both sides."""
    logits, label, weight = _ce_inputs((6, 5), -1, dict(weight=True), 7)
    label[2] = -100
    x = torch.from_numpy(logits).requires_grad_()
    PF.cross_entropy(x, torch.from_numpy(label),
                     weight=torch.from_numpy(weight),
                     label_smoothing=0.1).backward()
    jx = pt.to_tensor(logits, stop_gradient=False)
    JF.cross_entropy(jx, pt.to_tensor(label), weight=pt.to_tensor(weight),
                     label_smoothing=0.1).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jx.grad._array),
                               **TOL)
    assert not x.grad[2].any()
