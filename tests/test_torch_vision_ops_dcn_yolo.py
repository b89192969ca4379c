"""Deformable convolution and YOLOv3's ops of the port
(`paddle_tpu_torch.vision.ops`) against the JAX package's, on the CPU.

The same seeded numpy inputs go through both: `deform_conv2d` (v1, v2
with a mask and a bias, deformable groups with groups and a stride,
dilation) with its gradients to the input, the offsets, the mask and the
weight, `DeformConv2D` carrying the JAX layer's weights, `yolo_box`
(clipped or not, `scale_x_y`) and `yolo_loss` (label smoothing, gt
scores, `scale_x_y`, a contested cell) with its gradient to the head.
Then the cases of `tests/test_deform_affine.py` (its deformable half)
and `tests/test_yolo_loss.py` on the port.

Tolerances: float32 on both sides in the same formulas, summed in other
orders: 1e-4 relative with a 1e-4 floor for deformable convolution's
contraction, the losses and every gradient; the decoded boxes 1e-5
relative with a 1e-4 floor (pixels of a few hundred), the scores 1e-5.
"""
import numpy as np
import pytest
import torch

import torch_cpu_threads

import paddle_tpu as pt
from paddle_tpu.vision import ops as J
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision import ops as P
from paddle_tpu_torch.weights import load_paddle_tpu_state

torch_cpu_threads.limit()

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t._array if hasattr(t, "_array") else t)


def _boxes(rng, n, w, h, min_size=1.0):
    x1 = rng.uniform(0, w - min_size, n)
    y1 = rng.uniform(0, h - min_size, n)
    x2 = np.minimum(x1 + rng.uniform(min_size, w / 2, n), w)
    y2 = np.minimum(y1 + rng.uniform(min_size, h / 2, n), h)
    return np.stack([x1, y1, x2, y2], 1).astype(np.float32)


def _grad_pair(j_fn, t_fn, arrays, seed=9):
    """Outputs and the gradients of sum(out * w) with respect to every
    array, through the JAX tape and through torch's autograd."""
    jt = [pt.to_tensor(a) for a in arrays]
    tt = [torch.tensor(a, requires_grad=True) for a in arrays]
    for t in jt:
        t.stop_gradient = False
    jo, to = j_fn(*jt), t_fn(*tt)
    w = np.random.RandomState(seed).randn(*to.shape).astype(np.float32)
    (jo * pt.to_tensor(w)).sum().backward()
    (to * torch.from_numpy(w)).sum().backward()
    return (_np(jo), _np(to), [_np(t.grad) for t in jt],
            [t.grad.numpy() for t in tt])


DEFORM_CASES = {
    "v1": dict(stride=1, padding=1, dilation=1, dg=1, groups=1, mask=False,
               bias=False),
    "v2_bias": dict(stride=1, padding=1, dilation=1, dg=1, groups=1,
                    mask=True, bias=True),
    "groups": dict(stride=2, padding=1, dilation=1, dg=2, groups=2,
                   mask=True, bias=True),
    "dilated": dict(stride=1, padding=2, dilation=2, dg=2, groups=1,
                    mask=True, bias=False),
}


@pytest.mark.parametrize("name", sorted(DEFORM_CASES))
def test_deform_conv2d_and_grads_match_jax(name):
    c = DEFORM_CASES[name]
    rng = np.random.RandomState(11)
    N, Cin, H, W, Cout, k = 2, 4, 9, 8, 6, 3
    Ho = (H + 2 * c["padding"] - c["dilation"] * (k - 1) - 1) \
        // c["stride"] + 1
    Wo = (W + 2 * c["padding"] - c["dilation"] * (k - 1) - 1) \
        // c["stride"] + 1
    x = rng.randn(N, Cin, H, W).astype(np.float32)
    off = (rng.randn(N, 2 * c["dg"] * k * k, Ho, Wo) * 1.5).astype(
        np.float32)
    w = rng.randn(Cout, Cin // c["groups"], k, k).astype(np.float32) * 0.3
    arrays = [x, off, w]
    if c["mask"]:
        arrays.append(rng.rand(N, c["dg"] * k * k, Ho, Wo).astype(
            np.float32))
    bias = rng.randn(Cout).astype(np.float32) if c["bias"] else None
    kw = dict(stride=c["stride"], padding=c["padding"],
              dilation=c["dilation"], deformable_groups=c["dg"],
              groups=c["groups"])

    def run(mod, to_t):
        def f(x_, o_, w_, *m):
            return mod.deform_conv2d(
                x_, o_, w_, None if bias is None else to_t(bias),
                mask=m[0] if m else None, **kw)
        return f

    jo, to, jg, tg = _grad_pair(run(J, pt.to_tensor),
                                run(P, torch.from_numpy), arrays)
    assert to.shape == (N, Cout, Ho, Wo)
    np.testing.assert_allclose(to, jo, **GRAD_TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_deform_conv_layer_carries_jax_weights():
    pt.seed(2)
    jl = J.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2)
    tl = P.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2,
                        device="cpu")
    load_paddle_tpu_state(tl, {k: _np(v) for k, v in
                               jl.state_dict().items()})
    rng = np.random.RandomState(12)
    x = rng.randn(2, 4, 7, 7).astype(np.float32)
    off = rng.randn(2, 36, 7, 7).astype(np.float32)
    mask = rng.rand(2, 18, 7, 7).astype(np.float32)
    got = tl(torch.from_numpy(x), torch.from_numpy(off),
             torch.from_numpy(mask))
    want = jl(pt.to_tensor(x), pt.to_tensor(off), pt.to_tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **GRAD_TOL)
    assert P.DeformConv2D(4, 6, 3, bias_attr=False, device="cpu").bias \
        is None


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("scale_x_y", [1.0, 1.05])
def test_yolo_box_matches_jax(clip, scale_x_y):
    rng = np.random.RandomState(14)
    anchors, cls = [10, 13, 16, 30, 33, 23], 4
    x = rng.randn(2, 3 * (5 + cls), 5, 6).astype(np.float32)
    img = np.array([[160, 192], [150, 180]], np.int32)
    kw = dict(anchors=anchors, class_num=cls, conf_thresh=0.4,
              downsample_ratio=32, clip_bbox=clip, scale_x_y=scale_x_y)
    jb, js = J.yolo_box(pt.to_tensor(x), pt.to_tensor(img), **kw)
    tb, ts = P.yolo_box(torch.from_numpy(x), torch.from_numpy(img), **kw)
    np.testing.assert_allclose(tb.numpy(), _np(jb), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)
    with pytest.raises(NotImplementedError, match="iou_aware"):
        P.yolo_box(torch.from_numpy(x), torch.from_numpy(img), iou_aware=True,
                   **kw)


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("score", [False, True])
@pytest.mark.parametrize("scale_x_y", [1.0, 1.1])
def test_yolo_loss_and_grad_match_jax(smooth, score, scale_x_y):
    rng = np.random.RandomState(15)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    mask, cls, H, W = [2, 3, 4], 5, 6, 7
    x = (rng.randn(2, 3 * (5 + cls), H, W) * 0.7).astype(np.float32)
    gt = np.zeros((2, 6, 4), np.float32)
    gt[:, :5, :2] = rng.uniform(0.05, 0.95, (2, 5, 2))
    gt[:, :5, 2:] = rng.uniform(0.03, 0.5, (2, 5, 2))
    gt[1, 3] = gt[1, 2] + [0.01, 0.0, 0.0, 0.0]          # a contested cell
    label = rng.randint(0, cls, (2, 6)).astype(np.int32)
    gs = rng.uniform(0.3, 1.0, (2, 6)).astype(np.float32) if score else None
    kw = dict(anchors=anchors, anchor_mask=mask, class_num=cls,
              ignore_thresh=0.5, downsample_ratio=16,
              use_label_smooth=smooth, scale_x_y=scale_x_y)
    jo, to, jg, tg = _grad_pair(
        lambda a: J.yolo_loss(a, pt.to_tensor(gt), pt.to_tensor(label),
                              gt_score=None if gs is None
                              else pt.to_tensor(gs), **kw),
        lambda a: P.yolo_loss(a, torch.from_numpy(gt),
                              torch.from_numpy(label),
                              gt_score=None if gs is None
                              else torch.from_numpy(gs), **kw), [x])
    assert to.shape == (2,)
    np.testing.assert_allclose(to, jo, **GRAD_TOL)
    np.testing.assert_allclose(tg[0], jg[0], **GRAD_TOL)


def test_reference_cases_deform_conv():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 4, 8, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(6, 4, 3, 3).astype(np.float32))
    got = P.deform_conv2d(x, torch.zeros(2, 18, 8, 8), w, padding=1)
    np.testing.assert_allclose(got.numpy(), PF.conv2d(x, w, padding=1)
                               .numpy(), rtol=2e-4, atol=2e-4)
    off = torch.zeros(2, 18, 8, 8)
    off[:, 1::2] = 1.0                       # +1 x-shift for every tap
    got = P.deform_conv2d(x, off, w, padding=1).numpy()
    xs = torch.zeros_like(x)
    xs[:, :, :, :-1] = x[:, :, :, 1:]
    want = PF.conv2d(xs, w, padding=1).numpy()
    np.testing.assert_allclose(got[:, :, 1:-1, 1:-2], want[:, :, 1:-1, 1:-2],
                               rtol=2e-4, atol=2e-4)
    layer = P.DeformConv2D(4, 6, 3, padding=1, device="cpu")
    xg = torch.randn(2, 4, 8, 8, requires_grad=True)
    og = torch.zeros(2, 18, 8, 8, requires_grad=True)
    out = layer(xg, og, torch.ones(2, 9, 8, 8))
    assert out.shape == (2, 6, 8, 8)
    out.mean().backward()
    assert xg.grad is not None and og.grad is not None
    assert layer.weight.grad is not None


YOLO_ANCHORS, YOLO_MASK, YOLO_CLS, YH = [10, 13, 16, 30, 33, 23], [0, 1, 2], \
    4, 8


def _yolo(x, gt_box, gt_label, **kw):
    t = torch.tensor(x, requires_grad=True)
    return t, P.yolo_loss(t, gt_box, gt_label, anchors=YOLO_ANCHORS,
                          anchor_mask=YOLO_MASK, class_num=YOLO_CLS,
                          ignore_thresh=0.7, downsample_ratio=32, **kw)


def _yolo_gt(cx, cy, w, h, label):
    gt_box = np.zeros((2, 3, 4), np.float32)
    gt_label = np.zeros((2, 3), np.int64)
    gt_box[:, 0] = [cx, cy, w, h]
    gt_label[:, 0] = label
    return gt_box, gt_label


def _yolo_head(seed=0, scale=0.01):
    return (np.random.RandomState(seed).randn(2, 27, YH, YH)
            * scale).astype(np.float32)


def test_reference_cases_yolo_loss():
    gt_box, gt_label = _yolo_gt(0.5, 0.5, 0.2, 0.3, 2)
    t, loss = _yolo(_yolo_head(), gt_box, gt_label)
    assert loss.shape == (2,)
    loss.sum().backward()
    assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    # a perfect prediction pays the x / y entropy floor only
    aw, ah = YOLO_ANCHORS[2], YOLO_ANCHORS[3]
    gw, gh = aw / (YH * 32), ah / (YH * 32)
    gt_box, gt_label = _yolo_gt(4.5 / YH, 4.5 / YH, gw, gh, 1)
    x = np.full((2, 27, YH, YH), -12.0, np.float32)
    x[:, 9:13, 4, 4] = 0.0
    x[:, 13, 4, 4] = 12.0
    x[:, 15, 4, 4] = 12.0
    _, loss = _yolo(x, gt_box, gt_label, use_label_smooth=False)
    floor = 2.0 * np.log(2.0) * (2.0 - gw * gh)
    assert (np.abs(loss.detach().numpy() - floor) < 0.05).all()
    # a worse head pays more; padding gts leave only the noobj term
    gt_box, gt_label = _yolo_gt(0.55, 0.55, 0.15, 0.2, 3)
    assert float(_yolo(_yolo_head(0, 3.0), gt_box, gt_label)[1].sum()) > \
        float(_yolo(_yolo_head(0, 0.01), gt_box, gt_label)[1].sum())
    _, loss = _yolo(np.full((2, 27, YH, YH), -12.0, np.float32),
                    np.zeros((2, 3, 4), np.float32), np.zeros((2, 3)))
    assert (loss.detach().numpy() < 0.01).all()
    # scores scale the positives
    gt_box, gt_label = _yolo_gt(0.5, 0.5, 0.2, 0.3, 2)
    full = _yolo(_yolo_head(1, 0.5), gt_box, gt_label,
                 gt_score=np.ones((2, 3), np.float32))[1].sum()
    half = _yolo(_yolo_head(1, 0.5), gt_box, gt_label,
                 gt_score=np.full((2, 3), 0.5, np.float32))[1].sum()
    assert float(half) < float(full)


def test_reference_cases_yolo_loss_overfits_one_target():
    from paddle_tpu_torch.optimizer import Adam
    gt_box, gt_label = _yolo_gt(0.4, 0.6, 0.25, 0.25, 0)
    t = torch.nn.Parameter(torch.from_numpy(_yolo_head(3, 0.1)))
    opt = Adam(learning_rate=0.05, parameters=[t])
    first = None
    for _ in range(60):
        loss = P.yolo_loss(t, gt_box, gt_label, anchors=YOLO_ANCHORS,
                           anchor_mask=YOLO_MASK, class_num=YOLO_CLS,
                           ignore_thresh=0.7, downsample_ratio=32).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        first = float(loss) if first is None else first
    assert float(loss) < first * 0.25, (first, float(loss))
