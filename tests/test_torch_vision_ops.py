"""The port's detection ops (`paddle_tpu_torch.vision.ops`) against the
JAX package's (`paddle_tpu.vision.ops`), on the CPU.

The same seeded numpy inputs go through both: `box_iou`, `nms` (the kept
set exact, per class and with `top_k`), `roi_align` (sampling ratios,
aligned or not, a spatial scale), `roi_pool`, `psroi_pool`, their layers,
`box_coder` (encode and decode, each variance form and axis),
`distribute_fpn_proposals` and `generate_proposals`; the gradients of
`roi_align`, `roi_pool` and `psroi_pool` against the JAX package's tape.
Then the cases of `tests/test_vision_ops.py` on the port.
`test_torch_vision_ops_dcn_yolo.py` holds deformable convolution and
YOLOv3's ops.

Tolerances: float32 on both sides in the same formulas, summed in other
orders: values to 1e-5 relative with a 1e-5 floor (1e-4 for the
gradients); index outputs equal (the port's int64 against the JAX
package's int32).
"""
import numpy as np
import pytest
import torch

import torch_cpu_threads

import paddle_tpu as pt
from paddle_tpu.vision import ops as J
from paddle_tpu_torch.vision import ops as P

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


def test_box_iou_matches_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 6, 20, 20), _boxes(rng, 5, 20, 20)
    got = P.box_iou(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(
        got.numpy(), _np(J.box_iou(pt.to_tensor(a), pt.to_tensor(b))), **TOL)


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("with_scores", [True, False])
def test_nms_kept_set_matches_jax(thr, with_scores):
    rng = np.random.RandomState(int(thr * 10))
    boxes = _boxes(rng, 203, 60, 50)
    scores = rng.rand(203).astype(np.float32)
    scores[10:20] = scores[0]                   # ties keep index order
    kw = dict(iou_threshold=thr)
    jk = J.nms(pt.to_tensor(boxes),
               pt.to_tensor(scores) if with_scores else None, **kw)
    tk = P.nms(torch.from_numpy(boxes),
               torch.from_numpy(scores) if with_scores else None, **kw)
    assert tk.dtype == torch.int64
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    assert 0 < len(tk) < 203


@pytest.mark.parametrize("top_k", [None, 7])
def test_nms_per_class_matches_jax(top_k):
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, 150, 40, 40)
    scores = rng.rand(150).astype(np.float32)
    cls = rng.randint(0, 5, 150)
    kw = dict(iou_threshold=0.4, categories=list(range(5)), top_k=top_k)
    jk = J.nms(pt.to_tensor(boxes), pt.to_tensor(scores),
               category_idxs=pt.to_tensor(cls), **kw)
    tk = P.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
               category_idxs=torch.from_numpy(cls), **kw)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))


def test_nms_empty_and_single():
    assert P.nms(torch.zeros(0, 4)).shape == (0,)
    one = torch.tensor([[0.0, 0.0, 1.0, 1.0]])
    assert P.nms(one, torch.tensor([0.5])).tolist() == [0]


def _roi_inputs(seed=1, C=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, C, 12, 14).astype(np.float32)
    boxes = _boxes(rng, 5, 28, 24, min_size=0.5)
    boxes[4] = [-3.0, 20.0, 31.0, 27.0]          # past the map's edges
    return x, boxes, np.array([3, 2], np.int32)


@pytest.mark.parametrize("sampling_ratio", [-1, 1, 3])
@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_and_grad_match_jax(sampling_ratio, aligned):
    x, boxes, num = _roi_inputs()
    kw = dict(output_size=(3, 4), spatial_scale=0.5,
              sampling_ratio=sampling_ratio, aligned=aligned)
    jo, to, jg, tg = _grad_pair(
        lambda a: J.roi_align(a, pt.to_tensor(boxes), pt.to_tensor(num),
                              **kw),
        lambda a: P.roi_align(a, torch.from_numpy(boxes),
                              torch.from_numpy(num), **kw), [x])
    assert to.shape == (5, 3, 3, 4)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tg[0], jg[0], **GRAD_TOL)


@pytest.mark.parametrize("output_size", [2, (3, 2)])
def test_roi_pool_and_grad_match_jax(output_size):
    x, boxes, num = _roi_inputs(2)
    kw = dict(output_size=output_size, spatial_scale=0.5)
    jo, to, jg, tg = _grad_pair(
        lambda a: J.roi_pool(a, pt.to_tensor(boxes), pt.to_tensor(num),
                             **kw),
        lambda a: P.roi_pool(a, torch.from_numpy(boxes),
                             torch.from_numpy(num), **kw), [x])
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(tg[0], jg[0], **GRAD_TOL)


def test_roi_pool_chunks_give_the_same_result(monkeypatch):
    x, boxes, num = _roi_inputs(4)
    args = (torch.from_numpy(x), torch.from_numpy(boxes),
            torch.from_numpy(num), 3)
    whole = P.roi_pool(*args)
    monkeypatch.setattr(P, "_ROI_POOL_CHUNK", 1)     # one RoI a chunk
    np.testing.assert_array_equal(P.roi_pool(*args).numpy(), whole.numpy())


def test_psroi_pool_and_grad_match_jax():
    """The JAX package's psroi_pool selects its bins outside the tape (no
    gradient reaches x there); the gradient is held to the JAX tape's of
    its own formulation: RoIAlign with one unaligned sample a bin,
    weighted on the selected channel of each bin only."""
    x, boxes, num = _roi_inputs(5, C=2 * 3 * 3)
    jo = J.psroi_pool(pt.to_tensor(x), pt.to_tensor(boxes),
                      pt.to_tensor(num), 3, 0.5)
    xt = torch.tensor(x, requires_grad=True)
    to = P.psroi_pool(xt, torch.from_numpy(boxes), torch.from_numpy(num), 3,
                      0.5)
    assert to.shape == (5, 2, 3, 3)
    np.testing.assert_allclose(to.detach().numpy(), _np(jo), **TOL)
    w = np.random.RandomState(9).randn(5, 2, 3, 3).astype(np.float32)
    (to * torch.from_numpy(w)).sum().backward()
    w_full = np.zeros((5, 18, 3, 3), np.float32)
    for i in range(3):
        for j in range(3):
            w_full[:, i * 3 + j::9, i, j] = w[:, :, i, j]
    jx = pt.to_tensor(x)
    jx.stop_gradient = False
    pooled = J.roi_align(jx, pt.to_tensor(boxes), pt.to_tensor(num), 3, 0.5,
                         sampling_ratio=1, aligned=False)
    (pooled * pt.to_tensor(w_full)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(jx.grad), **GRAD_TOL)


@pytest.mark.parametrize("name", ["RoIAlign", "RoIPool", "PSRoIPool"])
def test_roi_layers_match_jax(name):
    x, boxes, num = _roi_inputs(6, C=8)
    jl, tl = getattr(J, name)(2, 0.5), getattr(P, name)(2, 0.5)
    got = tl(torch.from_numpy(x), torch.from_numpy(boxes),
             torch.from_numpy(num))
    want = jl(pt.to_tensor(x), pt.to_tensor(boxes), pt.to_tensor(num))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("var", ["none", "vector", "per_prior"])
@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_encode_decode_match_jax(var, normalized):
    rng = np.random.RandomState(7)
    priors = _boxes(rng, 6, 30, 30)
    targets = _boxes(rng, 4, 30, 30)
    v = {"none": None,
         "vector": np.array([0.1, 0.1, 0.2, 0.2], np.float32),
         "per_prior": rng.uniform(0.1, 0.3, (6, 4)).astype(np.float32)}[var]
    jv = None if v is None else pt.to_tensor(v)
    tv = None if v is None else torch.from_numpy(v)
    kw = dict(box_normalized=normalized)
    jenc = J.box_coder(pt.to_tensor(priors), jv, pt.to_tensor(targets), **kw)
    tenc = P.box_coder(torch.from_numpy(priors), tv,
                       torch.from_numpy(targets), **kw)
    np.testing.assert_allclose(tenc.numpy(), _np(jenc), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="code_type"):
        P.box_coder(torch.from_numpy(priors), None,
                    torch.from_numpy(targets), "center")
    deltas = rng.randn(4, 6, 4).astype(np.float32) * 0.2
    for axis in (0, 1):
        pr = priors if axis == 1 else priors[:4]
        vv = v if (v is None or v.ndim == 1 or axis == 1) else v[:4]
        d = deltas if axis == 1 else deltas[:, :4].transpose(1, 0, 2).copy()
        jdec = J.box_coder(pt.to_tensor(pr),
                           None if vv is None else pt.to_tensor(vv),
                           pt.to_tensor(d), "decode_center_size",
                           axis=axis, **kw)
        tdec = P.box_coder(torch.from_numpy(pr),
                           None if vv is None else torch.from_numpy(vv),
                           torch.from_numpy(d), "decode_center_size",
                           axis=axis, **kw)
        np.testing.assert_allclose(tdec.numpy(), _np(jdec), **TOL)
    if var == "per_prior":       # the JAX package's squeeze refuses these
        return
    two = rng.randn(6, 4).astype(np.float32) * 0.1       # [N, 4] deltas
    jdec = J.box_coder(pt.to_tensor(priors), jv, pt.to_tensor(two),
                       "decode_center_size", **kw)
    tdec = P.box_coder(torch.from_numpy(priors), tv, torch.from_numpy(two),
                       "decode_center_size", **kw)
    np.testing.assert_allclose(tdec.numpy(), _np(jdec), **TOL)


def test_distribute_fpn_proposals_matches_jax():
    rng = np.random.RandomState(13)
    rois = np.concatenate([_boxes(rng, 40, 800, 800, min_size=4),
                           _boxes(rng, 3, 30, 30, min_size=2)])
    jm, jr, jn = J.distribute_fpn_proposals(pt.to_tensor(rois), 2, 5, 4, 224)
    tm, tr, tn = P.distribute_fpn_proposals(torch.from_numpy(rois), 2, 5, 4,
                                            224)
    assert len(tm) == len(jm) == 4
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_array_equal(tr.numpy(), _np(jr))
    assert tr.dtype == torch.int64
    for a, b in zip(tn, jn):
        np.testing.assert_array_equal(a.numpy(), _np(b))
        assert a.dtype == torch.int32
    assert sum(int(n) for n in tn) == len(rois)


@pytest.mark.parametrize("nms_thresh", [0.5, 0.7])
def test_generate_proposals_matches_jax(nms_thresh):
    rng = np.random.RandomState(16)
    N, A, H, W = 2, 3, 6, 7
    scores = rng.randn(N, A, H, W).astype(np.float32)
    deltas = (rng.randn(N, 4 * A, H, W) * 0.3).astype(np.float32)
    cy, cx = np.meshgrid(np.arange(H) * 16.0 + 8, np.arange(W) * 16.0 + 8,
                         indexing="ij")
    sizes = np.array([16.0, 32.0, 64.0])
    half = np.broadcast_to(sizes / 2, (H, W, A))
    anchors = np.stack([cx[..., None] - half, cy[..., None] - half,
                        cx[..., None] + half, cy[..., None] + half],
                       -1).astype(np.float32)
    var = np.full((H, W, A, 4), 0.5, np.float32)
    img = np.array([[96, 112], [90, 100]], np.float32)
    kw = dict(pre_nms_top_n=80, post_nms_top_n=25, nms_thresh=nms_thresh,
              min_size=2.0)
    jr, js, jn = J.generate_proposals(
        pt.to_tensor(scores), pt.to_tensor(deltas), pt.to_tensor(img),
        pt.to_tensor(anchors), pt.to_tensor(var), **kw)
    tr, ts, tn = P.generate_proposals(
        torch.from_numpy(scores), torch.from_numpy(deltas),
        torch.from_numpy(img), torch.from_numpy(anchors),
        torch.from_numpy(var), **kw)
    np.testing.assert_array_equal(tn.numpy(), _np(jn))
    np.testing.assert_allclose(tr.numpy(), _np(jr), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)
    assert tn.dtype == torch.int32 and int(tn.sum()) == tr.shape[0]
    rois, sc = P.generate_proposals(
        torch.from_numpy(scores), torch.from_numpy(deltas),
        torch.from_numpy(img), torch.from_numpy(anchors),
        torch.from_numpy(var), return_rois_num=False, **kw)
    np.testing.assert_array_equal(rois.numpy(), tr.numpy())


# ------------------------------------- the JAX package's cases, on the port
def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_reference_cases_box_iou_and_nms():
    a = _t([[0, 0, 2, 2], [1, 1, 3, 3]])
    iou = P.box_iou(a, a).numpy()
    np.testing.assert_allclose(np.diag(iou), [1.0, 1.0], rtol=1e-5)
    np.testing.assert_allclose(iou[0, 1], 1 / 7, rtol=1e-4)
    boxes = _t([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30],
                [0, 0, 10, 10]])
    keep = P.nms(boxes, _t([0.9, 0.8, 0.7, 0.1]), iou_threshold=0.5)
    assert keep.tolist() == [0, 2]
    boxes, scores = boxes[[0, 1, 3]], _t([0.9, 0.8, 0.7])
    cidx = torch.tensor([0, 1, 0])
    assert P.nms(boxes, scores, 0.5, category_idxs=cidx,
                 categories=[0, 1]).tolist() == [0, 1]
    assert P.nms(boxes, scores, 0.5, category_idxs=cidx, categories=[0, 1],
                 top_k=1).tolist() == [0]


def test_reference_cases_roi_ops():
    x = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4)
    one = torch.tensor([1])
    out = P.roi_align(x, _t([[0, 0, 4, 4]]), one, output_size=4,
                      sampling_ratio=1, aligned=True)
    np.testing.assert_allclose(out.numpy()[0, 0], x.numpy()[0, 0],
                               rtol=1e-4)
    two = torch.zeros(2, 1, 4, 4)
    two[0] += 1.0
    two[1] += 5.0
    out = P.roi_align(two, _t([[0, 0, 4, 4]] * 2), torch.tensor([1, 1]), 2)
    np.testing.assert_allclose(out.numpy()[0], 1.0, rtol=1e-5)
    np.testing.assert_allclose(out.numpy()[1], 5.0, rtol=1e-5)
    out = P.roi_pool(x, _t([[0, 0, 4, 4]]), one, output_size=2)
    np.testing.assert_allclose(out.numpy()[0, 0], [[5, 7], [13, 15]])
    out = P.roi_pool(x, _t([[0, 0, 4, 8]]), one, output_size=2)
    assert out.min() >= 0.0
    xg = torch.randn(1, 2, 8, 8, requires_grad=True)
    P.roi_align(xg, _t([[1, 1, 6, 6]]), one, 3).sum().backward()
    assert xg.grad.abs().sum() > 0


def test_reference_cases_box_coder():
    priors = _t([[0, 0, 10, 10], [5, 5, 15, 15]])
    targets = _t([[1, 1, 9, 9], [6, 4, 14, 16]])
    enc = P.box_coder(priors, None, targets)
    dec = P.box_coder(priors, None, enc, code_type="decode_center_size",
                      axis=1).numpy()
    np.testing.assert_allclose(dec[0, 0], targets.numpy()[0], atol=1e-4)
    np.testing.assert_allclose(dec[1, 1], targets.numpy()[1], atol=1e-4)
    enc = P.box_coder(priors[:1], None, targets[:1])
    assert tuple(enc.shape) == (1, 1, 4)
    dec = P.box_coder(priors[:1], None, enc, code_type="decode_center_size")
    assert tuple(dec.shape) == (1, 1, 4)
