"""Detection ops (counterpart: `paddle_tpu/vision/ops.py`; reference:
python/paddle/vision/ops.py): box IoU and NMS, RoIAlign, RoIPool,
PSRoIPool, the box coder, deformable convolution v1 / v2, the FPN level
assignment, YOLOv3's box decoder and loss, and RPN proposals.

The JAX package writes each as a plain `jnp` program (no Pallas kernel);
here each is torch ops on its inputs' device in the same formula, and
the gradients (`roi_align`, `roi_pool`, `psroi_pool`, `deform_conv2d`,
`yolo_loss` with respect to `x`) are torch's autograd over it, where the
JAX package registers the functions with its op table (`ops.register`,
`_engine.apply`).

Intended divergences (ROADMAP.md C): index outputs (`nms`, the restore
index of `distribute_fpn_proposals`) are int64 where the JAX package
gives int32; `nms` runs its greedy pass on the host over suppression
bits from the device (see `nms`), and `generate_proposals` and
`distribute_fpn_proposals` stay on the device where the reference
computes them in numpy: the same boxes in the same order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn import initializer as I
from ..nn.common import _attr_init, _kw
from ..nn.layer import Layer

__all__ = ["nms", "roi_align", "roi_pool", "box_coder", "box_iou",
           "deform_conv2d", "DeformConv2D", "yolo_box", "yolo_loss"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _div(a, b):
    """a / b correctly rounded on every device: CUDA divides a tensor by
    a Python number as a product with its reciprocal (one rounding
    more), which moves a bin edge of `roi_pool` across an integer and a
    level edge of `distribute_fpn_proposals` across a power of two."""
    return a / torch.full((), float(b), dtype=a.dtype, device=a.device)


def _as(x, like):
    """`x` as a tensor on `like`'s device (numbers and lists in
    `like`'s dtype)."""
    if isinstance(x, torch.Tensor):
        return x.to(like.device)
    return torch.as_tensor(np.asarray(x), device=like.device)


# ------------------------------------------------------------------ box iou
def box_iou(boxes_a, boxes_b):
    """[N, 4] x [M, 4] (x1, y1, x2, y2) -> [N, M] IoU."""
    area_a = ((boxes_a[:, 2] - boxes_a[:, 0])
              * (boxes_a[:, 3] - boxes_a[:, 1]))
    area_b = ((boxes_b[:, 2] - boxes_b[:, 0])
              * (boxes_b[:, 3] - boxes_b[:, 1]))
    lt = torch.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    rb = torch.minimum(boxes_a[:, None, 2:], boxes_b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp(min=1e-9)


# ---------------------------------------------------------------------- nms
@torch.no_grad()
def nms(boxes, scores=None, iou_threshold=0.3, category_idxs=None,
        categories=None, top_k=None):
    """Greedy non-maximum suppression: the kept indices (int64, on the
    boxes' device) in descending score order; ties keep index order.
    With `category_idxs` and `categories` boxes of different classes
    never suppress each other (each class shifted to a disjoint region,
    as the reference does); `top_k` keeps the first k.

    Cost: one [n, n] IoU matrix on the device, its suppression bits
    (IoU > threshold) packed 8 to a byte and copied to the host once
    (n^2 / 8 bytes: 4.5 MB at n = 6,000), then the greedy pass in numpy,
    one row OR for each kept box.  That is a fixed handful of launches
    and one host read a call, where an eager loop over the n boxes
    would launch about 3 kernels a box."""
    n = boxes.shape[0]
    device = boxes.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    s = (scores.to(device) if scores is not None
         else torch.arange(n, 0, -1, dtype=torch.float32, device=device))
    b = boxes
    if category_idxs is not None and categories is not None:
        cidx = _as(category_idxs, b).to(torch.float32)
        span = (b.max() - b.min()).clamp(min=1.0) + 1.0
        b = b + (cidx * span)[:, None]
    order = torch.argsort(-s, stable=True)
    bs = b[order]
    sup = box_iou(bs, bs) > float(iou_threshold)
    pad = (-n) % 8
    if pad:
        sup = torch.nn.functional.pad(sup, (0, pad))
    weights = (1 << torch.arange(8, device=device)).to(torch.uint8)
    packed = (sup.view(n, -1, 8).to(torch.uint8) * weights).sum(
        -1, dtype=torch.uint8)
    bits = np.unpackbits(packed.cpu().numpy(), axis=1,
                         bitorder="little")[:, :n].astype(bool)
    removed = np.zeros(n, bool)
    kept = []
    for i in range(n):
        if not removed[i]:
            kept.append(i)
            removed |= bits[i]
    kept = torch.as_tensor(kept, dtype=torch.int64)
    if top_k is not None:
        kept = kept[:int(top_k)]
    return order[kept.to(device)]


# ---------------------------------------------------------------- roi align
def _batch_index(boxes_num, n_images, n_rois, device):
    """The image of each RoI, from the RoIs an image (no host read)."""
    counts = _as(boxes_num, torch.empty(0, device=device)).reshape(-1)
    return torch.repeat_interleave(
        torch.arange(n_images, device=device), counts.to(torch.int64),
        output_size=n_rois)


def _roi_align(x, boxes, boxes_num, output_size, spatial_scale,
               sampling_ratio, aligned):
    """[R, C, ph, pw]: the mean of sr x sr bilinear samples a bin, each
    sample's coordinates clamped into the map (the JAX package's
    formula).  The four corners of every sample are read in one
    `index_select` of channel rows from the map in [N * H * W, C]."""
    N, C, H, W = x.shape
    R = boxes.shape[0]
    ph, pw = output_size
    batch_idx = _batch_index(boxes_num, N, R, x.device)
    offset = 0.5 if aligned else 0.0
    bx = boxes * spatial_scale - offset
    x1, y1, x2, y2 = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
    rw = x2 - x1
    rh = y2 - y1
    if not aligned:
        rw = rw.clamp(min=1.0)
        rh = rh.clamp(min=1.0)
    sr = sampling_ratio if sampling_ratio > 0 else 2
    ar_h = torch.arange(ph * sr, device=x.device, dtype=bx.dtype)
    ar_w = torch.arange(pw * sr, device=x.device, dtype=bx.dtype)
    ys = y1[:, None] + (ar_h + 0.5)[None, :] * _div(rh, ph * sr)[:, None]
    xs = x1[:, None] + (ar_w + 0.5)[None, :] * _div(rw, pw * sr)[:, None]
    ys = ys.clamp(0.0, H - 1.0)
    xs = xs.clamp(0.0, W - 1.0)
    y0 = ys.floor()
    x0 = xs.floor()
    wy = (ys - y0)[:, :, None]                              # [R, hs, 1]
    wx = (xs - x0)[:, None, :]                              # [R, 1, ws]
    y0 = y0.long()
    x0 = x0.long()
    y1_ = (y0 + 1).clamp(max=H - 1)
    x1_ = (x0 + 1).clamp(max=W - 1)
    base = (batch_idx * (H * W))[:, None, None]
    flat = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    corners = torch.stack([
        base + y0[:, :, None] * W + x0[:, None, :],
        base + y0[:, :, None] * W + x1_[:, None, :],
        base + y1_[:, :, None] * W + x0[:, None, :],
        base + y1_[:, :, None] * W + x1_[:, None, :]])      # [4, R, hs, ws]
    g = flat.index_select(0, corners.reshape(-1)).reshape(
        (4,) + tuple(corners.shape[1:]) + (C,))
    w = torch.stack([(1 - wy) * (1 - wx), (1 - wy) * wx,
                     wy * (1 - wx), wy * wx]).to(x.dtype)   # [4, R, hs, ws]
    v = (g[0] * w[0, ..., None] + g[1] * w[1, ..., None]
         + g[2] * w[2, ..., None] + g[3] * w[3, ..., None])
    v = v.reshape(R, ph, sr, pw, sr, C).mean(dim=(2, 4))
    return v.permute(0, 3, 1, 2)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """RoIAlign of `boxes` [R, 4] (x1, y1, x2, y2 in input pixels) over
    x [N, C, H, W]; `boxes_num` [N] RoIs an image.  [R, C, ph, pw]."""
    return _roi_align(x, boxes.to(x.dtype), boxes_num,
                      _pair(output_size), float(spatial_scale),
                      int(sampling_ratio), bool(aligned))


# ----------------------------------------------------------------- roi pool
# elements a chunk of RoIs may hold in roi_pool's masked maxima
_ROI_POOL_CHUNK = 1 << 27


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Max RoI pooling over quantized bins (the reference's roi_pool):
    each box rounded to the map's pixels and clamped into it, bin (i, j)
    the maximum over rows [y1 + floor(i h / ph), y1 + ceil((i + 1) h /
    ph)) and the same for columns.  The JAX package takes each bin's
    maximum over the whole map under a mask; here the position of each
    maximum is found without autograd, over columns and then over rows
    (for chunks of RoIs that fit `_ROI_POOL_CHUNK` elements), and the
    output gathers those positions, so the backward scatters into x
    alone.  The values are the same; where a bin ties, the gradient goes
    to the first maximum (row-major), where the JAX package splits it
    among the tied elements."""
    ph, pw = _pair(output_size)
    N, C, H, W = x.shape
    R = boxes.shape[0]
    dev = x.device
    batch_idx = _batch_index(boxes_num, N, R, dev)
    with torch.no_grad():
        bx = torch.round(boxes.to(x.dtype) * float(spatial_scale))
        x1 = bx[:, 0].to(torch.int32).clamp(0, W - 1)
        y1 = bx[:, 1].to(torch.int32).clamp(0, H - 1)
        x2 = torch.maximum(bx[:, 2].to(torch.int32), x1 + 1).clamp(1, W)
        y2 = torch.maximum(bx[:, 3].to(torch.int32), y1 + 1).clamp(1, H)
        rh = _div((y2 - y1).to(torch.float32), ph)
        rw = _div((x2 - x1).to(torch.float32), pw)
        ah = torch.arange(ph, device=dev)
        aw = torch.arange(pw, device=dev)
        hs = y1[:, None] + torch.floor(ah[None] * rh[:, None]).to(
            torch.int32)
        he = y1[:, None] + torch.ceil((ah[None] + 1) * rh[:, None]).to(
            torch.int32)
        ws = x1[:, None] + torch.floor(aw[None] * rw[:, None]).to(
            torch.int32)
        we = x1[:, None] + torch.ceil((aw[None] + 1) * rw[:, None]).to(
            torch.int32)
        rows = torch.arange(H, device=dev)
        cols = torch.arange(W, device=dev)
        ymask = (rows >= hs[:, :, None]) & (rows < he[:, :, None])
        xmask = (cols >= ws[:, :, None]) & (cols < we[:, :, None])
        neg = torch.tensor(-3.4e38, dtype=x.dtype, device=dev)
        step = max(1, _ROI_POOL_CHUNK // max(1, C * H * pw * W))
        where = []
        for r0 in range(0, R, step):
            sl = slice(r0, r0 + step)
            img = x[batch_idx[sl]]                            # [r, C, H, W]
            colmax, col = torch.where(
                xmask[sl][:, None, None], img[:, :, :, None, :],
                neg).max(-1)                                  # [r, C, H, pw]
            row = torch.where(ymask[sl][:, None, :, :, None],
                              colmax[:, :, None], neg).argmax(3)
            col = torch.gather(col, 2, row)                   # [r, C, ph, pw]
            plane = (batch_idx[sl] * C)[:, None] + torch.arange(C, device=dev)
            where.append((plane[:, :, None, None] * H + row) * W + col)
        flat = torch.cat(where) if where else torch.zeros(
            (0, C, ph, pw), dtype=torch.int64, device=dev)
    return x.reshape(-1).take(flat)


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Position-sensitive RoI pooling: C = out_c * ph * pw input
    channels; bin (i, j) of output channel k averages input channel
    k * ph * pw + i * pw + j, by RoIAlign with one sample a bin and
    unaligned boxes (the reference's formulation)."""
    ph, pw = _pair(output_size)
    out_c = x.shape[1] // (ph * pw)
    pooled = roi_align(x, boxes, boxes_num, (ph, pw), spatial_scale,
                       sampling_ratio=1, aligned=False)
    R = pooled.shape[0]
    p6 = pooled.reshape(R, out_c, ph, pw, ph, pw)
    ii = torch.arange(ph, device=x.device)[:, None]
    jj = torch.arange(pw, device=x.device)[None, :]
    return p6[:, :, ii, jj, ii, jj]


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


# ------------------------------------------------------------------ box_coder
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0):
    """Encode target boxes against priors ([T, P, 4]) or decode deltas
    ([N, M, 4] or [N, 4]) to boxes, SSD-style; `prior_box_var` [P, 4],
    [4] or None (ones)."""
    pb, tb = prior_box, _as(target_box, prior_box)
    var = (torch.ones(4, dtype=torch.float32, device=pb.device)
           if prior_box_var is None else _as(prior_box_var, pb))
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph_ = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw * 0.5
    pcy = pb[:, 1] + ph_ * 0.5
    v = var.reshape(1, -1, 4) if var.dim() == 2 else var.reshape(1, 1, 4)
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw * 0.5
        tcy = tb[:, 1] + th * 0.5
        out = torch.stack([
            (tcx[:, None] - pcx[None, :]) / pw[None, :],
            (tcy[:, None] - pcy[None, :]) / ph_[None, :],
            torch.log(tw[:, None] / pw[None, :]),
            torch.log(th[:, None] / ph_[None, :])], -1)
        return out / v
    if code_type == "decode_center_size":
        d = (tb[:, None, :] if tb.dim() == 2 else tb) * v
        if axis == 0:
            pw_, ph2, pcx_, pcy_ = (pw[:, None], ph_[:, None],
                                    pcx[:, None], pcy[:, None])
        else:
            pw_, ph2, pcx_, pcy_ = (pw[None, :], ph_[None, :],
                                    pcx[None, :], pcy[None, :])
        cx = d[..., 0] * pw_ + pcx_
        cy = d[..., 1] * ph2 + pcy_
        w = torch.exp(d[..., 2]) * pw_
        h = torch.exp(d[..., 3]) * ph2
        out = torch.stack([cx - w * 0.5, cy - h * 0.5,
                           cx + w * 0.5 - norm, cy + h * 0.5 - norm], -1)
        return out.squeeze(1) if tb.dim() == 2 else out
    raise ValueError(f"unknown code_type {code_type!r}")


# ------------------------------------------------------- deformable conv
def _bilinear_sample(x, ys, xs):
    """x [N, C, H, W] sampled at ys / xs [N, K, Ho, Wo] -> [N, C, K, Ho,
    Wo]; a corner outside the map reads zero (deformable convolution's
    convention)."""
    N, C, H, W = x.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, None].to(x.dtype)
    wx = (xs - x0)[:, None].to(x.dtype)
    flat = x.reshape(N, C, H * W)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (yi.clamp(0, H - 1).long() * W
               + xi.clamp(0, W - 1).long()).reshape(N, 1, -1)
        g = flat.gather(2, idx.expand(N, C, idx.shape[-1]))
        return g.reshape((N, C) + tuple(yi.shape[1:])) \
            * valid[:, None].to(x.dtype)

    return (gather(y0, x0) * (1 - wy) * (1 - wx)
            + gather(y0, x0 + 1) * (1 - wy) * wx
            + gather(y0 + 1, x0) * wy * (1 - wx)
            + gather(y0 + 1, x0 + 1) * wy * wx)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution v1 (v2 with `mask`): each tap reads the
    input at its regular position plus a learned offset (`offset` [N,
    2 * dg * kh * kw, Ho, Wo], (dy, dx) pairs), bilinearly, times the
    mask ([N, dg * kh * kw, Ho, Wo]) when given; the sampled [N, Cin,
    kh * kw, Ho, Wo] tensor then contracts with the weight in one
    einsum."""
    N, Cin, H, W = x.shape
    Cout, cpg, kh, kw = weight.shape
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    Ho = (H + 2 * p[0] - (d[0] * (kh - 1) + 1)) // s[0] + 1
    Wo = (W + 2 * p[1] - (d[1] * (kw - 1) + 1)) // s[1] + 1
    K = kh * kw
    dev = x.device
    oy = torch.arange(Ho, device=dev) * s[0] - p[0]
    ox = torch.arange(Wo, device=dev) * s[1] - p[1]
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev) * d[0],
                            torch.arange(kw, device=dev) * d[1],
                            indexing="ij")
    base_y = (ky.reshape(K, 1, 1) + oy[None, :, None]).to(offset.dtype)
    base_x = (kx.reshape(K, 1, 1) + ox[None, None, :]).to(offset.dtype)
    off = offset.reshape(N, deformable_groups, K, 2, Ho, Wo)
    dg_size = Cin // deformable_groups
    sampled = torch.cat([
        _bilinear_sample(x[:, g * dg_size:(g + 1) * dg_size],
                         base_y[None] + off[:, g, :, 0],
                         base_x[None] + off[:, g, :, 1])
        for g in range(deformable_groups)], dim=1)   # [N, Cin, K, Ho, Wo]
    if mask is not None:
        m = mask.reshape(N, deformable_groups, 1, K, Ho, Wo)
        sampled = (sampled.reshape(N, deformable_groups, dg_size, K, Ho, Wo)
                   * m).reshape(N, Cin, K, Ho, Wo)
    w = weight.reshape(groups, Cout // groups, cpg, K)
    sg = sampled.reshape(N, groups, cpg, K, Ho, Wo)
    out = torch.einsum("ngckyx,gock->ngoyx", sg, w).reshape(N, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


class DeformConv2D(Layer):
    """`deform_conv2d` as a layer: weight [out, in / groups, kh, kw]
    Kaiming-uniform, bias zero (`bias_attr=False`: none); built on
    `device` and drawn from `generator` as every port layer."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, device=None, dtype=None,
                 generator=None):
        super().__init__(**_kw(device, dtype, generator))
        k = _pair(kernel_size)
        self._cfg = (stride, padding, dilation, deformable_groups, groups)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, k[0], k[1]],
            attr=weight_attr,
            default_initializer=_attr_init(weight_attr)
            or I.KaimingUniform())
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=_attr_init(bias_attr) or I.Constant(0.0))

    def forward(self, x, offset, mask=None):
        st, pd, dl, dg, g = self._cfg
        return deform_conv2d(x, offset, self.weight, self.bias, st, pd, dl,
                             dg, g, mask)


# -------------------------------------------------------------- FPN levels
@torch.no_grad()
def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None):
    """Each RoI to the FPN level of its scale, floor(log2(sqrt(w h) /
    refer_scale + 1e-8)) + refer_level clamped to [min_level,
    max_level]: (the RoIs of each level in their order, the restore
    index [R] int64 that puts the concatenated levels back in the
    input's order, each level's count [1] int32).  On the device, one
    host read for the counts (`rois_num` is taken and unused, as in the
    reference)."""
    rois = fpn_rois
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    scale = torch.sqrt((w * h).clamp(min=1e-12))
    lvl = torch.floor(torch.log2(_div(scale, refer_scale) + 1e-8)) \
        + refer_level
    lvl = lvl.clamp(min_level, max_level).to(torch.int64)
    order = torch.argsort(lvl, stable=True)
    counts = torch.bincount(lvl - min_level,
                            minlength=max_level - min_level + 1)
    sizes = counts.tolist()
    multi_rois = list(torch.split(rois[order], sizes))
    restore = torch.empty_like(order)
    restore[order] = torch.arange(order.numel(), device=rois.device)
    nums = [c.reshape(1).to(torch.int32) for c in counts]
    return multi_rois, restore, nums


# ------------------------------------------------------------------- YOLOv3
def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """YOLOv3 head [N, na * (5 + classes), H, W] to (boxes [N, na H W, 4]
    in image pixels, scores [N, na H W, classes]); predictions whose
    objectness is at most `conf_thresh` give zeros."""
    if iou_aware:
        raise NotImplementedError(
            "yolo_box(iou_aware=True) heads (C = na*(6+classes)) are not "
            "supported; decode with iou_aware=False layouts")
    N, C, H, W = x.shape
    na = len(anchors) // 2
    an = torch.tensor(anchors, dtype=torch.float32,
                      device=x.device).reshape(na, 2)
    pred = x.reshape(N, na, 5 + class_num, H, W)
    gx = torch.arange(W, device=x.device).to(torch.float32)[None, None,
                                                             None, :]
    gy = torch.arange(H, device=x.device).to(torch.float32)[None, None, :,
                                                             None]
    sx = torch.sigmoid(pred[:, :, 0]) * scale_x_y - (scale_x_y - 1.0) / 2.0
    sy = torch.sigmoid(pred[:, :, 1]) * scale_x_y - (scale_x_y - 1.0) / 2.0
    bx = (gx + sx) / W
    by = (gy + sy) / H
    input_w = W * downsample_ratio
    input_h = H * downsample_ratio
    bw = torch.exp(pred[:, :, 2]) * an[None, :, 0, None, None] / input_w
    bh = torch.exp(pred[:, :, 3]) * an[None, :, 1, None, None] / input_h
    conf = torch.sigmoid(pred[:, :, 4])
    probs = torch.sigmoid(pred[:, :, 5:]) * conf[:, :, None]
    img = _as(img_size, x).to(torch.float32)
    imh = img[:, 0][:, None, None, None]
    imw = img[:, 1][:, None, None, None]
    x1 = (bx - bw / 2) * imw
    y1 = (by - bh / 2) * imh
    x2 = (bx + bw / 2) * imw
    y2 = (by + bh / 2) * imh
    if clip_bbox:
        zero = torch.zeros((), device=x.device)
        x1 = torch.clamp(x1, zero, imw - 1)
        y1 = torch.clamp(y1, zero, imh - 1)
        x2 = torch.clamp(x2, zero, imw - 1)
        y2 = torch.clamp(y2, zero, imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(N, -1, 4)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(N, -1, class_num)
    keep = (conf.reshape(N, -1) > conf_thresh)[..., None]
    return boxes * keep, scores * keep


def _bce(p, t, eps=1e-9):
    """Elementwise binary cross entropy on probabilities."""
    p = p.clamp(eps, 1.0 - eps)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def _one_hot(idx, n):
    """float one-hot by comparison with an arange (no device assert on an
    index out of range: a zero row, as `jax.nn.one_hot` gives)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3's loss [N] for one head x [N, A (5 + classes), H, W], gt
    boxes [N, B, 4] (normalized cx, cy, w, h; zero width pads), labels
    [N, B] and optional scores [N, B] (mixup weights): each gt's best
    anchor over all anchors by shape IoU, positives at its center cell
    (a contested cell to the last gt), BCE on the x / y offsets, L1 on
    log w / h, both weighted by (2 - w h) and the score, objectness BCE
    with predictions overlapping any gt above `ignore_thresh` ignored,
    per-class BCE with optional label smoothing.  Differentiable with
    respect to `x` only."""
    N, C, H, W = x.shape
    A = len(anchor_mask)
    dev = x.device
    all_an = torch.tensor(anchors, dtype=torch.float32,
                          device=dev).reshape(-1, 2)
    mask_idx = torch.tensor(anchor_mask, dtype=torch.int64, device=dev)
    mask_an = all_an[mask_idx]                               # [A, 2] px
    input_w = float(W * downsample_ratio)
    input_h = float(H * downsample_ratio)
    s = float(scale_x_y)
    P = A * H * W

    pred = x.reshape(N, A, 5 + class_num, H, W).permute(0, 1, 3, 4, 2)
    pred = pred.reshape(N, P, 5 + class_num).to(torch.float32)
    px_raw, py_raw = pred[..., 0], pred[..., 1]
    pw_raw, ph_raw = pred[..., 2], pred[..., 3]
    pobj = torch.sigmoid(pred[..., 4])
    pcls = torch.sigmoid(pred[..., 5:])                      # [N, P, cls]
    sx = torch.sigmoid(px_raw) * s - (s - 1.0) / 2.0
    sy = torch.sigmoid(py_raw) * s - (s - 1.0) / 2.0

    # decoded predictions (normalized cx, cy, w, h) for the ignore mask
    gx = torch.arange(W, device=dev, dtype=torch.float32).repeat(A * H)
    gy = torch.arange(H, device=dev, dtype=torch.float32).repeat_interleave(
        W).repeat(A)
    aw = mask_an[:, 0].repeat_interleave(H * W)              # [P]
    ah = mask_an[:, 1].repeat_interleave(H * W)
    pbx = (gx[None] + sx) / W
    pby = (gy[None] + sy) / H
    pbw = torch.exp(pw_raw.clamp(-20.0, 20.0)) * aw[None] / input_w
    pbh = torch.exp(ph_raw.clamp(-20.0, 20.0)) * ah[None] / input_h

    gtb = _as(gt_box, x).to(torch.float32).detach()          # [N, B, 4]
    gw, gh = gtb[..., 2], gtb[..., 3]
    gvalid = (gw > 0) & (gh > 0)

    with torch.no_grad():
        px1, py1 = pbx - pbw / 2, pby - pbh / 2
        px2, py2 = pbx + pbw / 2, pby + pbh / 2
        qx1, qy1 = gtb[..., 0] - gw / 2, gtb[..., 1] - gh / 2
        qx2, qy2 = gtb[..., 0] + gw / 2, gtb[..., 1] + gh / 2
        ix1 = torch.maximum(px1[:, :, None], qx1[:, None, :])
        iy1 = torch.maximum(py1[:, :, None], qy1[:, None, :])
        ix2 = torch.minimum(px2[:, :, None], qx2[:, None, :])
        iy2 = torch.minimum(py2[:, :, None], qy2[:, None, :])
        inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
        union = (pbw * pbh)[:, :, None] + (gw * gh)[:, None, :] - inter
        iou = torch.where(gvalid[:, None, :],
                          inter / union.clamp(min=1e-10),
                          torch.zeros((), device=dev))
        ignore = iou.amax(dim=2) > ignore_thresh             # [N, P]

    # best anchor a gt: shape-only IoU against every anchor (pixels)
    gwp, ghp = gw * input_w, gh * input_h                    # [N, B]
    inter_a = (torch.minimum(gwp[..., None], all_an[None, None, :, 0])
               * torch.minimum(ghp[..., None], all_an[None, None, :, 1]))
    union_a = (gwp * ghp)[..., None] \
        + (all_an[:, 0] * all_an[:, 1])[None, None, :] - inter_a
    best = torch.argmax(inter_a / union_a.clamp(min=1e-10), dim=2)
    in_mask = best[..., None] == mask_idx[None, None, :]     # [N, B, A]
    k = torch.argmax(in_mask.to(torch.int32), dim=2)         # [N, B]
    responsible = gvalid & in_mask.any(dim=2)

    gi = (gtb[..., 0] * W).to(torch.int64).clamp(0, W - 1)
    gj = (gtb[..., 1] * H).to(torch.int64).clamp(0, H - 1)
    flat = (k * H + gj) * W + gi                             # [N, B]

    # gt -> grid; a contested cell goes to the last responsible gt
    B = gtb.shape[1]
    assign = _one_hot(flat, P) * responsible[..., None].to(torch.float32)
    pos = (assign > 0).any(dim=1)                            # [N, P]
    order = torch.arange(1, B + 1, dtype=torch.float32,
                         device=dev)[None, :, None]
    owner = torch.argmax(assign * order, dim=1)              # [N, P]

    def pick(v):                                             # [N, B] -> [N, P]
        return torch.gather(v, 1, owner)

    tx = pick(gtb[..., 0] * W - gi.to(torch.float32))
    ty = pick(gtb[..., 1] * H - gj.to(torch.float32))
    tw = pick(torch.log(gwp.clamp(min=1e-10))) - torch.log(aw)[None]
    th = pick(torch.log(ghp.clamp(min=1e-10))) - torch.log(ah)[None]
    tscale = pick(2.0 - gw * gh)
    score = (torch.ones_like(gw) if gt_score is None
             else _as(gt_score, x).to(torch.float32).detach())
    tobj = pick(score)
    tlabel = torch.gather(_as(gt_label, x).to(torch.int64), 1, owner)

    posf = pos.to(torch.float32)
    w_box = posf * tscale * tobj
    loss_xy = (_bce(sx, tx) + _bce(sy, ty)) * w_box
    loss_wh = ((pw_raw - tw).abs() + (ph_raw - th).abs()) * 0.5 * w_box
    noobj = (1.0 - posf) * (1.0 - ignore.to(torch.float32))
    loss_obj = _bce(pobj, tobj) * posf + _bce(pobj, 0.0) * noobj
    if use_label_smooth and class_num > 1:
        t_pos, t_neg = 1.0 - 1.0 / class_num, 1.0 / class_num
    else:
        t_pos, t_neg = 1.0, 0.0
    onehot = _one_hot(tlabel, class_num)
    tcls = onehot * t_pos + (1.0 - onehot) * t_neg
    loss_cls = _bce(pcls, tcls).sum(dim=2) * posf * tobj
    return (loss_xy + loss_wh + loss_obj + loss_cls).sum(dim=1)


# -------------------------------------------------------------- proposals
@torch.no_grad()
def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=True):
    """RPN proposals: for each image, the `pre_nms_top_n` best anchors'
    deltas (scores [N, A, H, W], deltas [N, 4A, H, W], anchors and
    variances [H, W, A, 4]) decoded, clipped to the image (`img_size`
    [N, 2] h, w), boxes narrower than `min_size` dropped, `nms`, then
    the first `post_nms_top_n`: (rois [R, 4], scores [R], RoIs an image
    [N] int32 with `return_rois_num`).  On the device (`eta` is taken
    and unused, as in the reference)."""
    dev = scores.device
    N, A, H, W = scores.shape
    an = _as(anchors, scores).reshape(-1, 4).to(torch.float32)
    vr = _as(variances, scores).reshape(-1, 4).to(torch.float32)
    ims = _as(img_size, scores).to(torch.float32).cpu().tolist()
    all_rois, all_scores, nums = [], [], []
    for i in range(N):
        s = scores[i].permute(1, 2, 0).reshape(-1)
        d = bbox_deltas[i].reshape(A, 4, H, W).permute(2, 3, 0, 1).reshape(
            -1, 4)
        order = torch.argsort(-s, stable=True)[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], an[order], vr[order]
        aw = a[:, 2] - a[:, 0] + 1.0
        ah = a[:, 3] - a[:, 1] + 1.0
        acx = a[:, 0] + aw * 0.5
        acy = a[:, 1] + ah * 0.5
        cx = d[:, 0] * v[:, 0] * aw + acx
        cy = d[:, 1] * v[:, 1] * ah + acy
        w = torch.exp((d[:, 2] * v[:, 2]).clamp(max=10.0)) * aw
        h = torch.exp((d[:, 3] * v[:, 3]).clamp(max=10.0)) * ah
        ih, iw = ims[i]
        boxes = torch.stack([(cx - w / 2).clamp(0, iw - 1),
                             (cy - h / 2).clamp(0, ih - 1),
                             (cx + w / 2).clamp(0, iw - 1),
                             (cy + h / 2).clamp(0, ih - 1)], dim=1)
        keep = ((boxes[:, 2] - boxes[:, 0] >= min_size)
                & (boxes[:, 3] - boxes[:, 1] >= min_size))
        boxes, s = boxes[keep], s[keep]
        if boxes.shape[0]:
            kept = nms(boxes, s, iou_threshold=nms_thresh)[:post_nms_top_n]
            boxes, s = boxes[kept], s[kept]
        all_rois.append(boxes)
        all_scores.append(s)
        nums.append(boxes.shape[0])
    rois = torch.cat(all_rois) if all_rois else \
        torch.zeros((0, 4), dtype=torch.float32, device=dev)
    out = (rois, torch.cat(all_scores) if all_scores else rois[:, 0])
    if return_rois_num:
        out = out + (torch.tensor(nums, dtype=torch.int32, device=dev),)
    return out
