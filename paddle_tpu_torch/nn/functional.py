"""Functional ops of the training path and the LLaMA family.

Counterpart: `paddle_tpu/nn/functional.py` — `dropout` (`:117-129`),
`scaled_dot_product_attention` (`:400-428`) and `cross_entropy`
(`:432-454`, over `softmax_ce_k` in `paddle_tpu/ops/nn_kernels.py:415-430`).
Ported here: what the GPT training step runs — dropout (both modes, and
a mask over chosen axes), attention with dropout on its output, and
cross entropy (hard or soft labels, class weights, label smoothing, any
class axis, `ignore_index`) — and what the LLaMA family adds: `silu`
(`:19`) and `rms_norm` (`rms_norm_k`,
`paddle_tpu/ops/nn_kernels.py:266-272`); and what ResNet runs: `conv2d` (`:146-154`), `batch_norm` (`:354-382`),
`max_pool2d`, `avg_pool2d` and `adaptive_avg_pool2d` (`:183-213`), each
in NCHW or NHWC; and what the BERT / ERNIE encoders add: `relu`
(`:14`), `tanh` (`:18`) and `gelu` (`:30`), the names that
`nn.TransformerEncoderLayer` looks its `activation` up by.  NHWC tensors
[b, H, W, c] run as NCHW-shaped views with channels-last strides
(`torch.channels_last`), so no layout copy is made around the op.

Randomness goes through an explicit `torch.Generator` (None: PyTorch's
default generator of the tensor's device).  The JAX package draws from
its key stream; the two give different masks from one seed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import amp as _amp
from .. import ops


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            *, generator=None):
    """Dropout with the JAX package's parameters (`:117-129`): each element
    is kept with probability 1 - p.  "upscale_in_train" scales what it
    keeps by 1 / (1 - p) in training and is the identity otherwise;
    "downscale_in_infer" keeps elements unscaled in training and
    multiplies by 1 - p otherwise.  `axis` (an int or a list of ints)
    draws the keep mask over those axes only and broadcasts it along the
    others (Paddle's meaning: axis=[0, 1] of [N, C, H, W] keeps or drops
    whole channels); the JAX package takes the argument and draws every
    element.  The mask is drawn from `generator` on x's device."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', not {mode!r}")
    if not training:
        return x * (1.0 - p) if mode == "downscale_in_infer" else x
    if p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    (x,) = _amp.cast_inputs("dropout_k", "keep", x)
    with _amp.no_cast():
        return _dropout(x, p, axis, mode, generator)


def _dropout(x, p, axis, mode, generator):
    shape = x.shape
    if axis is not None:
        axes = {a % x.dim() for a in
                ([axis] if isinstance(axis, int) else axis)}
        shape = [n if i in axes else 1 for i, n in enumerate(x.shape)]
    u = torch.rand(shape, generator=generator, device=x.device)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(u >= p, kept, torch.zeros_like(x))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None,
                                 sliding_window=None, generator=None):
    """(B, L, H, D) attention through `ops.sdpa` (the flash kernels on the
    card inside their gate).  Dropout applies to the attention OUTPUT in
    training, as the JAX package does (`:426-427`), not to the
    probabilities.  A window without causal raises ValueError on every
    device."""
    if sliding_window and not is_causal:
        raise ValueError("sliding_window requires is_causal=True")
    out = ops.sdpa(query, key, value, mask=attn_mask, is_causal=is_causal,
                   scale=scale, sliding_window=sliding_window,
                   _mask_needs_grad=attn_mask is not None
                   and attn_mask.requires_grad)
    if dropout_p > 0.0 and training:
        out = dropout(out, dropout_p, training=True, generator=generator)
    return out


def silu(x):
    """x * sigmoid(x) (`jax.nn.silu`), computed in float32 and rounded
    once to x's dtype, as XLA's fused elementwise ops round."""
    return F.silu(x)


def relu(x):
    return F.relu(x)


def tanh(x):
    return torch.tanh(x)


def gelu(x, approximate=False):
    """GELU, exact (erf) by default or with the tanh approximation
    (`jax.nn.gelu`), computed in float32 and rounded once to x's dtype."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def rms_norm(x, weight=None, epsilon=1e-6):
    """Root-mean-square norm over the last axis, in the JAX package's
    rounding order (`ops.nn_kernels.rms_norm`)."""
    return ops.rms_norm(x, weight, epsilon)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  label_smoothing=0.0):
    """Softmax cross entropy over the class axis `axis`, logits in
    float32, as `softmax_ce_k` and `cross_entropy` of the JAX package
    compute it: loss = -sum(target * log_softmax(input)), the target a
    label's one-hot row or, with `soft_label`, `label` itself; with
    `label_smoothing` e the target becomes target * (1 - e) + e / classes.
    Hard labels (input's shape without `axis`) equal to `ignore_index`
    give 0, and `weight` [classes] scales each by its label's weight;
    "mean" divides the sum by the valid labels' count (or their weights'
    sum) at least 1e-12, so an all-ignored batch gives 0 and not NaN.
    Soft labels' "mean" is the plain mean; "sum" sums."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', not "
                         f"{reduction!r}")
    # the softmax_ce kernel (a deny op under amp.auto_cast), then the
    # weighting and reduction as separate ops, as the JAX package splits
    # them
    input, label = _amp.cast_inputs("softmax_ce", "deny", input, label)
    with _amp.no_cast():
        loss, count = _softmax_ce(input, label, weight, ignore_index,
                                  soft_label, axis, label_smoothing)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if soft_label:
        return loss.mean()
    return loss.sum() / count.sum().clamp(min=1e-12)


def _softmax_ce(input, label, weight, ignore_index, soft_label, axis,
                label_smoothing):
    """(per-element loss, its count: the valid labels' weights, or None
    for soft labels)."""
    logits = input.float()
    ax = axis % logits.dim()
    n = logits.shape[ax]
    eps = float(label_smoothing)
    logp = torch.log_softmax(logits, dim=ax)
    if soft_label:
        tgt = label.float()
        if eps > 0.0:
            tgt = tgt * (1.0 - eps) + eps / n
        return -(tgt * logp).sum(dim=ax), None
    lab = label.long()
    valid = lab != ignore_index
    idx = torch.where(valid, lab, torch.zeros_like(lab))
    loss = -logp.gather(ax, idx.unsqueeze(ax)).squeeze(ax)
    if eps > 0.0:
        loss = (1.0 - eps) * loss - eps / n * logp.sum(dim=ax)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    count = valid.to(loss.dtype)
    if weight is not None:
        w = weight.float()[idx]
        loss = loss * w
        count = count * w
    return loss, count


# ------------------------------------------------------------ vision ops
def _pair(v):
    return tuple(int(x) for x in v) if isinstance(v, (list, tuple)) \
        else (int(v), int(v))


def _pads(padding):
    """((top, bottom), (left, right)) from an int, a pair or a 4-list
    (`_conv_padding` of the JAX package)."""
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    p = [int(v) for v in padding]
    if len(p) == 2:
        return ((p[0], p[0]), (p[1], p[1]))
    if len(p) == 4:
        return ((p[0], p[1]), (p[2], p[3]))
    raise ValueError(f"bad padding {padding}")


def _nchw(x, data_format):
    """x as NCHW: an NHWC tensor becomes a channels-last view."""
    if data_format == "NHWC":
        return x.permute(0, 3, 1, 2)
    if data_format != "NCHW":
        raise ValueError(f"data_format must be NCHW or NHWC, not "
                         f"{data_format!r}")
    return x


def _back(out, data_format):
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution with an OIHW weight; `padding` an int, a pair, a
    4-list (top, bottom, left, right) or "SAME" / "VALID"."""
    xc = _nchw(x, data_format)
    if isinstance(padding, str):
        pad = padding.lower()
    else:
        (t, b), (l, r) = _pads(padding)
        if t != b or l != r:
            xc = F.pad(xc, (l, r, t, b))
            t = l = 0
        pad = (t, l)
    out = F.conv2d(xc, weight, bias, _pair(stride), pad, _pair(dilation),
                   groups)
    return _back(out, data_format)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW"):
    """Batch norm over every axis but the channel one.  Training
    normalises by the batch statistics and updates the float32 running
    statistics IN PLACE with the JAX package's convention, running =
    momentum * running + (1 - momentum) * batch, the variance unbiased
    (torch's `momentum` is the weight of the batch: 1 - momentum here).
    Eval normalises by the running statistics.  The scale and shift take
    part in the statistics' dtype (float32), so a bfloat16 x meets float32
    statistics and returns bfloat16."""
    channels_last = data_format in ("NHWC", "NLC", "NDHWC") and x.dim() > 2
    xc = x.movedim(-1, 1) if channels_last else x
    dt = running_mean.dtype
    out = F.batch_norm(xc, running_mean, running_var,
                       None if weight is None else weight.to(dt),
                       None if bias is None else bias.to(dt),
                       training=training, momentum=1.0 - momentum,
                       eps=epsilon)
    return out.movedim(1, -1) if channels_last else out


def _ceil_extra(size, k, s, p):
    """Extra bottom / right padding that gives ceil_mode's output size
    (`_ceil_extra` of the JAX package)."""
    eff = size + p[0] + p[1]
    return (-(-(eff - k) // s) - (eff - k) // s) * s


def _pool_geometry(x, kernel_size, stride, padding, ceil_mode):
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    p = _pads(padding)
    if ceil_mode:
        p = tuple((p[i][0], p[i][1] + _ceil_extra(x.shape[2 + i], k[i], s[i],
                                                  p[i])) for i in range(2))
    return k, s, p


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    """Max pooling, padding counting as -inf.  `return_mask` (NCHW, and
    padding torch's pooling takes: symmetric, at most half the window,
    no ceil_mode) also returns each maximum's flat index into its input
    map."""
    if return_mask and data_format == "NHWC":
        raise NotImplementedError("return_mask with NHWC pooling")
    xc = _nchw(x, data_format)
    k, s, ((t, b), (l, r)) = _pool_geometry(xc, kernel_size, stride,
                                            padding, ceil_mode)
    if t == b and l == r and t <= k[0] // 2 and l <= k[1] // 2:
        out = F.max_pool2d(xc, k, s, (t, l), return_indices=return_mask)
        return out if return_mask else _back(out, data_format)
    if return_mask:
        raise NotImplementedError(
            "return_mask with asymmetric, ceil_mode or wide padding")
    low = float("-inf") if xc.is_floating_point() else \
        torch.iinfo(xc.dtype).min
    out = F.max_pool2d(F.pad(xc, (l, r, t, b), value=low), k, s)
    return _back(out, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCHW"):
    """Average pooling over zero padding; with `exclusive` and any
    padding (ceil_mode's included) each window divides by the input
    elements it covers, else by the window size."""
    xc = _nchw(x, data_format)
    k, s, p = _pool_geometry(xc, kernel_size, stride, padding, ceil_mode)
    (t, b), (l, r) = p
    summed = F.avg_pool2d(F.pad(xc, (l, r, t, b)), k, s, divisor_override=1)
    if exclusive and any(pi != (0, 0) for pi in p):
        ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                          device=xc.device)
        counts = F.avg_pool2d(F.pad(ones, (l, r, t, b)), k, s,
                              divisor_override=1)
        out = summed / counts.clamp(min=1.0)
    else:
        out = summed / (k[0] * k[1])
    return _back(out, data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Mean over adaptive bins: bin i of n over a size h covers
    [floor(i h / n), ceil((i + 1) h / n))."""
    return _back(F.adaptive_avg_pool2d(_nchw(x, data_format),
                                       _pair(output_size)), data_format)
