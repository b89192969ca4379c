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

import math as _math

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


# ------------------------------------------------ the rest of the surface
# Counterpart: the rest of `paddle_tpu/nn/functional.py` and the kernels it
# reaches in `paddle_tpu/ops/nn_kernels.py` / `ops/kernels.py`.  Each is
# plain torch ops in the JAX package's formula: XLA compiled those with no
# Pallas kernel.  Where the JAX function and torch's differ, the JAX one
# is followed (noted at the function).


def relu6(x):
    return F.relu6(x)


def relu_(x):
    return x.relu_()


def sigmoid(x):
    return torch.sigmoid(x)


def swish(x):
    return F.silu(x)


def mish(x):
    return F.mish(x)


def hardswish(x):
    return F.hardswish(x)


def hardsigmoid(x, slope=1 / 6, offset=0.5):
    """clip(x * slope + offset, 0, 1) (Paddle's slope, not torch's 1/6
    fixed)."""
    return (x * slope + offset).clamp(0.0, 1.0)


def selu(x):
    return F.selu(x)


def softsign(x):
    return F.softsign(x)


def tanhshrink(x):
    return F.tanhshrink(x)


def leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0):
    return F.elu(x, alpha)


def celu(x, alpha=1.0):
    return F.celu(x, alpha)


def softplus(x, beta=1.0, threshold=20.0):
    """x where x * beta > threshold, else log(1 + exp(beta x)) / beta."""
    return F.softplus(x, beta, threshold)


def softshrink(x, threshold=0.5):
    return F.softshrink(x, threshold)


def hardshrink(x, threshold=0.5):
    return F.hardshrink(x, threshold)


def hardtanh(x, min=-1.0, max=1.0):
    return F.hardtanh(x, min, max)


def prelu(x, weight):
    """x where x >= 0, else weight * x (weight broadcast as given)."""
    return torch.where(x >= 0, x, weight * x)


def glu(x, axis=-1):
    return F.glu(x, axis)


def softmax(x, axis=-1, dtype=None):
    out = F.softmax(x, dim=axis)
    return out if dtype is None else out.to(_dtype(dtype))


def log_softmax(x, axis=-1, dtype=None):
    out = F.log_softmax(x, dim=axis)
    return out if dtype is None else out.to(_dtype(dtype))


def _dtype(dtype):
    from .layer import convert_dtype
    return convert_dtype(dtype)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, *,
                   generator=None):
    """softmax((x + g) / temperature) with Gumbel noise g; `hard` returns
    the one-hot of the argmax with the soft gradient (straight through)."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    g = -torch.log(-torch.log(u.clamp(min=1e-20))).to(x.dtype)
    y = softmax((x + g) / temperature, axis=axis)
    if hard:
        onehot = (torch.arange(y.shape[axis], device=y.device).reshape(
            [-1 if d == axis % y.dim() else 1 for d in range(y.dim())])
            == y.argmax(axis, keepdim=True)).to(y.dtype)
        return onehot - y.detach() + y
    return y


def log_sigmoid(x):
    return -softplus(-x)


def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def rrelu(x, lower=1. / 8., upper=1. / 3., training=True, *,
          generator=None):
    """Leaky ReLU with a slope drawn from U(lower, upper) per element in
    training, (lower + upper) / 2 otherwise."""
    if training:
        noise = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        noise.uniform_(lower, upper, generator=generator)
        return torch.where(x >= 0, x, x * noise.to(x.dtype))
    return torch.where(x >= 0, x, x * ((lower + upper) / 2.0))


def maxout(x, groups, axis=1):
    c = x.shape[axis]
    shape = list(x.shape)
    shape[axis:axis + 1] = [c // groups, groups]
    return x.reshape(shape).amax(dim=axis + 1)


# ---------------------------------------------------------------- linear
def linear(x, weight, bias=None):
    """x @ weight + bias with weight [in, out] (Paddle's layout; the
    `Linear` layer keeps [out, in] and calls torch's linear)."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def bilinear(x1, x2, weight, bias=None):
    """out[b, o] = x1[b, i] W[o, i, j] x2[b, j] (+ bias)."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of `weight`; the `padding_idx` row passes no gradient."""
    return F.embedding(x.long(), weight, padding_idx)


def one_hot(x, num_classes):
    """float32 one-hot rows; an index outside [0, num_classes) gives a row
    of zeros (a comparison, so no device-side assert)."""
    return (x.long().unsqueeze(-1) == torch.arange(
        int(num_classes), device=x.device)).to(torch.float32)


# --------------------------------------------------------------- dropout
def _channel_dropout(x, p, training, generator):
    """Drop whole channels of [N, C, ...], the rest scaled by 1 / (1 - p)."""
    if not training or p == 0.0:
        return x
    u = torch.rand(x.shape[:2] + (1,) * (x.dim() - 2), generator=generator,
                   device=x.device)
    return x * ((u >= p).to(x.dtype) / (1.0 - p))


def dropout2d(x, p=0.5, training=True, *, generator=None):
    return _channel_dropout(x, p, training, generator)


def dropout3d(x, p=0.5, training=True, *, generator=None):
    return _channel_dropout(x, p, training, generator)


def alpha_dropout(x, p=0.5, training=True, *, generator=None):
    """Plain dropout, as in the JAX package."""
    return dropout(x, p, training=training, generator=generator)


# ------------------------------------------------------------ convolution
def _ntuple(v, n):
    return tuple(int(x) for x in v) if isinstance(v, (list, tuple)) \
        else (int(v),) * n


def _conv_pads(padding, n):
    """[(lo, hi)] * n from an int, n values, 2n values or None for a
    string (handled by the caller)."""
    if isinstance(padding, int):
        return [(padding, padding)] * n
    p = [int(v) for v in padding]
    if len(p) == n:
        return [(v, v) for v in p]
    if len(p) == 2 * n:
        return [(p[2 * i], p[2 * i + 1]) for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def _same_pads(size, k, s, d):
    """XLA's SAME padding for one dim: the output ceil(size / s), the
    extra on the high side."""
    total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n):
    conv = (F.conv1d, F.conv2d, F.conv3d)[n - 1]
    s, d = _ntuple(stride, n), _ntuple(dilation, n)
    k = weight.shape[2:]
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = [(0, 0)] * n
        else:
            pads = [_same_pads(x.shape[2 + i], k[i], s[i], d[i])
                    for i in range(n)]
    else:
        pads = _conv_pads(padding, n)
    if all(lo == hi for lo, hi in pads):
        return conv(x, weight, bias, s, [lo for lo, _ in pads], d, groups)
    flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
    return conv(F.pad(x, flat), weight, bias, s, 0, d, groups)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, n):
    """Transpose convolution with the weight [in, out / groups, k...]
    (torch's and Paddle's layout): the full product, then the padding
    cropped from each side and `output_padding` zeros added at the high
    side, as the JAX kernel pads its dilated input."""
    conv = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[n - 1]
    if isinstance(padding, str):
        raise ValueError("string padding unsupported for transpose conv")
    s, d = _ntuple(stride, n), _ntuple(dilation, n)
    op = _ntuple(output_padding, n)
    pads = _conv_pads(padding, n)
    out = conv(x, weight, None, s, 0, 0, groups, d)
    flat = [v for i in reversed(range(n))
            for v in (-pads[i][0], op[i] - pads[i][1])]
    if any(flat):
        out = F.pad(out, flat)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3)


# ---------------------------------------------------------------- pooling
def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False):
    out = max_pool2d(x.unsqueeze(2), (1, kernel_size),
                     None if stride is None else (1, stride),
                     (0, padding) if isinstance(padding, int) else padding,
                     ceil_mode=ceil_mode, return_mask=return_mask)
    if return_mask:
        return out[0].squeeze(2), out[1].squeeze(2)
    return out.squeeze(2)


def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True):
    return avg_pool2d(x.unsqueeze(2), (1, kernel_size),
                      None if stride is None else (1, stride),
                      (0, padding) if isinstance(padding, int) else padding,
                      ceil_mode=ceil_mode, exclusive=exclusive).squeeze(2)


def _pool3d_pads(x, kernel_size, stride, padding, ceil_mode):
    k = _ntuple(kernel_size, 3)
    s = _ntuple(stride if stride is not None else kernel_size, 3)
    p = _conv_pads(padding, 3)
    if ceil_mode:
        p = [(p[i][0], p[i][1] + _ceil_extra(x.shape[2 + i], k[i], s[i],
                                             p[i])) for i in range(3)]
    return k, s, p, [v for lo, hi in reversed(p) for v in (lo, hi)]


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    k, s, _, flat = _pool3d_pads(x, kernel_size, stride, padding, ceil_mode)
    low = float("-inf") if x.is_floating_point() else \
        torch.iinfo(x.dtype).min
    return F.max_pool3d(F.pad(x, flat, value=low), k, s)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True):
    k, s, p, flat = _pool3d_pads(x, kernel_size, stride, padding, ceil_mode)
    summed = F.avg_pool3d(F.pad(x, flat), k, s, divisor_override=1)
    if exclusive and any(pi != (0, 0) for pi in p):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = F.avg_pool3d(F.pad(ones, flat), k, s, divisor_override=1)
        return summed / counts.clamp(min=1.0)
    return summed / (k[0] * k[1] * k[2])


def _divisible(x, output_size, n, name):
    """The output size as an n-tuple; raises NotImplementedError unless
    it divides the input's spatial dims, as the JAX kernels do."""
    out = _ntuple(output_size, n)
    if any(s % o for s, o in zip(x.shape[2:], out)):
        raise NotImplementedError(
            f"{name} requires input dims divisible by output_size")
    return out


def adaptive_max_pool2d(x, output_size):
    """Max over equal bins (the output size divides the input's)."""
    return F.adaptive_max_pool2d(x, _divisible(x, output_size, 2,
                                               "adaptive_max_pool2d"))


def adaptive_avg_pool1d(x, output_size):
    return F.adaptive_avg_pool1d(x, output_size)


def adaptive_max_pool1d(x, output_size):
    return F.adaptive_max_pool1d(x, _divisible(x, output_size, 1,
                                               "adaptive_max_pool1d"))


def adaptive_avg_pool3d(x, output_size):
    return F.adaptive_avg_pool3d(x, _divisible(x, output_size, 3,
                                               "adaptive_avg_pool3d"))


def adaptive_max_pool3d(x, output_size):
    return F.adaptive_max_pool3d(x, _divisible(x, output_size, 3,
                                               "adaptive_max_pool3d"))


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW"):
    """Each value back at its flat (H * W) index from max_pool2d's mask;
    a position named twice takes the value once."""
    k = _pair(kernel_size)
    s = k if stride is None else _pair(stride)
    p = _pair(padding)
    if data_format == "NHWC":
        x, indices = x.permute(0, 3, 1, 2), indices.permute(0, 3, 1, 2)
    if output_size is None:
        oh = (x.shape[2] - 1) * s[0] - 2 * p[0] + k[0]
        ow = (x.shape[3] - 1) * s[1] - 2 * p[1] + k[1]
    else:
        oh, ow = output_size[-2], output_size[-1]
    n, c = x.shape[:2]
    flat = x.new_zeros(n, c, oh * ow).scatter(
        2, indices.reshape(n, c, -1).long(), x.reshape(n, c, -1))
    out = flat.reshape(n, c, oh, ow)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


# --------------------------------------------------------- resampling
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False):
    """Resize [N, C, H, W] as `jax.image.resize` does (the JAX kernel):
    half-pixel centres, "nearest" is torch's "nearest-exact", "bilinear"
    and "bicubic" weigh by a kernel widened when they shrink (antialias)
    and renormalised at the borders, cubic with a = -0.5.  Only
    `align_corners=True` bilinear samples the corner-aligned grid.  The
    output size is int(H * scale) when a scale is given."""
    h, w = x.shape[2], x.shape[3]
    if size is None:
        sf = _pair_float(scale_factor)
        size = (int(h * sf[0]), int(w * sf[1]))
    size = _pair(size)
    if align_corners and mode in ("bilinear", "linear") and \
            size[0] > 1 and size[1] > 1:
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=True)
    if mode == "nearest":
        return F.interpolate(x, size=size, mode="nearest-exact")
    tmode = {"bilinear": "bilinear", "linear": "bilinear",
             "bicubic": "bicubic"}[mode]
    return F.interpolate(x, size=size, mode=tmode, align_corners=False,
                         antialias=True)


def _pair_float(v):
    return (float(v[0]), float(v[1])) if isinstance(v, (list, tuple)) \
        else (float(v), float(v))


upsample = interpolate


def pixel_shuffle(x, upscale_factor):
    return F.pixel_shuffle(x, upscale_factor)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    xc = _nchw(x, data_format)
    h, w = xc.shape[2:]
    if h % downscale_factor or w % downscale_factor:
        raise ValueError(f"spatial dims ({h},{w}) not divisible by "
                         f"{downscale_factor}")
    return _back(F.pixel_unshuffle(xc, downscale_factor), data_format)


def channel_shuffle(x, groups, data_format="NCHW"):
    xc = _nchw(x, data_format)
    n, c, h, w = xc.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    out = xc.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)
    return _back(out, data_format)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """Paddle's pad: a list of 2 * ndim values pads every dim in order
    (lo, hi of dim 0 first); a shorter list pads the last dims, its first
    pair the last dim (torch's order).  Modes constant, reflect,
    replicate, circular; `data_format` is taken and unused, as in the JAX
    package."""
    pad = [int(p) for p in pad]
    if len(pad) == 2 * x.dim():
        pad = [v for i in reversed(range(x.dim()))
               for v in (pad[2 * i], pad[2 * i + 1])]
    if mode == "constant":
        return F.pad(x, pad, value=value)
    return F.pad(x, pad, mode=mode)


def zeropad2d(x, padding):
    return pad(x, padding, mode="constant", value=0.0)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    return F.grid_sample(x, grid.to(x.dtype), mode=mode,
                         padding_mode=padding_mode,
                         align_corners=align_corners)


def affine_grid(theta, out_shape, align_corners=True):
    n = int(out_shape[0])
    if theta.shape[0] != n:
        raise ValueError(f"theta batch {theta.shape[0]} != out_shape batch "
                         f"{n}")
    return F.affine_grid(theta, [int(v) for v in out_shape],
                         align_corners=align_corners)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """[N, C * kh * kw, L] patches, channel-major as the JAX kernel's;
    `paddings` an int or a pair.  `dilations` is taken and unused, as the
    JAX function takes its patches undilated."""
    return F.unfold(x, _pair(kernel_sizes), 1, _pair(paddings),
                    _pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """The inverse of unfold, overlapping patches summed."""
    return F.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                  _pair(dilations), _pair(paddings), _pair(strides))


def temporal_shift(x, seg_num, shift_ratio=0.25):
    """[N * T, C, H, W]: the first shift_ratio of the channels from the
    next frame, the second from the previous, zeros at the ends."""
    nt, c, h, w = x.shape
    x5 = x.reshape(nt // seg_num, seg_num, c, h, w)
    f = int(c * shift_ratio)
    out = torch.zeros_like(x5)
    out[:, :-1, :f] = x5[:, 1:, :f]
    out[:, 1:, f:2 * f] = x5[:, :-1, f:2 * f]
    out[:, :, 2 * f:] = x5[:, :, 2 * f:]
    return out.reshape(nt, c, h, w)


def gather_tree(ids, parents):
    """[T, B, beam] beam-search ancestry: each final beam's tokens,
    walked back through `parents`."""
    T = ids.shape[0]
    beam = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).contiguous()
    out = []
    for t in range(T - 1, -1, -1):
        out.append(ids[t].gather(1, beam))
        beam = parents[t].long().gather(1, beam)
    return torch.stack(out[::-1])


# ------------------------------------------------------------------ norms
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Normalise over the trailing len(normalized_shape) dims (an int:
    the last), biased variance."""
    n = 1 if isinstance(normalized_shape, int) else len(normalized_shape)
    return F.layer_norm(x, tuple(x.shape[x.dim() - n:]), weight, bias,
                        epsilon)


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5):
    return F.group_norm(x, num_groups, weight, bias, epsilon)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5):
    """Each instance's channel normalised over its spatial dims; the
    running statistics are taken and not used, as in the JAX package."""
    return F.instance_norm(x, None, None, weight, bias, True, 0.0, eps)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0):
    """x / (k + alpha * mean of squares over `size` channels)^beta."""
    return F.local_response_norm(x, size, alpha, beta, k)


def normalize(x, p=2.0, axis=1, epsilon=1e-12):
    return F.normalize(x, p, axis, epsilon)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """x1 . x2 / max(|x1| |x2|, eps) along `axis`."""
    num = (x1 * x2).sum(axis)
    return num / (torch.linalg.vector_norm(x1, dim=axis)
                  * torch.linalg.vector_norm(x2, dim=axis)).clamp(min=eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    """The p-norm of x - y + epsilon along the last axis."""
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


def sequence_mask(lengths, maxlen=None, dtype="bool"):
    m = int(maxlen) if maxlen is not None else int(lengths.max())
    mask = torch.arange(m, device=lengths.device) < lengths.unsqueeze(-1)
    return mask.to(_dtype(dtype))


# ----------------------------------------------------------------- losses
def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100):
    """The per-example loss with the class axis kept (size 1)."""
    if not soft_label and label.dim() == logits.dim():
        label = label.squeeze(axis)
    return cross_entropy(logits, label, ignore_index=ignore_index,
                         reduction="none", soft_label=soft_label,
                         axis=axis).unsqueeze(axis)


def mse_loss(input, label, reduction="mean"):
    return _reduce_loss(torch.square(input - label), reduction)


def square_error_cost(input, label):
    return torch.square(input - label)


def l1_loss(input, label, reduction="mean"):
    return _reduce_loss((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    """0.5 d^2 / delta where |d| < delta, else |d| - delta / 2."""
    d = (input - label).abs()
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce_loss(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    """-input[..., label] over the LAST axis (the JAX package's), label
    `ignore_index` giving 0; "mean" over the valid labels' (weights')
    sum."""
    lab = label.long()
    valid = lab != ignore_index
    idx = lab.clamp(min=0)
    loss = -input.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    count = valid.to(loss.dtype)
    if weight is not None:
        w = weight[idx]
        loss = loss * w
        count = count * w
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / count.sum().clamp(min=1e-12)
    return _reduce_loss(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    """-(y log p + (1 - y) log(1 - p)), p clipped to [1e-12, 1 - 1e-12]
    (not torch's log floor of -100)."""
    p = input.clamp(1e-12, 1.0 - 1e-12)
    loss = -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """The stable sigmoid cross entropy, in float32 (the JAX kernel
    casts both inputs)."""
    loss = F.binary_cross_entropy_with_logits(
        logit.float(), label.float(), reduction="none",
        pos_weight=None if pos_weight is None else pos_weight.float())
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean"):
    """label * (log(max(label, 1e-12)) - input); "batchmean" divides the
    sum by the batch."""
    loss = label * (torch.log(label.clamp(min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce_loss(loss, reduction)


def label_smooth(label, prior_dist=None, epsilon=0.1):
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * prior_dist
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over [T, B, C] unnormalised activations (log_softmax applied
    here, as warpctc does); "mean" averages loss / label length."""
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    loss = F.ctc_loss(lp, labels.long(), input_lengths.long(),
                      label_lengths.long(), blank=blank, reduction="none")
    if norm_by_times:
        loss = loss / input_lengths.to(loss.dtype)
    if reduction == "mean":
        return (loss / label_lengths.to(loss.dtype).clamp(min=1.0)).mean()
    return _reduce_loss(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    dp = pairwise_distance(input, positive, p, epsilon)
    dn = pairwise_distance(input, negative, p, epsilon)
    if swap:
        dn = torch.minimum(dn, pairwise_distance(positive, negative, p,
                                                 epsilon))
    return _reduce_loss((dp - dn + margin).clamp(min=0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean"):
    dfn = distance_function or pairwise_distance
    d_pos = dfn(input, positive)
    d_neg = dfn(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dfn(positive, negative))
    return _reduce_loss((d_pos - d_neg + margin).clamp(min=0.0), reduction)


def soft_margin_loss(input, label, reduction="mean"):
    return _reduce_loss(softplus(-label * input), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    loss = torch.where(label == 1.0, input, (margin - input).clamp(min=0.0))
    return _reduce_loss(loss, reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean"):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        lc = label.clamp(min=1.0)
        stirling = label * torch.log(lc) - label + 0.5 * torch.log(
            2.0 * _math.pi * lc)
        loss = loss + torch.where(label > 1.0, stirling,
                                  torch.zeros_like(stirling))
    return _reduce_loss(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean"):
    var = variance.clamp(min=epsilon)
    loss = 0.5 * (torch.log(var) + (input - label) ** 2 / var)
    if full:
        loss = loss + 0.5 * _math.log(2.0 * _math.pi)
    return _reduce_loss(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean"):
    loss = binary_cross_entropy_with_logits(input, label, reduction="none")
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss.mean(-1), reduction)


def log_loss(input, label, epsilon=1e-4):
    return -label * torch.log(input + epsilon) - (1.0 - label) * torch.log(
        1.0 - input + epsilon)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    cos = cosine_similarity(input1, input2, axis=1)
    label = label.to(cos.dtype)
    loss = torch.where(label > 0, 1.0 - cos, (cos - margin).clamp(min=0.0))
    return _reduce_loss(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return _reduce_loss((-label * (input - other) + margin).clamp(min=0.0),
                        reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean"):
    """sum over classes c != y of max(0, margin - x_y + x_c)^p (times
    weight[y]), divided by the class count."""
    n, c = input.shape
    lab = label.long().reshape(n, 1)
    m = (margin - input.gather(1, lab) + input).clamp(min=0.0)
    if p != 1:
        m = m ** p
    if weight is not None:
        m = m * weight[lab]
    loss = (m * (1.0 - one_hot(lab[:, 0], c).to(input.dtype))).sum(1) / c
    return _reduce_loss(loss, reduction)


def dice_loss(input, label, epsilon=1e-5):
    """input [N, ..., C] probabilities, label [N, ..., 1] class ids."""
    onehot = one_hot(label.squeeze(-1), input.shape[-1]).to(input.dtype)
    x2 = input.reshape(input.shape[0], -1)
    y2 = onehot.reshape(onehot.shape[0], -1)
    inter = (x2 * y2).sum(1)
    union = x2.sum(1) + y2.sum(1)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = torch.matmul(anchor, positive.t())
    lab = labels.reshape(-1, 1)
    tgt = (lab == lab.reshape(1, -1)).to(sim.dtype)
    tgt = tgt / tgt.sum(1, keepdim=True)
    ce = softmax_with_cross_entropy(sim, tgt, soft_label=True)
    reg = (anchor * anchor).sum(1).mean() + (positive * positive).sum(1) \
        .mean()
    return ce.mean() + l2_reg * reg * 0.25


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    y = label.to(logit.dtype)
    p = torch.sigmoid(logit)
    ce = binary_cross_entropy_with_logits(logit, y, reduction="none")
    p_t = p * y + (1.0 - p) * (1.0 - y)
    a_t = alpha * y + (1.0 - alpha) * (1.0 - y)
    loss = a_t * (1.0 - p_t) ** gamma * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce_loss(loss, reduction)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None):
    """Hierarchical sigmoid over the complete binary tree of
    `num_classes` leaves (the default tree; a custom one raises): each
    example's sum of sigmoid cross entropies along its leaf's path,
    [N, 1]."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "custom-tree hsigmoid (path_table/path_code) is not supported; "
            "use the default complete binary tree")
    lab = label.reshape(-1).long()
    depth = max(1, _math.ceil(_math.log2(max(num_classes, 2))))
    node = lab + num_classes - 1             # the leaf's id in the tree
    codes, signs = [], []
    for _ in range(depth):
        parent = (node - 1).div(2, rounding_mode="floor")
        signs.append((node == 2 * parent + 1).to(input.dtype))
        codes.append(parent)
        node = parent
    codes = torch.stack(codes[::-1], 1)       # root first
    signs = torch.stack(signs[::-1], 1)
    valid = (codes >= 0).to(input.dtype)      # shallow leaves end early
    codes = codes.clamp(min=0)
    logits = (weight[codes] * input.unsqueeze(1)).sum(2)
    if bias is not None:
        logits = logits + bias.reshape(-1)[codes]
    per_level = binary_cross_entropy_with_logits(logits, signs,
                                                 reduction="none")
    return (per_level * valid).sum(1, keepdim=True)
