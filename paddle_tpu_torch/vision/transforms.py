"""Vision transforms (counterpart: `paddle_tpu/vision/transforms.py`).

Host-side preprocessing (HWC uint8 in, CHW float out) with the
reference's semantics and random draws (`np.random`, so one numpy seed
gives both packages the same augmentations).  A transform returns a
numpy array or a CPU tensor (`ToTensor`, `Normalize` of a tensor) and
never touches the card: it runs in the DataLoader's workers, and the
loader moves the batch.  `Resize` resizes as `jax.image.resize` does
(`nn.functional.interpolate`, on the CPU).
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

Tensor = torch.Tensor


class Compose:
    """Chains transforms; an adjacent [ToTensor(CHW), Normalize(CHW)] pair
    is fused into ONE native C pass (io/native/imgproc.cc) when the input
    is a uint8 HWC image — uint8→f32, /255+normalize, and the HWC→CHW
    transpose collapse into a single loop (the reference's C++ DataLoader
    workers do this preprocessing natively too).  Falls back to the
    original two numpy transforms for any other input."""

    def __init__(self, transforms):
        self.transforms = self._fuse(list(transforms))

    @staticmethod
    def _fuse(ts):
        out, i = [], 0
        while i < len(ts):
            t, nxt = ts[i], ts[i + 1] if i + 1 < len(ts) else None
            if (isinstance(t, ToTensor) and t.data_format == "CHW"
                    and isinstance(nxt, Normalize)
                    and nxt.data_format == "CHW"):
                out.append(_FusedToTensorNormalize(t, nxt))
                i += 2
            else:
                out.append(t)
                i += 1
        return out

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    def __call__(self, img):
        raise NotImplementedError


def _hwc(img):
    return np.asarray(img)


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = _hwc(img).astype(np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(arr))


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, img):
        arr = img.numpy() if isinstance(img, Tensor) else _hwc(img).astype(
            np.float32)
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m, s = self.mean, self.std
        out = (arr - m) / s
        return torch.from_numpy(out) if isinstance(img, Tensor) else out


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = size if not isinstance(size, numbers.Number) else \
            (int(size), int(size))
        self.interpolation = interpolation

    def __call__(self, img):
        from ..nn.functional import interpolate
        arr = _hwc(img)
        h, w = self.size
        mode = "bilinear" if self.interpolation == "bilinear" else "nearest"
        x = torch.from_numpy(np.asarray(arr, np.float32))
        x = (x[None, None] if arr.ndim == 2 else
             x.permute(2, 0, 1)[None])
        out = interpolate(x, size=(h, w), mode=mode)[0]
        out = out[0] if arr.ndim == 2 else out.permute(1, 2, 0)
        return out.numpy().astype(arr.dtype)


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, numbers.Number) else size

    def __call__(self, img):
        arr = _hwc(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None):
        self.size = (size, size) if isinstance(size, numbers.Number) else size
        self.padding = padding

    def __call__(self, img):
        arr = _hwc(img)
        if self.padding:
            p = self.padding
            arr = np.pad(arr, [(p, p), (p, p)] +
                         [(0, 0)] * (arr.ndim - 2), mode="constant")
        h, w = arr.shape[:2]
        th, tw = self.size
        i = np.random.randint(0, max(h - th, 0) + 1)
        j = np.random.randint(0, max(w - tw, 0) + 1)
        return arr[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return _hwc(img)[:, ::-1].copy()
        return _hwc(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return _hwc(img)[::-1].copy()
        return _hwc(img)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = (size, size) if isinstance(size, numbers.Number) else size
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img):
        arr = _hwc(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                i = np.random.randint(0, h - ch + 1)
                j = np.random.randint(0, w - cw + 1)
                crop = arr[i:i + ch, j:j + cw]
                return Resize(self.size)(crop)
        return Resize(self.size)(CenterCrop(min(h, w))(arr))


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return _hwc(img).transpose(self.order)


class Pad(BaseTransform):
    """reference: paddle.vision.transforms.Pad (constant/edge/reflect)."""

    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = [padding] * 4 if isinstance(padding, int) else \
            list(padding)
        if len(self.padding) == 2:
            self.padding = [self.padding[0], self.padding[1]] * 2
        self.fill = fill
        self.padding_mode = padding_mode

    def __call__(self, img):
        arr = _hwc(img)
        l, t, r, b = self.padding
        pads = [(t, b), (l, r)] + ([(0, 0)] if arr.ndim == 3 else [])
        if self.padding_mode == "constant":
            return np.pad(arr, pads, constant_values=self.fill)
        return np.pad(arr, pads, mode=self.padding_mode)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def __call__(self, img):
        arr = _hwc(img).astype(np.float32)
        if arr.ndim == 2:
            g = arr
        else:
            g = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
                 + 0.114 * arr[..., 2])
        out = np.repeat(g[..., None], self.num_output_channels, axis=-1)
        return out.astype(_hwc(img).dtype)


def _blend(a, b, ratio):
    out = ratio * a.astype(np.float32) + (1.0 - ratio) * b
    if np.issubdtype(np.asarray(a).dtype, np.integer):
        return np.clip(out, 0, 255).astype(np.asarray(a).dtype)
    # float images: the value scale (0-1 vs 0-255) is not knowable from
    # the data, so clip only the lower bound (matches reference behavior
    # for float inputs)
    return np.clip(out, 0.0, None)


class BrightnessTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        if not self.value:
            return _hwc(img)
        f = np.random.uniform(max(0.0, 1.0 - self.value), 1.0 + self.value)
        # scalar second operand: _blend broadcasts, no full-image alloc
        return _blend(_hwc(img), np.float32(0.0), f)


class ContrastTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        if not self.value:
            return _hwc(img)
        arr = _hwc(img)
        f = np.random.uniform(max(0.0, 1.0 - self.value), 1.0 + self.value)
        # reference (F.adjust_contrast): blend toward the mean of the
        # LUMINANCE-weighted grayscale, not the raw channel mean
        mean = Grayscale(1)(arr).astype(np.float32).mean()
        return _blend(arr, np.float32(mean), f)


class SaturationTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        if not self.value:
            return _hwc(img)
        arr = _hwc(img)
        f = np.random.uniform(max(0.0, 1.0 - self.value), 1.0 + self.value)
        gray = Grayscale(3)(arr).astype(np.float32)
        return _blend(arr, gray, f)


class HueTransform(BaseTransform):
    """Hue rotation via the RGB-space linear approximation (YIQ rotation),
    matching the reference's behavior for small factors."""

    def __init__(self, value):
        self.value = value  # in [0, 0.5]

    def __call__(self, img):
        if not self.value:
            return _hwc(img)
        arr = _hwc(img)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            return arr  # hue rotation is undefined off 3-channel RGB
        theta = np.random.uniform(-self.value, self.value) * 2.0 * np.pi
        c, s = np.cos(theta), np.sin(theta)
        m = (np.array([[0.299, 0.587, 0.114]] * 3, np.float32)
             + c * np.array([[0.701, -0.587, -0.114],
                             [-0.299, 0.413, -0.114],
                             [-0.299, -0.587, 0.886]], np.float32)
             + s * np.array([[0.168, 0.330, -0.497],
                             [-0.328, 0.035, 0.292],
                             [1.25, -1.05, -0.203]], np.float32))
        out = _hwc(arr).astype(np.float32) @ m.T
        if np.issubdtype(arr.dtype, np.integer):
            return np.clip(out, 0, 255).astype(arr.dtype)
        return np.clip(out, 0.0, None)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0,
                 hue=0.0):
        self.transforms = [BrightnessTransform(brightness),
                           ContrastTransform(contrast),
                           SaturationTransform(saturation),
                           HueTransform(hue)]

    def __call__(self, img):
        arr = _hwc(img)
        for t in np.random.permutation(self.transforms):
            arr = t(arr)
        return arr


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0):
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)
        self.expand = expand
        self.fill = fill
        self.order = {"nearest": 0, "bilinear": 1}.get(interpolation, 0)
        if center is not None:
            raise NotImplementedError(
                "RandomRotation(center=...) is not supported; rotation is "
                "about the image center")

    def __call__(self, img):
        from scipy import ndimage
        arr = _hwc(img)
        angle = np.random.uniform(*self.degrees)
        axes = (1, 0)
        return ndimage.rotate(arr, angle, axes=axes, reshape=self.expand,
                              order=self.order, mode="constant",
                              cval=self.fill)


class RandomErasing(BaseTransform):
    """reference: paddle.vision.transforms.RandomErasing over CHW
    tensors/arrays."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def __call__(self, img):
        is_tensor = isinstance(img, Tensor)
        if is_tensor:
            arr = img.numpy().copy()
        else:
            arr = _hwc(img) if self.inplace else np.array(_hwc(img))
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3)
        h, w = (arr.shape[1], arr.shape[2]) if chw else arr.shape[:2]
        value = np.asarray(self.value, arr.dtype)
        if value.ndim == 1:
            # per-channel fill broadcasts along the channel axis
            value = value.reshape(-1, 1, 1) if chw else value.reshape(1, 1, -1)
        if np.random.rand() < self.prob:
            for _ in range(10):
                area = h * w * np.random.uniform(*self.scale)
                ratio = np.random.uniform(*self.ratio)
                eh = int(round(np.sqrt(area * ratio)))
                ew = int(round(np.sqrt(area / ratio)))
                if eh < h and ew < w:
                    i = np.random.randint(0, h - eh + 1)
                    j = np.random.randint(0, w - ew + 1)
                    if chw:
                        arr[:, i:i + eh, j:j + ew] = value
                    else:
                        arr[i:i + eh, j:j + ew] = value
                    break
        return torch.from_numpy(arr) if is_tensor else arr


class _FusedToTensorNormalize(BaseTransform):
    """Compose-internal fusion of ToTensor(CHW) + Normalize(CHW); see
    Compose._fuse.  Numerically identical to running the pair."""

    def __init__(self, to_tensor, normalize):
        self.to_tensor = to_tensor
        self.normalize = normalize

    def __call__(self, img):
        from ..io.native import imgproc
        arr = np.asarray(img)
        if (imgproc.available() and arr.dtype == np.uint8
                and arr.ndim == 3):
            # mirror ToTensor's conditional /255 (it only rescales when
            # values exceed 1.5 — e.g. a {0,1} uint8 mask is NOT scaled)
            out = imgproc.to_chw_f32(arr, mean=self.normalize.mean,
                                     std=self.normalize.std,
                                     unit_scale=bool(arr.max() > 1.5))
            return torch.from_numpy(out)
        return self.normalize(self.to_tensor(img))


# ----------------------------------------- round-3 functional transforms
# (reference: python/paddle/vision/transforms/functional.py — the
# class transforms above delegate to these same routines conceptually)
def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format, to_rgb)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def crop(img, top, left, height, width):
    arr = _hwc(img)
    return arr[top:top + height, left:left + width]


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


def hflip(img):
    return _hwc(img)[:, ::-1]


def vflip(img):
    return _hwc(img)[::-1]


def pad(img, padding, fill=0, padding_mode="constant"):
    return Pad(padding, fill, padding_mode)(img)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    from scipy import ndimage
    arr = _hwc(img)
    order = {"nearest": 0, "bilinear": 1}.get(interpolation, 0)
    return ndimage.rotate(arr, angle, reshape=expand, order=order,
                          cval=fill, axes=(0, 1))


def to_grayscale(img, num_output_channels=1):
    return Grayscale(num_output_channels)(img)


def adjust_brightness(img, brightness_factor):
    arr = _hwc(img)
    return _blend(arr, np.zeros_like(arr, np.float32), brightness_factor)


def adjust_contrast(img, contrast_factor):
    arr = _hwc(img).astype(np.float32)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        g = 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
    else:
        g = arr
    return _blend(_hwc(img), np.full_like(arr, g.mean()), contrast_factor)


def adjust_hue(img, hue_factor):
    """DETERMINISTIC hue rotation by exactly hue_factor (in [-0.5, 0.5]
    turns), unlike HueTransform which samples a random shift."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr = _hwc(img)
    if arr.ndim == 2 or arr.shape[-1] == 1:
        return arr
    int_in = np.issubdtype(arr.dtype, np.integer)
    a = arr.astype(np.float32) / (255.0 if int_in else 1.0)
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    maxc = a[..., :3].max(axis=-1)
    minc = a[..., :3].min(axis=-1)
    v = maxc
    c = maxc - minc
    s = np.where(maxc > 0, c / np.maximum(maxc, 1e-12), 0.0)
    safe_c = np.maximum(c, 1e-12)
    h = np.where(
        maxc == r, ((g - b) / safe_c) % 6.0,
        np.where(maxc == g, (b - r) / safe_c + 2.0,
                 (r - g) / safe_c + 4.0)) / 6.0
    h = np.where(c > 0, h, 0.0)
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    out = np.stack([r2, g2, b2], axis=-1)
    if int_in:
        return np.clip(out * 255.0, 0, 255).astype(arr.dtype)
    return out.astype(arr.dtype)
