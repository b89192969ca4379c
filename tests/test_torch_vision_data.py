"""The port's vision datasets and transforms against the JAX package's,
on the CPU.

Every transform takes the same uint8 HWC image (numpy, from a seed) and
the same `np.random` state, and must give the reference's output: equal
for the integer and layout transforms, and within float32 rounding
(rtol 1e-6, atol 1e-6) where both compute in float32 in another order.
`Resize` resizes as `jax.image.resize` does through the port's
`interpolate` (torch's antialiased kernels): float32 images within 1e-4
at the 0-255 scale, uint8 ones within 1 (the reference truncates a
float result to uint8, so a rounding difference can move a pixel by
one).  `Compose` fuses ToTensor + Normalize into the native pass on a
uint8 image: its output equals the two transforms run apart (rtol
1e-6), and a transform returns a CPU tensor or a numpy array, never a
tensor on another device.  The datasets: `FakeData` gives the
reference's images and labels; `DatasetFolder` / `ImageFolder` read the
same `.npy` tree; the named downloads raise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.vision.datasets as jds
import paddle_tpu.vision.transforms as JT
from paddle_tpu_torch.io.native import imgproc
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as T

MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


def _img(seed=0, shape=(20, 24, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _np(x):
    if isinstance(x, torch.Tensor):
        assert x.device.type == "cpu"
        return x.numpy()
    if hasattr(x, "_array"):           # a JAX package Tensor
        return np.asarray(x.numpy())
    return np.asarray(x)


# name: (make(module), exact)
TRANSFORMS = {
    "to_tensor": (lambda m: m.ToTensor(), False),
    "to_tensor_hwc": (lambda m: m.ToTensor(data_format="HWC"), False),
    "normalize": (lambda m: m.Normalize(MEAN, STD, data_format="HWC"),
                  False),
    "center_crop": (lambda m: m.CenterCrop(12), True),
    "random_crop": (lambda m: m.RandomCrop(10, padding=2), True),
    "hflip": (lambda m: m.RandomHorizontalFlip(0.7), True),
    "vflip": (lambda m: m.RandomVerticalFlip(0.7), True),
    "transpose": (lambda m: m.Transpose(), True),
    "pad": (lambda m: m.Pad([1, 2, 3, 4], fill=7), True),
    "pad_reflect": (lambda m: m.Pad(2, padding_mode="reflect"), True),
    "grayscale": (lambda m: m.Grayscale(3), True),
    "brightness": (lambda m: m.BrightnessTransform(0.4), True),
    "contrast": (lambda m: m.ContrastTransform(0.4), True),
    "saturation": (lambda m: m.SaturationTransform(0.4), True),
    "hue": (lambda m: m.HueTransform(0.2), True),
    "color_jitter": (lambda m: m.ColorJitter(0.3, 0.3, 0.3, 0.1), True),
    "rotation": (lambda m: m.RandomRotation(30), True),
    "erasing": (lambda m: m.RandomErasing(prob=1.0, value=[1, 2, 3]),
                True),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_the_reference(name):
    make, exact = TRANSFORMS[name]
    img = _img(1)
    outs = []
    for mod in (T, JT):
        np.random.seed(5)
        outs.append(_np(make(mod)(img)))
    ours, ref = outs
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    if exact:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [(12, 9), (33, 40)])
@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_resize_matches_the_reference(size, interp):
    img = _img(2)
    f = img.astype(np.float32)
    ours = T.Resize(size, interp)(f)
    ref = np.asarray(JT.Resize(size, interp)(f))
    assert ours.shape == ref.shape == size + (3,)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    ours8 = T.Resize(size, interp)(img)
    ref8 = np.asarray(JT.Resize(size, interp)(img))
    assert ours8.dtype == np.uint8
    assert np.abs(ours8.astype(int) - ref8.astype(int)).max() <= 1
    np.random.seed(3)
    a = T.RandomResizedCrop(8)(f)
    np.random.seed(3)
    b = np.asarray(JT.RandomResizedCrop(8)(f))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


FUNCTIONAL = {
    "crop": lambda m, x: m.crop(x, 2, 3, 8, 9),
    "center_crop": lambda m, x: m.center_crop(x, 10),
    "hflip": lambda m, x: m.hflip(x),
    "vflip": lambda m, x: m.vflip(x),
    "pad": lambda m, x: m.pad(x, 3, fill=1),
    "rotate": lambda m, x: m.rotate(x, 20),
    "to_grayscale": lambda m, x: m.to_grayscale(x, 1),
    "adjust_brightness": lambda m, x: m.adjust_brightness(x, 1.3),
    "adjust_contrast": lambda m, x: m.adjust_contrast(x, 0.7),
    "adjust_hue": lambda m, x: m.adjust_hue(x, 0.15),
    "normalize": lambda m, x: m.normalize(
        x.astype(np.float32), MEAN, STD, data_format="HWC"),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_functional_transform_matches_the_reference(name):
    img = _img(4)
    ours = _np(FUNCTIONAL[name](T, img))
    ref = _np(FUNCTIONAL[name](JT, img))
    np.testing.assert_allclose(ours.astype(np.float64),
                               ref.astype(np.float64), rtol=1e-6, atol=1e-6)


@pytest.mark.skipif(not imgproc.available(), reason="no g++ for imgproc")
def test_compose_fuses_to_tensor_and_normalize():
    pipe = T.Compose([T.RandomHorizontalFlip(0.5), T.ToTensor(),
                      T.Normalize(MEAN, STD)])
    assert [type(t).__name__ for t in pipe.transforms] == \
        ["RandomHorizontalFlip", "_FusedToTensorNormalize"]
    ref_pipe = JT.Compose([JT.RandomHorizontalFlip(0.5), JT.ToTensor(),
                           JT.Normalize(MEAN, STD)])
    for seed in range(3):
        img = _img(seed, (16, 12, 3))
        np.random.seed(seed)
        fused = pipe(img)
        np.random.seed(seed)
        apart = T.Normalize(MEAN, STD)(T.ToTensor()(
            T.RandomHorizontalFlip(0.5)(img)))
        np.random.seed(seed)
        ref = _np(ref_pipe(img))
        assert isinstance(fused, torch.Tensor) and fused.device.type == \
            "cpu" and fused.shape == (3, 16, 12)
        np.testing.assert_allclose(fused.numpy(), apart.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(fused.numpy(), ref, rtol=1e-6, atol=1e-6)
    # batched NHWC -> NCHW, and a {0, 1} mask that ToTensor does not scale
    batch = np.stack([_img(s, (6, 5, 3)) for s in range(4)])
    out = imgproc.to_chw_f32(batch, MEAN, STD)
    mean, std = np.reshape(MEAN, (3, 1, 1)), np.reshape(STD, (3, 1, 1))
    np.testing.assert_allclose(
        out, (batch.transpose(0, 3, 1, 2) / 255.0 - mean) / std, rtol=1e-5,
        atol=1e-5)
    mask = (_img(9, (4, 4, 3)) > 128).astype(np.uint8)
    np.testing.assert_allclose(pipe.transforms[1](mask).numpy(),
                               _np(ref_pipe.transforms[1](mask)), rtol=1e-6)


def test_datasets_match_the_reference(tmp_path):
    fake = tds.FakeData(size=5, image_shape=(3, 4, 4), num_classes=7)
    ref = jds.FakeData(size=5, image_shape=(3, 4, 4), num_classes=7)
    assert len(fake) == len(ref) == 5 and tds.FakeImageNet is tds.FakeData
    for i in range(5):
        (a, la), (b, lb) = fake[i], ref[i]
        np.testing.assert_array_equal(a, b)
        assert la == lb and a.dtype == np.float32
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for k in range(2):
            np.save(tmp_path / cls / f"{k}.npy", _img(k, (4, 4, 3)))
    folder = tds.DatasetFolder(str(tmp_path), transform=T.ToTensor())
    jfolder = jds.DatasetFolder(str(tmp_path), transform=JT.ToTensor())
    assert folder.classes == jfolder.classes == ["cat", "dog"]
    assert [s[1] for s in folder.samples] == [s[1] for s in jfolder.samples]
    np.testing.assert_allclose(folder[3][0].numpy(), _np(jfolder[3][0]))
    flat = tds.ImageFolder(str(tmp_path / "cat"))
    assert len(flat) == 2 and flat[1][0].shape == (4, 4, 3)
    with pytest.raises(NotImplementedError):
        tds.MNIST()
