"""Datasets (counterpart: `paddle_tpu/vision/datasets.py`).

Nothing is downloaded: `FakeData` / `FakeImageNet` (deterministic in the
index) cover the training loop, and `DatasetFolder` / `ImageFolder` read
local files (images through PIL, imported when a file is read, since the
card's machine has no PIL; `.npy` files through numpy).  The named
datasets (MNIST, Cifar10, ...) raise NotImplementedError, as in the
reference.
"""
from __future__ import annotations

import numpy as np

from ..io import Dataset


class FakeData(Dataset):
    """Synthetic image classification dataset (deterministic per index)."""

    def __init__(self, size=1000, image_shape=(3, 224, 224), num_classes=1000,
                 transform=None):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        img = rng.rand(*self.image_shape).astype(np.float32)
        label = rng.randint(0, self.num_classes)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(label)


FakeImageNet = FakeData


class MNIST(Dataset):
    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        raise NotImplementedError(
            "dataset downloads are unavailable in this offline environment; "
            "use vision.datasets.FakeData or point image_path at local files")


Cifar10 = MNIST
Cifar100 = MNIST
Flowers = MNIST
VOC2012 = MNIST


def _scan_files(root, extensions, is_valid_file):
    """Walk `root` collecting files matching the extension/predicate
    filter (shared by DatasetFolder and ImageFolder)."""
    import os
    if not os.path.isdir(root):
        raise FileNotFoundError(f"dataset root {root!r} does not exist")
    exts = tuple(e.lower() for e in extensions)
    found = []
    for base, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            path = os.path.join(base, f)
            ok = is_valid_file(path) if is_valid_file else \
                f.lower().endswith(exts)
            if ok:
                found.append(path)
    return found


class DatasetFolder(Dataset):
    """Generic folder-of-class-subfolders dataset (reference:
    python/paddle/vision/datasets/folder.py) — fully functional offline:
    root/class_x/xxx.ext layout, PIL-decoded samples."""

    IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm",
                      ".tif", ".tiff", ".webp", ".npy")

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        import os
        self.root = root
        self.transform = transform
        self.loader = loader or self.default_loader
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise ValueError(f"no class folders found under {root!r}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            for path in _scan_files(os.path.join(root, c),
                                    extensions or self.IMG_EXTENSIONS,
                                    is_valid_file):
                self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise ValueError(f"no valid files found under {root!r}")

    @staticmethod
    def default_loader(path):
        import numpy as np
        if path.lower().endswith(".npy"):
            return np.load(path)
        from PIL import Image
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))

    def __getitem__(self, i):
        path, label = self.samples[i]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, label

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat folder of images, no labels (reference: folder.py
    ImageFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.loader = loader or DatasetFolder.default_loader
        self.transform = transform
        self.samples = _scan_files(
            root, extensions or DatasetFolder.IMG_EXTENSIONS,
            is_valid_file)
        if not self.samples:
            raise ValueError(f"no valid files found under {root!r}")

    def __getitem__(self, i):
        sample = self.loader(self.samples[i])
        if self.transform is not None:
            sample = self.transform(sample)
        return (sample,)

    def __len__(self):
        return len(self.samples)
