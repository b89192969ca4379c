"""Datasets for the DataLoader tests of the port.

A DataLoader's worker process finds its dataset by module and name (the
work spec crosses with the standard pickle), so the datasets the process
workers load live here, in a module that imports numpy and the port
only: the worker then imports neither JAX nor the JAX package, as a test
module would make it do.
"""
import os

import numpy as np

from paddle_tpu_torch.io import IterableDataset, get_worker_info


class Rows:
    """n rows of `dim` floats from a seed, and the row's index."""

    def __init__(self, n=37, dim=5, seed=0):
        self.x = np.random.default_rng(seed).standard_normal(
            (n, dim)).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], np.int64(i)


class Seq:
    """Sample i is a 4-vector of the value i (the chaos drills' data)."""

    def __len__(self):
        return 16

    def __getitem__(self, i):
        return np.full((4,), i, dtype=np.float32)


class Failing:
    """Raises at sample 5."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return np.zeros(3, np.float32)


class Stream(IterableDataset):
    """An iterable of 0..19 that shards itself by `get_worker_info()`."""

    def __iter__(self):
        info = get_worker_info()
        data = np.arange(20, dtype=np.int64)
        if info is not None:
            data = data[info.id::info.num_workers]
        return iter(data)


class Probe:
    """The worker's id and what `set_env` left in its environment."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        info = get_worker_info()
        return (np.int64(info.id if info else -1),
                np.int64(int(os.environ.get("_TORCH_IO_INIT", "-1"))))


def set_env(worker_id):
    os.environ["_TORCH_IO_INIT"] = str(100 + worker_id)


class Modules:
    """The names of the top-level modules a worker has imported."""

    def __len__(self):
        return 2

    def __getitem__(self, i):
        import sys
        bad = sorted({m.split(".")[0] for m in sys.modules}
                     & {"jax", "jaxlib", "paddle_tpu", "paddle"})
        return np.int64(len(bad))


class Sequences:
    """`n` ragged token sequences (ids, padding mask, label) made with
    numpy from `seed`; the label is 1 when the first token lies in the
    upper half of the ids.  `labels=False`: the inputs alone."""

    def __init__(self, n, seq, vocab, seed, labels=True):
        rng = np.random.RandomState(seed)
        lens = rng.randint(seq // 2, seq + 1, n)
        self.mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int64)
        self.ids = rng.randint(1, vocab, (n, seq)) * self.mask
        self.labels = (self.ids[:, 0] >= vocab // 2).astype(np.int64)
        self.with_labels = labels

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        if self.with_labels:
            return self.ids[i], self.mask[i], self.labels[i]
        return self.ids[i], self.mask[i]


class Images:
    """`n` float32 CHW images from a seed and a label below `classes`;
    `labels=False`: the images alone."""

    def __init__(self, n, shape=(3, 8, 8), classes=3, seed=0, labels=True):
        rng = np.random.RandomState(seed)
        self.x = rng.standard_normal((n,) + tuple(shape)).astype(np.float32)
        self.y = rng.randint(0, classes, n).astype(np.int64)
        self.with_labels = labels

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        if self.with_labels:
            return self.x[i], self.y[i]
        return (self.x[i],)


class Flips:
    """Sample i is i, after one draw from np.random (a random flip's)."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        np.random.rand()
        return np.int64(i)
