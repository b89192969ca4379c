"""Datasets, samplers and the DataLoader (counterpart:
`paddle_tpu/io/__init__.py`).

The samplers draw with the same `np.random` calls as the reference
(`paddle_tpu/io/__init__.py:120-131`), so one numpy seed gives both
packages the same order.  `DataLoader` runs the batches in the caller's
thread (`num_workers=0`), in worker processes that ship numpy batches
through the native shared-memory ring (`shm_loader`), or in a thread
pool.  As in the reference it falls back to threads, with a warning,
when the work cannot cross to a process (it does not pickle) or the
samples hold device data; the port counts every such fallback in
`fallback_counts`, which the card's check reads.

Batches are CPU tensors.  With `use_buffer_reader` (the default) the
loader stages them on the device: each batch is copied into pinned host
memory (a worker process's batch is read out of its ring straight into
pinned memory) and sent with `non_blocking` copies on a side stream,
`prefetch_factor` batches ahead; the consumer's stream waits on each
batch's copy event, and every staged tensor is marked as used by that
stream (`record_stream`), so its memory is not reused before the step
that reads it is done.  The device is `places` (a str, torch.device or
`Place`), else `device.resolve_device(None)`: the card, or the CPU after
`set_device("cpu")`; with neither it raises, as every entry point of the
port does.  On the CPU staging is a no-op.
"""
from __future__ import annotations

import collections
import itertools
import math
import queue
import threading
import warnings

import numpy as np
import torch

from .. import device as _device
from ..tensor import Tensor  # noqa: F401  (the reference's name)
from . import native, shm_loader
from .shm_loader import ShmWorkerPool, WorkerInfo, get_worker_info

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset", "ConcatDataset",
           "DataLoader", "Dataset", "DistributedBatchSampler",
           "IterableDataset", "RandomSampler", "Sampler", "SequenceSampler",
           "ShmWorkerPool", "Subset", "SubsetRandomSampler", "TensorDataset",
           "WeightedRandomSampler", "WorkerInfo", "default_collate_fn",
           "fallback_counts", "get_worker_info", "native", "random_split",
           "shm_loader"]

# why DataLoaders ran their workers as threads, an epoch each:
# {"unpicklable": n, "device_data": n, "no_compiler": n}
fallback_counts = collections.Counter()


def _count_fallback(reason, why):
    fallback_counts[reason] += 1
    warnings.warn(f"DataLoader: {why}; falling back to threads",
                  RuntimeWarning)


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._sizes = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self._sizes)

    def __getitem__(self, idx):
        for d, n in zip(self.datasets, self._sizes):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        return itertools.chain(*self.datasets)


class ComposeDataset(Dataset):
    """Column-wise composition: sample i is the concatenation of sample i
    of every dataset (reference: paddle.io.ComposeDataset)."""

    def __init__(self, datasets):
        assert datasets, "ComposeDataset needs at least one dataset"
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        for d in self.datasets[1:]:
            assert len(d) == n, "ComposeDataset datasets must align"

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            s = d[idx]
            out.extend(s if isinstance(s, (tuple, list)) else (s,))
        return tuple(out)


def random_split(dataset, lengths, generator=None):
    n = len(dataset)
    if sum(lengths) != n:
        raise ValueError("lengths must sum to dataset size")
    perm = np.random.permutation(n)
    out, offset = [], 0
    for size in lengths:
        out.append(Subset(dataset, perm[offset:offset + size].tolist()))
        offset += size
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    """Indices drawn with the given weights (reference: paddle.io
    WeightedRandomSampler)."""

    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        if (self.weights < 0).any():
            raise ValueError("weights must be non-negative")
        if self.weights.sum() <= 0:
            raise ValueError("weights must sum to a positive value")
        if num_samples <= 0:
            raise ValueError("num_samples must be positive")
        self.num_samples = num_samples
        self.replacement = replacement
        if not replacement and num_samples > len(self.weights):
            raise ValueError(
                "num_samples > population without replacement")

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(p), size=self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        super().__init__(None)
        self.indices = list(indices)

    def __iter__(self):
        return iter(np.random.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)


class DistributedBatchSampler(BatchSampler):
    """Shards the indices across data-parallel ranks (reference:
    paddle.io.DistributedBatchSampler); the rank and world size default
    to `distributed.get_rank()` / `get_world_size()`."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        if num_replicas is None or rank is None:
            from ..distributed import get_rank, get_world_size
            num_replicas = get_world_size() if num_replicas is None \
                else num_replicas
            rank = get_rank() if rank is None else rank
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas
        self.local_rank = rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(
                n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - n]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return math.ceil(self.num_samples / self.batch_size)


def _host_only(obj):
    """True when the sample holds no device tensor."""
    if isinstance(obj, torch.Tensor):
        return obj.device.type == "cpu"
    if isinstance(obj, (list, tuple)):
        return all(_host_only(o) for o in obj)
    if isinstance(obj, dict):
        return all(_host_only(v) for v in obj.values())
    return True


def _from_numpy_tree(obj):
    """The trainer's side: numpy arrays from the ring become CPU
    tensors (no copy)."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_numpy_tree(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _from_numpy_tree(v) for k, v in obj.items()}
    return obj


def _pinned_bytes(n):
    return torch.empty(n, dtype=torch.uint8, pin_memory=True)


def default_collate_fn(batch):
    """Samples -> a batch of CPU tensors (tuples, lists and dicts field by
    field; numpy arrays and Python numbers stacked)."""
    item = batch[0]
    if isinstance(item, (tuple, list)):
        return type(item)(default_collate_fn([b[i] for b in batch])
                          for i in range(len(item)))
    if isinstance(item, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in item}
    if isinstance(item, torch.Tensor):
        return torch.stack(batch)
    if isinstance(item, (np.ndarray, np.generic)):
        return torch.from_numpy(np.stack(batch))
    if isinstance(item, (int, float)):
        return torch.as_tensor(np.asarray(batch))
    return batch


def _numpy_collate(batch):
    """`default_collate_fn` in a worker process: numpy out."""
    item = batch[0]
    if isinstance(item, (tuple, list)):
        return type(item)(_numpy_collate([b[i] for b in batch])
                          for i in range(len(item)))
    if isinstance(item, dict):
        return {k: _numpy_collate([b[k] for b in batch]) for k in item}
    if isinstance(item, torch.Tensor):
        return torch.stack(batch).numpy()
    if isinstance(item, (np.ndarray, np.generic)):
        return np.stack(batch)
    if isinstance(item, (int, float)):
        return np.asarray(batch)
    return batch


class _IndexBatches:
    """A map-style dataset's batch iterator for worker w of W: batches w,
    w+W, ... of the sampler's index lists."""

    def __init__(self, dataset, index_lists):
        self.dataset = dataset
        self.index_lists = index_lists

    def __call__(self, worker_id, num_workers):
        for bi in range(worker_id, len(self.index_lists), num_workers):
            yield [self.dataset[i] for i in self.index_lists[bi]]


class _StreamBatches:
    """An IterableDataset's batch iterator in a worker: the loader does
    not shard it; the dataset consults `get_worker_info()` and yields its
    own shard (one that ignores it is replicated a worker)."""

    def __init__(self, dataset, batch_size):
        self.dataset = dataset
        self.batch_size = batch_size

    def __call__(self, worker_id, num_workers):
        it = iter(self.dataset)
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch:
                return
            yield batch


class _Staging:
    """Pinned host memory and `non_blocking` copies on a side stream to
    `device`, `depth` batches ahead of the consumer."""

    def __init__(self, device, depth):
        self.device = device
        self.depth = depth
        self.stream = torch.cuda.Stream(device)

    def put(self, x):
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                return x.to(self.device, non_blocking=True)
            if not x.is_pinned():
                x = x.pin_memory()
            return x.to(self.device, non_blocking=True)
        if isinstance(x, (np.ndarray, np.generic)):
            return self.put(torch.as_tensor(x))
        if isinstance(x, (tuple, list)):
            return type(x)(self.put(v) for v in x)
        if isinstance(x, dict):
            return {k: self.put(v) for k, v in x.items()}
        return x

    def stage(self, batch):
        with torch.cuda.stream(self.stream):
            staged = self.put(batch)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        return staged, ev

    def hand_over(self, staged, ev):
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(ev)
        for t in _tensors(staged):
            t.record_stream(consumer)
        return staged

    def __call__(self, iterator):
        buf = collections.deque()
        for batch in iterator:
            buf.append(self.stage(batch))
            if len(buf) >= self.depth:
                yield self.hand_over(*buf.popleft())
        while buf:
            yield self.hand_over(*buf.popleft())


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 timeout=0, worker_init_fn=None, persistent_workers=False,
                 use_shared_memory=True, ring_bytes=None, max_respawns=2):
        self.dataset = dataset
        self.places = places
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_buffer_reader = use_buffer_reader
        self.prefetch_factor = max(prefetch_factor, 1)
        self.timeout = timeout
        self.max_respawns = max_respawns
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = use_shared_memory
        self.ring_bytes = ring_bytes
        self._probe_host = None   # a map-style dataset's probe, once
        self._iterable = isinstance(dataset, IterableDataset)
        if not self._iterable:
            self.batch_sampler = batch_sampler or BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        else:
            self.batch_sampler = None
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _index_batches(self):
        if self._iterable:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                yield batch
        else:
            for idxs in self.batch_sampler:
                yield [self.dataset[i] for i in idxs]

    def __iter__(self):
        staging = None
        if self.use_buffer_reader:
            device = _device.resolve_device(self.places)
            if device.type == "cuda":
                staging = _Staging(device, self.prefetch_factor)
        it = self._batches_iter(pinned=staging is not None)
        yield from (staging(it) if staging is not None else it)

    def _batches_iter(self, pinned=False):
        if self.num_workers == 0:
            for samples in self._index_batches():
                yield self.collate_fn(samples)
            return
        if self._use_process_workers():
            yield from self._process_iter(pinned)
            return
        if self.use_shared_memory:     # asked for processes, got threads
            if native.available():
                _count_fallback("device_data",
                                "the samples hold device tensors")
            else:
                _count_fallback("no_compiler",
                                "the native ring did not build (g++)")
        yield from self._threaded_iter()

    # ------------------------------------------------- process workers
    def _use_process_workers(self):
        if not (self.use_shared_memory and native.available()):
            return False
        if self._iterable:
            # no probe: iterating could consume a single-use stream
            return True
        if self._probe_host is None:
            # device tensors must not cross to a worker: probe ONE sample,
            # once a DataLoader
            try:
                self._probe_host = _host_only(self.dataset[0])
            except Exception:
                self._probe_host = False
        return self._probe_host

    def _process_iter(self, pinned=False):
        if self._iterable:
            batch_iter_fn = _StreamBatches(self.dataset, self.batch_size)
        else:
            batch_iter_fn = _IndexBatches(self.dataset,
                                          list(self.batch_sampler))
        worker_collate = _numpy_collate \
            if self.collate_fn is default_collate_fn else self.collate_fn
        try:
            spec_blob = shm_loader.serialize_spec(
                self.num_workers, self.dataset, batch_iter_fn,
                worker_collate, self.worker_init_fn)
        except Exception as e:
            _count_fallback("unpicklable", f"the dataset, collate or init "
                            f"function does not pickle for a worker "
                            f"process ({e})")
            yield from self._threaded_iter()
            return
        pool = ShmWorkerPool(
            self.num_workers, self.dataset, batch_iter_fn, worker_collate,
            worker_init_fn=self.worker_init_fn,
            **({"ring_bytes": self.ring_bytes} if self.ring_bytes
               else {}),
            timeout_s=self.timeout, spec_blob=spec_blob,
            max_respawns=self.max_respawns,
            # staged for the card: read each batch into pinned memory
            alloc=_pinned_bytes if pinned else None)
        for batch in pool:
            yield _from_numpy_tree(batch)

    def _threaded_iter(self):
        q = queue.Queue(maxsize=self.num_workers * self.prefetch_factor)
        sentinel = object()

        def producer():
            try:
                if self._iterable:
                    for samples in self._index_batches():
                        q.put(self.collate_fn(samples))
                else:
                    import concurrent.futures as cf
                    with cf.ThreadPoolExecutor(self.num_workers) as ex:
                        futs = [
                            ex.submit(lambda idxs=idxs: self.collate_fn(
                                [self.dataset[i] for i in idxs]))
                            for idxs in self.batch_sampler]
                        for f in futs:
                            q.put(f.result())
            except BaseException as e:   # to the consumer's thread
                q.put(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
