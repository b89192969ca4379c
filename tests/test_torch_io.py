"""The port's `io` against the JAX package's, on the CPU.

* Every sampler and `random_split` draws the same order as the JAX
  package's under one `np.random` seed (the same numpy calls), and the
  DistributedBatchSampler shards the same way on every rank.
* `default_collate_fn` stacks what the reference stacks.
* The in-process, thread and process loaders give the same batches, and
  those of the JAX package's in-process loader (values equal: both
  stack the same float32 arrays).
* The native ring: a round trip, a wrap-around, the batch message with
  out-of-band buffers, and a batch larger than the ring raising.
* The process workers: a worker's exception propagates with its type,
  an IterableDataset shards itself by `get_worker_info()`,
  `worker_init_fn` runs in each worker, a worker imports neither JAX nor
  the JAX package, and a dataset of device tensors or a lambda collate
  falls back to threads with a warning and a count.
* Faults, as the reference behaves: `loader.worker_kill` respawns the
  worker and the batches stay in order; an exhausted respawn budget
  raises; a hang past the timeout respawns; a corrupt batch is skipped
  with a warning (`tests/test_chaos_resilience.py` for the reference).
* The device staging resolves its device as every entry point does: the
  CPU named (`places`, `set_device("cpu")`) stages nowhere, and without
  a card and without either it raises.

Few process-worker cases: each pool starts worker processes.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import torch_io_data as data
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import io
from paddle_tpu_torch.io import native, shm_loader
from paddle_tpu_torch.resilience import chaos

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no g++ to build the native ring")


def _loader(ds, **kw):
    return io.DataLoader(ds, places="cpu", **kw)


def _flat(batches):
    return [[np.asarray(x) for x in (b if isinstance(b, (list, tuple))
                                     else [b])] for b in batches]


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(_flat(a), _flat(b)):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


# ----------------------------------------------------------- the samplers
@pytest.mark.parametrize("name", ["sequence", "random", "random_repl",
                                  "weighted", "subset", "batch_shuffle",
                                  "batch_drop_last", "split"])
def test_sampler_order_matches_jax(name):
    ds = data.Rows(23)

    def draw(m):
        np.random.seed(7)
        if name == "sequence":
            return list(m.SequenceSampler(ds))
        if name == "random":
            return list(m.RandomSampler(ds))
        if name == "random_repl":
            return list(m.RandomSampler(ds, replacement=True,
                                        num_samples=30))
        if name == "weighted":
            return list(m.WeightedRandomSampler(np.arange(1, 24), 40))
        if name == "subset":
            return list(m.SubsetRandomSampler(range(3, 19)))
        if name == "batch_shuffle":
            return list(m.BatchSampler(ds, shuffle=True, batch_size=5))
        if name == "batch_drop_last":
            s = m.BatchSampler(ds, batch_size=5, drop_last=True)
            return [len(s)] + list(s)
        return [sub.indices for sub in m.random_split(ds, [10, 13])]

    assert draw(io) == draw(jio)


@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_batch_sampler_matches_jax(shuffle):
    ds = data.Rows(23)
    for rank in range(3):
        ours = io.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                          shuffle=shuffle)
        ref = jio.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                          shuffle=shuffle)
        ours.set_epoch(2)
        ref.set_epoch(2)
        assert list(ours) == list(ref) and len(ours) == len(ref)


def test_default_collate_matches_jax():
    samples = [({"a": np.full(3, i, np.float32)}, i, float(i) / 2)
               for i in range(4)]
    ours = io.default_collate_fn(samples)
    ref = jio.default_collate_fn(samples)
    np.testing.assert_array_equal(ours[0]["a"].numpy(),
                                  np.asarray(ref[0]["a"].numpy()))
    np.testing.assert_array_equal(ours[1].numpy(), ref[1].numpy())
    np.testing.assert_allclose(ours[2].numpy(), ref[2].numpy())
    assert isinstance(ours[0]["a"], torch.Tensor)


# ------------------------------------------------------------ the loaders
def test_loaders_give_the_same_batches_as_each_other_and_jax():
    ds = data.Rows()
    np.random.seed(3)
    serial = list(_loader(ds, batch_size=4, shuffle=True))
    np.random.seed(3)
    threads = list(_loader(ds, batch_size=4, shuffle=True, num_workers=2,
                           use_shared_memory=False))
    np.random.seed(3)
    procs = list(_loader(ds, batch_size=4, shuffle=True, num_workers=3))
    np.random.seed(3)
    ref = [[b[0].numpy(), b[1].numpy()] for b in
           jio.DataLoader(ds, batch_size=4, shuffle=True)]
    _assert_same(serial, threads)
    _assert_same(serial, procs)
    _assert_same(serial, ref)
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for b in procs for t in b)
    assert procs[0][1].dtype == torch.int64


def test_the_probe_draws_before_the_shuffled_order():
    """As the reference's process loader, the port's reads sample 0
    before it draws a shuffled order: a sample that draws from np.random
    (a random flip) moves the order by one draw."""
    np.random.seed(4)
    np.random.rand()
    want = np.random.permutation(12).tolist()
    np.random.seed(4)
    got = [int(i) for b in _loader(data.Flips(), batch_size=3, shuffle=True,
                                   num_workers=2) for i in b]
    assert got == want


def test_worker_exception_propagates():
    with pytest.raises(ValueError, match="boom at 5"):
        list(_loader(data.Failing(), batch_size=2, num_workers=2))


def test_iterable_dataset_shards_itself_and_init_fn_runs():
    got = []
    for b in _loader(data.Stream(), batch_size=3, num_workers=2):
        got.extend(np.atleast_1d(b.numpy()).tolist())
    assert sorted(got) == list(range(20))
    out, inits = [], []
    for b in _loader(data.Probe(), batch_size=1, num_workers=2,
                     worker_init_fn=data.set_env):
        out.extend(b[0].tolist())
        inits.extend(b[1].tolist())
    assert out == [0, 1, 0, 1] and inits == [100, 101, 100, 101]


def test_worker_processes_import_no_jax():
    """In a fresh interpreter: the forkserver is one a process, and a
    test process that ran the JAX package's loader first holds one that
    imported JAX, which every later worker would inherit."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import torch_io_data as data\n"
            "from paddle_tpu_torch.io import DataLoader\n"
            "seen = [int(b) for b in DataLoader(data.Modules(), "
            "batch_size=1, num_workers=2, places='cpu')]\n"
            "assert seen == [0, 0], seen\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here]))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def test_fallbacks_to_threads_warn_and_count():
    before = dict(io.fallback_counts)
    dl = _loader(io.TensorDataset([torch.zeros(6, 2, device="meta")]),
                 batch_size=3, num_workers=2)
    assert not dl._use_process_workers()
    with pytest.warns(RuntimeWarning, match="device tensors"):
        list(dl)
    with pytest.warns(RuntimeWarning, match="does not pickle"):
        got = list(_loader(data.Rows(8), batch_size=4, num_workers=2,
                           collate_fn=lambda s: len(s)))
    assert got == [4, 4]
    assert io.fallback_counts["device_data"] == \
        before.get("device_data", 0) + 1
    assert io.fallback_counts["unpicklable"] == \
        before.get("unpicklable", 0) + 1


# --------------------------------------------------------- the native ring
def test_ring_roundtrip_wraparound_and_batch_message():
    r = shm_loader._Ring(1 << 16)
    for payload in (b"x", b"y" * 1000, b"z" * 30000):
        r.write(payload)
        n = r.next_len(1000)
        assert r.read(n).tobytes() == payload
    r.close_producer()
    assert r.next_len(1000) == -1
    r.release()
    r = shm_loader._Ring(native.LIB.ring_hdr_size() + 256)
    for i in range(50):           # many wraps of the 256-byte region
        msg = bytes([i]) * (i % 100 + 1)
        r.write(msg)
        assert r.read(r.next_len(1000)).tobytes() == msg
    with pytest.raises(ValueError, match="ring_bytes"):
        r.write(b"q" * 512)
    r.release()
    batch = (np.arange(12, dtype=np.float32).reshape(3, 4),
             {"k": np.ones(5, np.int64)}, 7)
    msg = np.frombuffer(shm_loader.encode_batch(batch), np.uint8).copy()
    out = shm_loader.decode_batch(msg)
    np.testing.assert_array_equal(out[0], batch[0])
    np.testing.assert_array_equal(out[1]["k"], batch[1]["k"])
    assert out[2] == 7 and out[0].ctypes.data % 64 == \
        msg.ctypes.data % 64


def test_pool_reads_into_the_buffer_it_is_given():
    """The path the card's staging takes (there the buffer is pinned):
    each batch's arrays come out as tensor views of the buffer its
    message was read into, equal to the in-process batches."""
    ds = data.Rows(12)
    index_lists = list(io.BatchSampler(ds, batch_size=4))
    bufs = []

    def alloc(n):
        bufs.append(torch.empty(n, dtype=torch.uint8))
        return bufs[-1]

    pool = io.ShmWorkerPool(2, ds, io._IndexBatches(ds, index_lists),
                            io._numpy_collate, alloc=alloc)
    got = list(pool)
    assert len(got) == len(bufs) == 3
    for (x, i), buf, idx in zip(got, bufs, index_lists):
        assert isinstance(x, torch.Tensor)
        assert x.untyped_storage().data_ptr() == buf.data_ptr()
        np.testing.assert_array_equal(x.numpy(), ds.x[idx])
        assert i.tolist() == idx


# ------------------------------------------------------------------ faults
def _collect(dl):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        batches = [b.numpy() for b in dl]
    return batches, [str(x.message) for x in w]


def test_worker_kill_respawns_in_order_and_budget_raises():
    with chaos.scoped("loader.worker_kill@2#0") as plan:
        batches, msgs = _collect(_loader(data.Seq(), batch_size=2,
                                         num_workers=2))
    assert [int(b[0, 0]) for b in batches] == list(range(0, 16, 2))
    assert any("respawning" in m for m in msgs)
    assert plan.log == [("loader.worker_kill", "0", 2)]
    with chaos.scoped("loader.worker_kill@1#0*inf"):
        dl = _loader(data.Seq(), batch_size=2, num_workers=1,
                     max_respawns=1)
        with pytest.raises(RuntimeError, match="respawn budget"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                list(dl)


def test_hang_times_out_and_corrupt_batch_is_skipped():
    # the timeout outlasts a worker's start (seconds where the process's
    # forkserver was started without torch, by the JAX package's loader)
    with chaos.scoped("loader.worker_hang@1#0"):
        batches, msgs = _collect(_loader(data.Seq(), batch_size=2,
                                         num_workers=2, timeout=5))
    assert [int(b[0, 0]) for b in batches] == list(range(0, 16, 2))
    assert any("wedged" in m for m in msgs)
    with chaos.scoped("loader.batch_corrupt@1#1"):
        batches, msgs = _collect(_loader(data.Seq(), batch_size=2,
                                         num_workers=2))
    assert len(batches) == 7                  # one poisoned batch dropped
    assert [int(b[0, 0]) for b in batches] == [0, 4, 6, 8, 10, 12, 14]
    assert any("batch skipped" in m for m in msgs)


def test_take_loader_directives_matches_jax():
    from paddle_tpu.resilience import chaos as jchaos
    spec = ("loader.worker_kill@2#1;loader.worker_hang@3;"
            "loader.batch_corrupt~0.25")
    ours, ref = chaos.ChaosPlan(spec), jchaos.ChaosPlan(spec)
    for mod, plan in ((chaos, ours), (jchaos, ref)):
        mod.install(plan)
    try:
        got = [(chaos.take_loader_directives(w),
                jchaos.take_loader_directives(w)) for w in (0, 1, 1)]
    finally:
        chaos.uninstall()
        jchaos.uninstall()
    for a, b in got:
        assert a == b
    assert ours.log == ref.log


# ----------------------------------------------------------- device staging
def test_staging_resolves_the_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdevice, "_current_place", [None])
    dl = io.DataLoader(data.Rows(8), batch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(iter(dl))
    assert next(iter(io.DataLoader(data.Rows(8), batch_size=4,
                                   use_buffer_reader=False)))[0].shape \
        == (4, 5)
    tdevice.set_device("cpu")
    b = next(iter(dl))
    assert b[0].device.type == "cpu" and b[0].shape == (4, 5)
