"""DataLoader worker processes over the native shared-memory ring.

Counterpart: `paddle_tpu/io/shm_loader.py`.  Each worker is a
**forkserver** child (never `os.fork()` of the trainer, which holds a
CUDA context and threads) owning one single-producer single-consumer
ring (`native/ring.cc`) mapped from a file in /dev/shm; worker w
produces batches w, w+W, w+2W, ... so the trainer reads the rings round
robin and the batch order is the sampler's without any coordination
between processes.

A worker never touches CUDA: it runs the dataset and the collate on the
CPU and ships numpy arrays (CPU tensors become numpy arrays first); the
trainer turns them into CPU tensors and `io.DataLoader` moves them to
the card.  The work spec (dataset, batch iterator, collate, init
function) crosses to the child with the standard `pickle` (the reference
uses cloudpickle, which the card's machine lacks): classes and functions
are found by module and name.  A spec that names something of the
trainer's script (`__main__`) has the worker import that script, as any
multiprocessing child does, so such a script needs the
``if __name__ == "__main__":`` guard; any other spec starts its workers
without the script (the reference strips it always).  A lambda or a
locally defined class cannot cross, and `io.DataLoader` then runs its
workers as threads, with a warning and a count.

A batch travels as one message: b"B", the pickle's length, the
protocol-5 pickle with its array buffers out of band, then each buffer,
64-byte aligned.  The trainer reads the message into one buffer and
unpickles the arrays as views into it, so a batch is copied once out of
the ring; when the DataLoader stages batches on the card that buffer is
pinned host memory (`alloc`), its arrays come out as tensor views of it,
and they go to the card without another host copy.

Resilience, as the reference: a worker that dies hard (SIGKILL, OOM,
segfault) or wedges past the loader's `timeout` is respawned up to
`max_respawns` times a slot with exponential backoff, and resumes its
slice after the batches the trainer already took; a batch whose payload
does not unpickle is skipped with a warning and counted.  The chaos
sites `loader.worker_kill`, `loader.worker_hang` and
`loader.batch_corrupt` inject those faults (`resilience.chaos`).
"""
from __future__ import annotations

import contextlib
import ctypes
import mmap
import os
import pickle
import signal
import struct
import tempfile
import threading
import time
import traceback
import warnings

import numpy as np

from . import native

_DEFAULT_RING_BYTES = 64 << 20
_ALIGN = 64
_WORKER_INFO = None


def _shm_dir(size):
    """/dev/shm when it has room for a ring of `size` bytes (a container's
    /dev/shm may hold only 64 MB), else the temporary directory."""
    try:
        st = os.statvfs("/dev/shm")
        if st.f_bavail * st.f_frsize >= 2 * size:
            return "/dev/shm"
    except OSError:
        pass
    return tempfile.gettempdir()


class WorkerInfo:
    """`io.get_worker_info()` inside a worker: its id, the number of
    workers and the dataset (an IterableDataset shards itself by it)."""

    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def get_worker_info():
    return _WORKER_INFO


class _RingBase:
    """A shared mmap and the native ring operations over it."""

    def _map(self, fd, size):
        self.mm = mmap.mmap(fd, size)
        self._buf = ctypes.c_char.from_buffer(self.mm)
        self.addr = ctypes.addressof(self._buf)

    def write(self, payload, timeout_ms=-1):
        r = native.LIB.ring_write(self.addr, payload, len(payload),
                                  timeout_ms)
        if r == -1:
            raise ValueError(
                f"batch of {len(payload)} bytes exceeds the shared ring "
                f"capacity; raise DataLoader(..., ring_bytes=)")
        if r == -2:
            raise TimeoutError("ring_write timed out (consumer stalled)")

    def close_producer(self):
        native.LIB.ring_close(self.addr)

    def next_len(self, timeout_ms):
        return native.LIB.ring_next_len(self.addr, timeout_ms)

    def read(self, n, out=None):
        """The next message (n bytes) into `out` (a 1-D uint8 numpy array
        or CPU tensor of n bytes; default a new numpy array); returns the
        filled `out`."""
        if out is None:
            out = np.empty(n, np.uint8)
        ptr = out.ctypes.data if isinstance(out, np.ndarray) \
            else out.data_ptr()
        got = native.LIB.ring_read(self.addr, ptr, n)
        if got < 0:
            raise RuntimeError(f"ring_read error {got}")
        return out[:got]

    def release(self):
        self._buf = None              # drop the export before the close
        try:
            self.mm.close()
        except BufferError:  # pragma: no cover
            pass


class _Ring(_RingBase):
    """The trainer's side: creates the backing file in /dev/shm."""

    def __init__(self, size=_DEFAULT_RING_BYTES):
        native.load()
        fd, self.path = tempfile.mkstemp(prefix="ptt_ring_",
                                         dir=_shm_dir(size))
        try:
            os.ftruncate(fd, size)
            self._map(fd, size)
        finally:
            os.close(fd)              # the mmap holds its own reference
        self.size = size
        if native.LIB.ring_init(self.addr, size) != 0:
            raise RuntimeError("ring_init failed")

    def release(self):
        super().release()
        try:
            os.unlink(self.path)
        except OSError:  # pragma: no cover
            pass


class _ChildRing(_RingBase):
    """The worker's side: maps the trainer's backing file."""

    def __init__(self, path, size):
        native.load()
        fd = os.open(path, os.O_RDWR)
        try:
            self._map(fd, size)
        finally:
            os.close(fd)


def _to_numpy_tree(obj):
    """A batch as numpy and plain Python for pickling (CPU tensors become
    numpy arrays; a worker holds no device tensor)."""
    import torch
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cpu":
            raise TypeError("a DataLoader worker made a tensor on "
                            f"{obj.device}; workers run on the CPU")
        return obj.detach().numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_tree(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    return obj


def encode_batch(batch):
    """One ring message for `batch`: b"B", the pickle's length (8 bytes),
    the protocol-5 pickle, then its out-of-band buffers, each 64-byte
    aligned and preceded by its length."""
    bufs = []
    head = pickle.dumps(batch, protocol=5, buffer_callback=bufs.append)
    parts = [b"B", struct.pack("<Q", len(head)), head]
    pos = 9 + len(head)
    for b in bufs:
        raw = b.raw()
        pad = (-(pos + 8)) % _ALIGN
        parts += [struct.pack("<Q", raw.nbytes), b"\0" * pad, raw]
        pos += 8 + pad + raw.nbytes
    return b"".join(parts)


def tensor_views(batch, buf):
    """`batch` with each contiguous numpy array that lies in the uint8
    tensor `buf` replaced by a tensor view of `buf` at its place (so it
    shares `buf`'s storage: a pinned `buf` gives pinned tensors, whose
    non-blocking copies the caching host allocator tracks)."""
    import torch
    base = buf.data_ptr()
    if isinstance(batch, np.ndarray) and batch.flags.c_contiguous and \
            base <= batch.ctypes.data <= base + buf.numel() - batch.nbytes:
        off = batch.ctypes.data - base
        dtype = torch.from_numpy(np.empty(0, batch.dtype)).dtype
        return buf[off:off + batch.nbytes].view(dtype).view(batch.shape)
    if isinstance(batch, (list, tuple)):
        return type(batch)(tensor_views(b, buf) for b in batch)
    if isinstance(batch, dict):
        return {k: tensor_views(v, buf) for k, v in batch.items()}
    return batch


def decode_batch(msg):
    """The batch of a message `encode_batch` made (`msg`: uint8 numpy);
    its arrays are views into `msg`.  Raises on a mangled message."""
    mv = memoryview(msg)
    (n,) = struct.unpack("<Q", mv[1:9])
    head = mv[9:9 + n]
    pos, bufs = 9 + n, []
    while pos < len(mv):
        (size,) = struct.unpack("<Q", mv[pos:pos + 8])
        pos += 8 + (-(pos + 8)) % _ALIGN
        if pos + size > len(mv):
            raise ValueError("batch message cut short")
        bufs.append(mv[pos:pos + size])
        pos += size
    return pickle.loads(head, buffers=bufs)


def _worker_main(ring, worker_id, num_workers, dataset, batch_iter_fn,
                 collate_fn, init_fn, start_batch=0, chaos_directives=None,
                 chaos_seed=0):
    """In the worker: produce this worker's slice of the batches.

    `start_batch`: a respawned worker drives its (deterministic) batch
    iterator from the top and ships only the batches the trainer has not
    taken.  `chaos_directives`: injected faults as batch ordinals of this
    slice (`resilience.chaos.take_loader_directives`).

    Returns True on a clean finish.  On an error it ships an E-message
    and closes the ring; if even that fails the ring stays open and the
    worker exits nonzero, so the trainer's dead-worker check fires: a
    worker never looks cleanly finished after an error."""
    global _WORKER_INFO
    _WORKER_INFO = WorkerInfo(worker_id, num_workers, dataset)
    signal.signal(signal.SIGINT, signal.SIG_IGN)   # the trainer handles ^C
    cd = chaos_directives or {}
    corrupt_rng = None
    if cd.get("corrupt_p") is not None:
        import random as _random_mod
        corrupt_rng = _random_mod.Random(chaos_seed * 1000003 + worker_id)
    try:
        if init_fn is not None:
            init_fn(worker_id)
        for i, samples in enumerate(batch_iter_fn(worker_id, num_workers)):
            if i < start_batch:
                continue          # taken before the predecessor died
            ordinal = i + 1       # 1-based place in this worker's slice
            if cd.get("kill_at") == ordinal:
                os._exit(2)       # a simulated SIGKILL / OOM
            if cd.get("hang_at") == ordinal:
                while True:       # a simulated wedge
                    time.sleep(3600)
            payload = encode_batch(_to_numpy_tree(collate_fn(samples)))
            if cd.get("corrupt_at") == ordinal or (
                    corrupt_rng is not None and
                    corrupt_rng.random() < cd["corrupt_p"]):
                payload = b"B\xde\xad" + payload[::-1]
            ring.write(payload)
        ring.close_producer()
        return True
    except BaseException as e:
        for payload in (lambda: pickle.dumps((e, traceback.format_exc())),
                        lambda: pickle.dumps(
                            (None, f"{type(e).__name__} (unserializable "
                                   f"error payload)"))):
            try:
                ring.write(b"E" + payload(), timeout_ms=10_000)
                ring.close_producer()
                return False
            except Exception:
                continue
        return False


def serialize_spec(num_workers, dataset, batch_iter_fn, collate_fn,
                   worker_init_fn):
    """The work spec as a pickle; raises what pickle raises (a lambda, a
    local class), which callers that want a fallback catch first."""
    return pickle.dumps(
        (num_workers, dataset, batch_iter_fn, collate_fn, worker_init_fn),
        protocol=pickle.HIGHEST_PROTOCOL)


def _worker_entry(ring_path, ring_size, worker_id, spec_blob,
                  start_batch=0, chaos_directives=None, chaos_seed=0):
    """The forkserver child's entry point.  One intra-op thread, as
    PyTorch's own DataLoader workers run: N workers of N threads each
    would oversubscribe the host's cores."""
    import torch
    torch.set_num_threads(1)
    code = 1
    try:
        num_workers, dataset, batch_iter_fn, collate_fn, init_fn = \
            pickle.loads(spec_blob)
        ring = _ChildRing(ring_path, ring_size)
        # both sides are mapped: the name is no longer needed, and a hard
        # death of the trainer then leaks no file
        try:
            os.unlink(ring_path)
        except OSError:
            pass
        ok = _worker_main(ring, worker_id, num_workers, dataset,
                          batch_iter_fn, collate_fn, init_fn,
                          start_batch=start_batch,
                          chaos_directives=chaos_directives,
                          chaos_seed=chaos_seed)
        code = 0 if ok else 1
    finally:
        os._exit(code)            # no atexit / GC teardown in the child


_PATCH_LOCK = threading.RLock()
_PATCH_DEPTH = 0
_PATCH_ORIG = None


@contextlib.contextmanager
def _no_main_reimport():
    """Strip the `__main__` fixup from multiprocessing's preparation data
    while workers start (as the reference does), so a worker does not run
    the trainer's script again: an unguarded script would train twice,
    and a REPL or stdin parent has no script.  Used when the work spec
    holds nothing of `__main__`.  Refcounted under a lock, so nested or
    concurrent pools restore the original once."""
    global _PATCH_DEPTH, _PATCH_ORIG
    from multiprocessing import spawn as mp_spawn
    with _PATCH_LOCK:
        if _PATCH_DEPTH == 0:
            _PATCH_ORIG = mp_spawn.get_preparation_data

            def stripped(name, _orig=_PATCH_ORIG):
                d = _orig(name)
                d.pop("init_main_from_name", None)
                d.pop("init_main_from_path", None)
                return d

            mp_spawn.get_preparation_data = stripped
        _PATCH_DEPTH += 1
        try:
            yield
        finally:
            _PATCH_DEPTH -= 1
            if _PATCH_DEPTH == 0:
                mp_spawn.get_preparation_data = _PATCH_ORIG
                _PATCH_ORIG = None


def _mp_context():
    import multiprocessing as mp
    ctx = mp.get_context("forkserver")
    # the server imports torch and numpy once; every worker forks from it
    ctx.set_forkserver_preload(["paddle_tpu_torch.io.shm_loader"])
    return ctx


class ShmWorkerPool:
    """Start N forkserver workers and read their rings round robin, in
    batch order.

    A worker that dies hard or wedges past `timeout_s` is respawned up
    to `max_respawns` times a slot (PT_LOADER_MAX_RESPAWNS overrides)
    with exponential backoff, resuming after the batches already taken;
    a batch that does not unpickle is skipped and counted."""

    _POLL_MS = 100   # bounded ring polls, so a dead worker is noticed

    def __init__(self, num_workers, dataset, batch_iter_fn, collate_fn,
                 worker_init_fn=None, ring_bytes=_DEFAULT_RING_BYTES,
                 timeout_s=0, spec_blob=None, max_respawns=2,
                 respawn_backoff=None, alloc=None):
        if spec_blob is None:
            spec_blob = serialize_spec(num_workers, dataset, batch_iter_fn,
                                       collate_fn, worker_init_fn)
        self._spec_blob = spec_blob
        self._ctx = _mp_context()
        self._ring_bytes = ring_bytes
        self._timeout_ms = int(timeout_s * 1000) if timeout_s else -1
        self.max_respawns = int(os.environ.get(
            "PT_LOADER_MAX_RESPAWNS", str(max_respawns)))
        if respawn_backoff is None:
            from ..resilience.backoff import Backoff
            respawn_backoff = Backoff(base=0.2, max_delay=10.0)
        self._backoff = respawn_backoff
        self._rings = []
        self._procs = []
        self._consumed = [0] * num_workers   # batches read a slot
        self._respawns = [0] * num_workers
        self.skipped = 0
        # alloc(n): the buffer a message of n bytes is read into, a uint8
        # tensor (the batch's arrays then come out as views of it) or None
        # for a numpy array
        self._alloc = alloc
        try:
            for _ in range(num_workers):
                self._rings.append(_Ring(ring_bytes))
            for w in range(num_workers):
                self._procs.append(self._spawn(w, self._rings[w]))
        except BaseException:
            self.shutdown()
            raise

    def _spawn(self, slot, ring, start_batch=0):
        # loader faults resolve against the TRAINER's plan at spawn time
        from ..resilience import chaos as _chaos
        plan = _chaos.active()
        directives = _chaos.take_loader_directives(slot) \
            if plan is not None else None
        p = self._ctx.Process(
            target=_worker_entry,
            args=(ring.path, ring.size, slot, self._spec_blob,
                  start_batch, directives,
                  plan.seed if plan is not None else 0),
            daemon=True)
        # a spec that names something of the trainer's script needs the
        # worker to import it (the script then needs the __main__ guard)
        with contextlib.nullcontext() if b"__main__" in self._spec_blob \
                else _no_main_reimport():
            p.start()
        return p

    def _worker_dead(self, slot):
        return not self._procs[slot].is_alive()

    def _respawn(self, slot, reason):
        """A fresh ring and process for a dead or wedged worker, resuming
        after the batches already taken; False once the slot's budget is
        spent."""
        if self._respawns[slot] >= self.max_respawns:
            return False
        attempt = self._respawns[slot]
        self._respawns[slot] += 1
        from .. import observability as _obs
        _obs.metrics.registry().counter(
            "loader_worker_respawns_total").inc()
        warnings.warn(
            f"DataLoader worker {slot} {reason}; respawning "
            f"({self._respawns[slot]}/{self.max_respawns}, backoff "
            f"{self._backoff.delay(attempt):.2f}s)", RuntimeWarning)
        proc = self._procs[slot]
        if proc.is_alive():
            proc.kill()
        proc.join()
        self._rings[slot].release()
        self._backoff.wait(attempt)
        ring = _Ring(self._ring_bytes)
        self._rings[slot] = ring
        self._procs[slot] = self._spawn(slot, ring,
                                        start_batch=self._consumed[slot])
        return True

    def __iter__(self):
        from .. import observability as _obs
        depth_gauge = wait_hist = None
        reg = _obs.metrics.registry()
        skip_ctr = reg.counter("loader_batches_skipped_total")
        if _obs.enabled():
            depth_gauge = reg.gauge("loader_queue_depth")
            wait_hist = reg.histogram("loader_batch_wait_seconds")
        live = list(range(len(self._rings)))   # slots: a respawn swaps
        w = 0                                  # the ring
        waited_ms = 0
        wait_t0 = time.perf_counter()
        try:
            while live:
                slot = live[w % len(live)]
                ring = self._rings[slot]
                n = ring.next_len(self._POLL_MS)
                if n == -2:      # nothing yet: liveness and the timeout
                    if self._worker_dead(slot) and \
                            ring.next_len(0) == -2:
                        if not self._respawn(slot, "died unexpectedly "
                                             "(killed / OOM?)"):
                            raise RuntimeError(
                                "DataLoader worker process died "
                                "unexpectedly (killed / OOM?); respawn "
                                f"budget ({self.max_respawns}) exhausted")
                        waited_ms = 0
                        continue
                    waited_ms += self._POLL_MS
                    if 0 <= self._timeout_ms < waited_ms:
                        if not self._respawn(slot, "timed out (wedged?)"):
                            raise TimeoutError(
                                "DataLoader worker timed out; respawn "
                                f"budget ({self.max_respawns}) exhausted")
                        waited_ms = 0
                    continue
                waited_ms = 0
                if n == -1:      # this worker is done
                    live.remove(slot)
                    continue
                buf = None if self._alloc is None else self._alloc(n)
                msg = ring.read(n, buf)
                if buf is not None:
                    msg = msg.numpy()
                if msg[:1].tobytes() == b"E":
                    exc, tb = pickle.loads(msg[1:].tobytes())
                    if exc is not None:   # re-raise with its own type
                        raise exc from RuntimeError(
                            "DataLoader worker failed:\n" + tb)
                    raise RuntimeError("DataLoader worker failed:\n" + tb)
                self._consumed[slot] += 1
                try:
                    batch = decode_batch(msg)
                    if buf is not None:
                        batch = tensor_views(batch, buf)
                except Exception as e:
                    # a mangled payload: losing one batch is recoverable,
                    # ending the run is not; skip, count, keep the order
                    self.skipped += 1
                    skip_ctr.inc()
                    warnings.warn(
                        f"DataLoader worker {slot}: corrupt batch payload "
                        f"({type(e).__name__}: {e}); batch skipped",
                        RuntimeWarning)
                    w += 1
                    wait_t0 = time.perf_counter()
                    continue
                if wait_hist is not None:
                    # from asking for this batch until it was read, and
                    # how many workers have one ready (0: starved)
                    wait_hist.observe(time.perf_counter() - wait_t0)
                    depth_gauge.set(sum(1 for s in live
                                        if self._rings[s].next_len(0) >= 0))
                yield batch
                w += 1
                wait_t0 = time.perf_counter()
        finally:
            self.shutdown()

    def shutdown(self):
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join()
        self._procs = []
        for r in self._rings:
            r.release()
        self._rings = []
