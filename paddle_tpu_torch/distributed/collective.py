"""Collectives over `torch.distributed` (NCCL on the card, gloo on the CPU).

Counterpart: `paddle_tpu/distributed/collective.py`.  The JAX package is
single-controller: its collectives lower to XLA ops inside a traced
program, and an eager call in one process is the identity.  The port
runs one process a rank, so every function here is the real
communication call on torch tensors, in place where torch's is:

  all_reduce, reduce, broadcast   in place on `tensor`
  all_gather                      fills `tensor_list` (or returns the
                                  stacked [world, ...] tensor)
  reduce_scatter                  writes `output` (or returns the shard)
  alltoall, alltoall_single       as torch's, equal splits only
  send, recv, isend, irecv        point to point (`src` / `dst` global
                                  ranks, as torch and Paddle take them)
  ppermute                        a permutation over a mesh axis: each
                                  rank sends to its `perm` target in one
                                  `batch_isend_irecv`; a rank no one
                                  sends to gets zeros (jax's rule)

`group` is None (the world), a torch ProcessGroup, a mesh axis name
("dp", "pp", "mp", "ep") or an object with an `axis_name` (the fleet's
axis groups).  Without an initialised process group, or on a group of
one rank, each call returns its input unchanged (the JAX package's
single-process behaviour), and `send` / `recv` loop through an
in-process queue.  `ReduceOp.AVG` sums and divides on every backend:
gloo has no native average.

Robustness (`:100-254`): `configure_collectives(timeout=, retries=)` or
PADDLE_TPU_COLLECTIVE_TIMEOUT / _RETRIES / _BACKOFF arm a deadline and a
retry budget for every call; an attempt runs on a daemon thread that the
caller joins with the timeout (`_run_with_deadline`), a late one is
abandoned (CollectiveTimeout), failures and timeouts are retried with
`resilience.backoff` and counted per op (`collective_timeout_total`,
`collective_retry_total`, `collective_failures_total`), with a
straggler warning naming the mesh axis.  The chaos sites
`collective.fail_once`, `collective.timeout` and `collective.hang` fire
first.  As in the JAX package, an abandoned attempt cannot be cancelled;
arm retries across processes only where a timeout means the job is torn
down anyway.

Accounting: every delivered call adds one to
`collective_calls_total{op, axis}` and its payload bytes to
`collective_bytes_total{op, axis}` in `observability.metrics`.  While
telemetry is on (`observability.enable()` installs `_TELEMETRY`), each
delivered call is also timed on the host and recorded as the JAX
package records it (`paddle_tpu/distributed/collective.py:182-220`):
`comms_calls_total{op, axis}`, `comms_bytes_total{op, axis}`, the
`comms_seconds{op}` histogram and a "comms" trace span.
"""
from __future__ import annotations

import functools
import inspect
import os
import threading
import time
import warnings

import torch
import torch.distributed as dist


class CollectiveTimeout(RuntimeError):
    """A collective passed its deadline (abandoned by the watchdog, or
    injected by chaos)."""


class CollectivePolicy:
    """Per-attempt `timeout` seconds (None: no deadline), `retries` extra
    attempts, exponential backoff between them."""

    __slots__ = ("timeout", "retries", "backoff")

    def __init__(self, timeout=None, retries=0, backoff_base=0.5,
                 backoff_factor=2.0, backoff_max=10.0, sleep=time.sleep):
        from ..resilience.backoff import Backoff
        self.timeout = None if timeout is None else float(timeout)
        self.retries = int(retries)
        self.backoff = Backoff(base=backoff_base, factor=backoff_factor,
                               max_delay=backoff_max, sleep=sleep)


_POLICY = None      # None: no deadline, no retry (the fast path)


def configure_collectives(timeout=None, retries=0, **backoff_kwargs):
    """Install the timeout / retry policy; all defaults clear it.  Returns
    the policy (None when cleared)."""
    global _POLICY
    if timeout is None and retries == 0 and not backoff_kwargs:
        _POLICY = None
    else:
        _POLICY = CollectivePolicy(timeout=timeout, retries=retries,
                                   **backoff_kwargs)
    return _POLICY


def collective_policy():
    return _POLICY


def policy_from_env():
    """The policy from PADDLE_TPU_COLLECTIVE_TIMEOUT (seconds) /
    _RETRIES / _BACKOFF (base seconds); None when neither of the first
    two is set."""
    t = os.environ.get("PADDLE_TPU_COLLECTIVE_TIMEOUT")
    r = os.environ.get("PADDLE_TPU_COLLECTIVE_RETRIES")
    if not t and not r:
        return None
    return configure_collectives(
        timeout=float(t) if t else None, retries=int(r or 0),
        backoff_base=float(os.environ.get(
            "PADDLE_TPU_COLLECTIVE_BACKOFF", "0.5")))


# the telemetry sink (`observability._CommsTelemetry`) while telemetry
# is on; None costs a call one global load and a None check
_TELEMETRY = None


def _registry():
    from ..observability import metrics
    return metrics.registry()


def _run_with_deadline(call, timeout, hang_s=0.0):
    """One attempt under a deadline: on a daemon thread joined with
    `timeout`; a thread still running then is abandoned and
    CollectiveTimeout raised (`hang_s`: chaos's stall)."""
    if timeout is None:
        if hang_s:
            time.sleep(hang_s)
        return call()
    box = {}

    def target():
        try:
            if hang_s:
                time.sleep(hang_s)
            box["ok"] = call()
        except BaseException as e:      # noqa: BLE001 — relayed
            box["err"] = e

    th = threading.Thread(target=target, daemon=True,
                          name="collective-attempt")
    th.start()
    th.join(timeout)
    if th.is_alive():
        raise CollectiveTimeout(
            f"collective exceeded the {timeout:.3g}s deadline")
    if "err" in box:
        raise box["err"]
    return box["ok"]


def _nbytes(x):
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _accounted(payload_arg):
    """Chaos, deadline, retry and accounting around one collective family
    (`:159-254`); `payload_arg` names the parameter with the payload."""
    def deco(fn):
        sig = inspect.signature(fn)
        op = fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            from ..resilience import chaos as _chaos
            bound = sig.bind(*args, **kwargs)
            axis = bound.arguments.get("axis_name") or _axis_name(
                bound.arguments.get("group"))
            pol = _POLICY
            tel = _TELEMETRY
            if pol is None and _chaos._PLAN is None:
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                _account(op, axis, bound.arguments.get(payload_arg), tel,
                         t0)
                return out
            timeout = pol.timeout if pol is not None else None
            retries = pol.retries if pol is not None else 0
            attempts = 0
            while True:
                try:
                    hang_s = 0.0
                    if _chaos._PLAN is not None:
                        if _chaos.fire("collective.fail_once", tag=op):
                            raise RuntimeError(
                                f"chaos: injected collective failure in "
                                f"{op}")
                        if _chaos.fire("collective.timeout", tag=op):
                            raise CollectiveTimeout(
                                f"chaos: injected collective timeout in "
                                f"{op}")
                        if _chaos.fire("collective.hang", tag=op):
                            if timeout:
                                hang_s = timeout * 2.0
                            else:
                                warnings.warn(
                                    f"chaos: collective.hang fired in {op} "
                                    f"but no policy timeout is armed — "
                                    f"skipping the stall (set "
                                    f"PADDLE_TPU_COLLECTIVE_TIMEOUT or "
                                    f"configure_collectives to exercise "
                                    f"the watchdog path)", RuntimeWarning)
                    t0 = time.perf_counter()
                    out = _run_with_deadline(
                        lambda: fn(*args, **kwargs), timeout, hang_s)
                    # the delivered attempt only: an abandoned one that
                    # finishes late is not counted twice
                    _account(op, axis, bound.arguments.get(payload_arg),
                             tel, t0)
                    return out
                except (CollectiveTimeout, RuntimeError) as e:
                    reg = _registry()
                    if isinstance(e, CollectiveTimeout):
                        reg.counter("collective_timeout_total", op=op).inc()
                        warnings.warn(
                            f"collective straggler: {op} on mesh axis "
                            f"{axis!r} hit its deadline ({e})",
                            RuntimeWarning)
                    else:
                        reg.counter("collective_failures_total",
                                    op=op).inc()
                    if attempts >= retries:
                        raise
                    attempts += 1
                    reg.counter("collective_retry_total", op=op).inc()
                    warnings.warn(
                        f"collective retry {attempts}/{retries}: {op} on "
                        f"mesh axis {axis!r} after: {e}", RuntimeWarning)
                    pol.backoff.wait(attempts - 1)
        return wrapper
    return deco


def _account(op, axis, payload, tel=None, t0=None):
    reg = _registry()
    nbytes = _nbytes(payload)
    reg.counter("collective_calls_total", op=op, axis=axis).inc()
    reg.counter("collective_bytes_total", op=op, axis=axis).inc(nbytes)
    if tel is not None:
        tel.record(op, nbytes, axis, t0, time.perf_counter() - t0)


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
              ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}


# ------------------------------------------------------------------ groups
def _axis_name(group):
    if group is None:
        return "world"
    if isinstance(group, str):
        return group
    return getattr(group, "axis_name", None) or "group"


def _pg(group):
    """The torch ProcessGroup for `group`, or None when there is nothing
    to talk to (no process group, or a group of one rank)."""
    if not dist.is_available() or not dist.is_initialized():
        return None
    if isinstance(group, str) or getattr(group, "axis_name", None):
        from . import mesh as mesh_mod
        pg = mesh_mod.axis_group(group if isinstance(group, str)
                                 else group.axis_name)
    else:
        pg = getattr(group, "pg", group)
        if pg is None:
            pg = dist.group.WORLD
    if pg is None or dist.get_world_size(pg) == 1:
        return None
    return pg


def _size(pg):
    return 1 if pg is None else dist.get_world_size(pg)


def _finish_avg(tensor, n):
    if tensor.is_floating_point() or tensor.is_complex():
        tensor.div_(n)
    else:
        tensor.floor_divide_(n)


# ------------------------------------------------------------- collectives
@_accounted("tensor")
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    pg = _pg(group)
    if pg is None:
        return tensor
    dist.all_reduce(tensor, op=_TORCH_OPS[op], group=pg)
    if op == ReduceOp.AVG:
        _finish_avg(tensor, _size(pg))
    return tensor


@_accounted("tensor")
def all_gather(tensor_list, tensor, group=None, sync_op=True):
    pg = _pg(group)
    if pg is None:
        parts = [tensor]
    else:
        parts = [torch.empty_like(tensor) for _ in range(_size(pg))]
        dist.all_gather(parts, tensor.contiguous(), group=pg)
    if tensor_list is None:
        return torch.stack(parts)
    tensor_list.extend(parts)
    return tensor_list


@_accounted("input_list_or_tensor")
def reduce_scatter(output, input_list_or_tensor, op=ReduceOp.SUM,
                   group=None):
    """Reduce over the group, then give rank r the r-th equal piece along
    dim 0 of the tensor (or the r-th entry of a list)."""
    pg = _pg(group)
    x = input_list_or_tensor
    n = _size(pg)
    if isinstance(x, (list, tuple)):
        x = torch.cat([t.unsqueeze(0) for t in x]) if n > 1 else x[0]
    if pg is None:
        out = x
    else:
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous(), op=_TORCH_OPS[op],
                                   group=pg)
        if isinstance(input_list_or_tensor, (list, tuple)):
            out = out[0]
        if op == ReduceOp.AVG:
            _finish_avg(out, n)
    if isinstance(output, torch.Tensor):
        output.copy_(out.reshape(output.shape))
        return output
    return out


@_accounted("tensor")
def broadcast(tensor, src=0, group=None, sync_op=True):
    pg = _pg(group)
    if pg is not None:
        dist.broadcast(tensor, src=src, group=pg)
    return tensor


@_accounted("tensor")
def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands on global rank `dst`; the others' tensors are
    scratch afterwards (torch's rule; the JAX package gives every rank
    the result)."""
    pg = _pg(group)
    if pg is None:
        return tensor
    dist.reduce(tensor, dst=dst, op=_TORCH_OPS[op], group=pg)
    if op == ReduceOp.AVG and dist.get_rank() == dst:
        _finish_avg(tensor, _size(pg))
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None):
    """Rank r of the group receives `tensor_list[r]` of global rank
    `src` into `tensor`."""
    pg = _pg(group)
    if pg is None:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    mine = dist.get_rank() == src
    dist.scatter(tensor, list(tensor_list) if mine else None, src=src,
                 group=pg)
    return tensor


@_accounted("in_tensor_list")
def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Rank i sends `in_tensor_list[j]` to rank j."""
    pg = _pg(group)
    ins = [t.contiguous() for t in in_tensor_list]
    if pg is None:
        outs = ins
    else:
        outs = [torch.empty_like(t) for t in ins]
        dist.all_to_all(outs, ins, group=pg)
    if out_tensor_list is None:
        return outs
    if len(out_tensor_list):
        if len(out_tensor_list) != len(outs):
            raise ValueError(
                f"out_tensor_list has {len(out_tensor_list)} entries, "
                f"alltoall produced {len(outs)}")
        for dst, src in zip(out_tensor_list, outs):
            dst.copy_(src)
    else:
        out_tensor_list.extend(outs)
    return out_tensor_list


@_accounted("in_tensor")
def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """alltoall of one tensor split evenly along dim 0."""
    if in_split_sizes is not None or out_split_sizes is not None:
        raise NotImplementedError(
            "uneven alltoall_single splits are not supported (the JAX "
            "package's all_to_all is tiled and even); pad to equal chunks")
    pg = _pg(group)
    if pg is None:
        out = in_tensor
    else:
        out = torch.empty_like(in_tensor)
        dist.all_to_all_single(out, in_tensor.contiguous(), group=pg)
    if isinstance(out_tensor, torch.Tensor):
        out_tensor.copy_(out)
        return out_tensor
    return out


_P2P_LOOPBACK = []


@_accounted("tensor")
def send(tensor, dst=0, group=None):
    if _pg(group) is None:
        _P2P_LOOPBACK.append(tensor.clone())
        return tensor
    dist.send(tensor.contiguous(), dst=dst, group=_pg(group))
    return tensor


@_accounted("tensor")
def recv(tensor, src=0, group=None):
    if _pg(group) is None:
        if not _P2P_LOOPBACK:
            raise RuntimeError(
                "recv() with no pending send in a single-process run — "
                "point to point needs a launched world or a prior send()")
        tensor.copy_(_P2P_LOOPBACK.pop(0))
        return tensor
    dist.recv(tensor, src=src, group=_pg(group))
    return tensor


def isend(tensor, dst=0, group=None):
    """Asynchronous send: the torch Work to wait on (None in a
    single-process run, where the send is queued at once)."""
    pg = _pg(group)
    if pg is None:
        send(tensor, dst=dst, group=group)
        return None
    _account("isend", _axis_name(group), tensor)
    return dist.isend(tensor.contiguous(), dst=dst, group=pg)


def irecv(tensor, src=0, group=None):
    pg = _pg(group)
    if pg is None:
        recv(tensor, src=src, group=group)
        return None
    _account("irecv", _axis_name(group), tensor)
    return dist.irecv(tensor, src=src, group=pg)


@_accounted("x")
def ppermute(x, axis_name, perm):
    """Collective permute over the mesh axis `axis_name`: `perm` is a list
    of (source, destination) pairs of axis-local ranks.  Returns a new
    tensor: what this rank's source sent, zeros where none did."""
    pg = _pg(axis_name)
    if pg is None:
        return x.clone() if any(s == d for s, d in perm) else \
            torch.zeros_like(x)
    me = dist.get_rank(pg)
    out = torch.zeros_like(x)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  dist.get_global_rank(pg, d), group=pg))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(pg, s), group=pg))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


def barrier(group=None):
    pg = _pg(group)
    if pg is not None:
        dist.barrier(group=pg)


def stream_synchronize():
    """Wait for the current device's queued work (collectives included)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------- object helpers
def all_gather_object(object_list, obj, group=None):
    pg = _pg(group)
    if pg is None:
        from . import get_world_size
        object_list.extend([obj] * max(1, get_world_size()))
        return
    out = [None] * _size(pg)
    dist.all_gather_object(out, obj, group=pg)
    object_list.extend(out)


def broadcast_object_list(object_list, src=0, group=None):
    pg = _pg(group)
    if pg is not None:
        dist.broadcast_object_list(object_list, src=src, group=pg)
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Rank r appends `in_object_list[r]` of global rank `src`."""
    pg = _pg(group)
    if pg is None:
        from . import get_rank
        rank = get_rank()
        out_object_list.append(
            in_object_list[rank if rank < len(in_object_list) else 0])
        return
    box = [None]
    dist.scatter_object_list(
        box, list(in_object_list) if dist.get_rank() == src else None,
        src=src, group=pg)
    out_object_list.append(box[0])


class _Group:
    """A group of global ranks (`get_group`)."""

    def __init__(self, ranks, gid=0, pg=None):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.id = gid
        self.pg = pg

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1


def get_group(gid=0):
    from . import get_world_size
    return _Group(range(get_world_size()), gid)


def destroy_process_group(group=None):
    """Tear the process group down (the world when `group` is None) and
    forget the mesh built over it."""
    if not dist.is_available() or not dist.is_initialized():
        return None
    if group is None:
        from . import mesh as mesh_mod
        mesh_mod.clear_mesh()
        dist.destroy_process_group()
    else:
        dist.destroy_process_group(getattr(group, "pg", group))
    return None


def split(tensor, num_or_sections, axis=0, group=None):
    """A local split of `tensor` (the JAX package's parity helper; the
    parallel layers hold their shards themselves)."""
    if isinstance(num_or_sections, int):
        return list(torch.chunk(tensor, num_or_sections, dim=axis))
    return list(torch.split(tensor, list(num_or_sections), dim=axis))


policy_from_env()   # honour PADDLE_TPU_COLLECTIVE_* from the environment
