"""Deferred parameter initialisation: `LazyGuard` (counterpart:
`paddle_tpu/framework/lazy.py:44-130`).

``with LazyGuard(): model = Net()`` builds the model's parameters and
buffers on the `meta` device: no memory on the card, no initialiser
run.  When the outermost guard exits, every deferred tensor gets real
storage on the device it was asked for, and the construction's calls on
those tensors run again in their order, on the real tensors, drawing
from the same generators.  So ``seed(k); with LazyGuard(): M()`` gives
the same parameters as ``seed(k); M()``, bit for bit, and leaves the
generators in the same state, provided nothing else draws inside the
guard.  A deep copy of a deferred parameter takes its source's values
at the copy's place in that order (`defer_alias`).

How: while a guard is open a `TorchFunctionMode` sees every torch call.
A factory call (`torch.empty`, `zeros`, `tensor`, `randn`, ...) with an
explicit non-meta `device` runs on `meta` instead, and its device is
kept for the tensor's storage.  A call that takes a deferred tensor is
recorded: an in-place call (`normal_`, `fill_`, `copy_`, the
`nn.init` functions, `__setitem__`) is not run; an out-of-place one runs
on `meta` for its shape, and its result is deferred too.  The models of
the port draw their weights with direct torch calls on explicit
generators (`text/bert.py:64-77`, `text/gpt.py`'s `reset_parameters`),
not only through `Layer.create_parameter`; the mode sees those calls
the same way.  A deferred tensor answers `.device` with its real device.
Reading a value (`.item()`, `.tolist()`) before materialisation raises,
as the reference's placeholders do.  Materialisation swaps each
deferred Python tensor object for a real one (`torch.utils.swap_tensors`),
so modules, tied weights and any other holder keep the same objects.

If construction raises, the pending work is dropped, as in the
reference, and the half-built tensors stay on `meta`.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

_FACTORIES = {
    torch.empty, torch.zeros, torch.ones, torch.full, torch.rand,
    torch.randn, torch.randint, torch.randperm, torch.arange,
    torch.linspace, torch.logspace, torch.eye, torch.tensor,
    torch.as_tensor, torch.empty_strided, torch.normal, torch.zeros_like,
    torch.ones_like, torch.empty_like, torch.full_like, torch.rand_like,
    torch.randn_like, torch.randint_like}
_EMPTY = {torch.empty, torch.empty_like, torch.empty_strided}
# in-place calls that change a tensor's shape cannot be replayed onto the
# final shape; metadata-only ones run at once
_RESHAPING = {"resize_", "resize_as_", "as_strided_", "squeeze_",
              "unsqueeze_", "transpose_", "t_", "swapdims_", "swapaxes_",
              "set_"}
_METADATA = {"requires_grad_", "share_memory_", "retain_grad"}
_INPLACE_DUNDER = {"__setitem__", "__iadd__", "__isub__", "__imul__",
                   "__itruediv__", "__ior__", "__iand__"}

_STATE = {"depth": 0, "mode": None, "new": None}


class _Pending:
    """What one outermost guard recorded: the storages it deferred (key ->
    [real device, bytes]), every Python tensor object over them (id ->
    (object, key)) and the calls to replay, in order."""

    def __init__(self):
        self.storages = {}
        self.objects = {}
        self.tape = []

    @staticmethod
    def key(t):
        return t.untyped_storage()._cdata

    def device_of(self, t):
        if not isinstance(t, torch.Tensor) or not t.is_meta:
            return None
        entry = self.storages.get(self.key(t))
        return None if entry is None else entry[0]

    def track(self, t):
        self.objects[id(t)] = (t, self.key(t))

    def register(self, t, device):
        self.storages[self.key(t)] = [device, t.untyped_storage().nbytes()]
        self.track(t)


_pending = _Pending()


def active() -> bool:
    """True while inside at least one LazyGuard."""
    return _STATE["depth"] > 0


def _real_device(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _moved_to(name, args, kwargs):
    """The device an out-of-place call puts its result on when it names
    one (`device=`, `.to(device)`, `.cuda()`, `.cpu()`), else None."""
    if kwargs.get("device") is not None:
        return _real_device(kwargs["device"])
    if name == "to":
        for a in args[1:]:
            if isinstance(a, (str, torch.device)):
                return _real_device(a)
    if name == "cuda":
        return _real_device(torch.device("cuda", *args[1:2]))
    if name == "cpu":
        return torch.device("cpu")
    return None


def _target(name, args, kwargs):
    """The tensor an in-place call writes (what it returns)."""
    if "out" in kwargs:
        return kwargs["out"]
    if "tensor" in kwargs:
        return kwargs["tensor"]
    return args[0] if args else None


class _DeferMode(TorchFunctionMode):

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        p = _pending
        if func in _FACTORIES and kwargs.get("device") is not None:
            device = torch.device(kwargs["device"])
            if device.type != "meta" and not any(
                    p.device_of(a) for a in tree_flatten(args)[0]):
                kw = dict(kwargs, device="meta")
                kw.pop("generator", None)
                kw.pop("pin_memory", None)
                out = func(*args, **kw)
                p.register(out, _real_device(device))
                if func not in _EMPTY:
                    p.tape.append(("out", func, args, kwargs, [out]))
                return out
        flat = tree_flatten((args, kwargs))[0]
        devices = [d for d in map(p.device_of, flat) if d is not None]
        if not devices:
            return func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        if name == "__get__":
            attr = getattr(getattr(func, "__self__", None), "__name__", "")
            if attr == "device":
                return devices[0]
            if attr == "is_cuda":
                return devices[0].type == "cuda"
            if attr == "is_meta":
                return False
        if name in _RESHAPING:
            raise RuntimeError(
                f"LazyGuard: {name} on a deferred tensor changes its shape "
                "and cannot be replayed; build the tensor in its shape")
        if name in _METADATA:
            return func(*args, **kwargs)
        if "out" in kwargs or name in _INPLACE_DUNDER or (
                name.endswith("_") and not name.startswith("__")):
            p.tape.append(("inplace", func, args, kwargs))
            return None if name == "__setitem__" else \
                _target(name, args, kwargs)
        if name == "__deepcopy__":            # a clone, without the memo
            func, args, kwargs = torch.Tensor.clone, args[:1], {}
        # on meta: no generator, and a move to a device is a move to meta
        meta_args = args
        kw = {k: v for k, v in kwargs.items() if k != "generator"}
        moved = _moved_to(name, args, kwargs)
        if moved is not None:
            kw.pop("device", None)
            if name == "to":
                meta_args = (args[0], "meta") + tuple(
                    a for a in args[1:]
                    if not isinstance(a, (str, torch.device)))
            elif name in ("cuda", "cpu"):
                meta_args = (args[0],)
        out = func(*meta_args, **kw) if name not in ("cuda", "cpu") \
            else args[0]
        dev = moved or devices[0]
        if moved is not None and moved != devices[0] and \
                isinstance(out, torch.Tensor) and \
                p.key(out) == p.key(args[0]):
            out = out.clone()            # a move copies
        outs, new = [], False
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_meta:
                if p.key(t) in p.storages:       # a view of a deferred one
                    p.track(t)
                    outs.append(None)
                else:
                    p.register(t, dev)
                    outs.append(t)
                    new = True
        if new:
            p.tape.append(("out", func, args, kwargs, outs))
        return out


def _track_parameters(orig):
    def new(cls, data=None, requires_grad=True):
        param = orig(cls, data, requires_grad)
        with torch._C.DisableTorchFunction():     # the mode's answers off
            if _pending.device_of(data) is not None:
                _pending.track(param)
        return param
    return staticmethod(new)


def _start():
    _STATE["new"] = nn.Parameter.__dict__["__new__"]
    nn.Parameter.__new__ = _track_parameters(_STATE["new"].__func__)
    _STATE["mode"] = _DeferMode()
    _STATE["mode"].__enter__()


def _stop():
    global _pending
    _STATE["mode"].__exit__(None, None, None)
    nn.Parameter.__new__ = _STATE["new"]
    _STATE["mode"] = _STATE["new"] = None
    pending, _pending = _pending, _Pending()
    return pending


def defer(tensor, shape, dtype, init_fn):
    """Defer `init_fn(tensor)` to the guard's exit: `tensor` becomes a
    `meta` tensor of `shape` and `dtype` (readable, not computable) and
    gets real storage on its present device when the guard exits."""
    device = _real_device(tensor.device)
    torch.utils.swap_tensors(tensor, torch.empty(
        [int(s) for s in shape], dtype=dtype, device="meta"))
    _pending.register(tensor, device)
    _pending.tape.append(("call", init_fn, (tensor,), {}))
    return tensor


def defer_alias(copy_tensor, src_tensor):
    """Record that `copy_tensor` takes `src_tensor`'s values at this point
    of the construction (a deep copy of a deferred parameter)."""
    _pending.tape.append(("inplace", torch.Tensor.copy_,
                          (copy_tensor, src_tensor), {}))
    return copy_tensor


def _depth(t):
    n = 0
    while t._base is not None:
        t, n = t._base, n + 1
    return n


def _copy_out(outs, res):
    for o, r in zip(outs, tree_flatten(res)[0]):
        if o is not None:
            o.copy_(r)


def materialize(pending=None, aliases=None):
    """Give every deferred tensor of `pending` (default: what the open
    guard has recorded so far) real storage on its device, then replay
    its calls in order; `aliases` adds (copy, source) pairs after them.
    Returns the number of tensor objects made real.  The replay runs
    with torch functions undispatched, so that an open guard does not
    record it again."""
    global _pending
    if pending is None:
        pending, _pending = _pending, _Pending()
    with torch.no_grad(), torch._C.DisableTorchFunction():
        return _materialize(pending, aliases)


def _materialize(pending, aliases):
    for copy_t, src_t in aliases or ():
        pending.tape.append(("inplace", torch.Tensor.copy_,
                             (copy_t, src_t), {}))
    real = {k: torch.empty(nbytes, dtype=torch.uint8,
                           device=dev).untyped_storage()
            for k, (dev, nbytes) in pending.storages.items()}
    # views first: a view holds its base (`_base`), and a tensor is only
    # swapped once nothing else holds it
    objs = sorted(pending.objects.values(), key=lambda ok: -_depth(ok[0]))
    for obj, key in objs:
        r = torch.empty(0, dtype=obj.dtype, device=real[key].device).set_(
            real[key], obj.storage_offset(), obj.size(), obj.stride())
        if isinstance(obj, nn.Parameter):
            r = type(obj)(r, requires_grad=obj.requires_grad)
            r.__dict__.update(obj.__dict__)
        elif obj.requires_grad and r.dtype.is_floating_point:
            r.requires_grad_(True)
        torch.utils.swap_tensors(obj, r)
        del r                     # frees the meta view's hold on its base
    for kind, func, args, kwargs, *outs in pending.tape:
        res = func(*args, **kwargs)
        if kind == "out":
            _copy_out(outs[0], res)
    return len(pending.objects)


class LazyGuard:
    """``with LazyGuard(): model = Net()``: deferred parameter
    initialisation.  Guards nest; materialisation happens when the
    outermost one exits cleanly."""

    def __enter__(self):
        if _STATE["depth"] == 0:
            _start()
        _STATE["depth"] += 1
        return self

    def __exit__(self, exc_type, exc, tb):
        _STATE["depth"] -= 1
        if _STATE["depth"] == 0:
            pending = _stop()
            if exc_type is None:
                materialize(pending)
        return False
