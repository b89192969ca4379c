"""Static-graph capture (counterpart: `paddle_tpu/framework/static_graph.py`;
reference analog: paddle's Program/Block/Operator IR built by the static
API — python/paddle/base/framework.py Program + executor.py — where
`paddle.enable_static()` makes every op call append an OpDesc instead of
executing).

As in the JAX package, ops still EXECUTE at build time (placeholders hold
zeros, so shapes and dtypes propagate for free), and every call that
takes a graph-tracked tensor also appends a node to the current Program.
The capture is a `TorchFunctionMode` (as `framework/lazy.py` records a
LazyGuard's construction), pushed by `enable_static()` and popped by
`disable_static()`: it sees every torch call at the level the user's code
makes it (a `Linear`'s `F.linear`, a loss's `cross_entropy`, a tensor
method), which is the level of the reference's dispatched ops, where an
fx trace would see only what one function traces.  A call is recorded
when an argument is tracked (it came from `data` or from a recorded
call) or is a tensor that requires grad while grad mode is on (a
parameter: param-only chains stay differentiable to the real parameter);
an in-place call on a tracked tensor records a new version of it.
Untracked tensors an op reads (parameters, buffers, constants) are
captured by reference and read live at run time, so optimizer steps stay
visible.  A random factory call (`torch.randn`, `rand`, ...) in static
mode is marked pending and becomes a node when a recorded call uses it,
so it draws anew on every run, as `record_rng_creation` does.

`Executor.run(feed, fetch_list)` replays the recorded DAG as one
function compiled by `torch.compile` (`jit.StaticFunction`, so the
compile tracker sees it), once per feed signature (the program, its
length, the fetches, train or not, each feed's shape and dtype).  There
is no eager replay: a failed compile raises.  `optimizer.minimize(loss)`
in static mode registers the training op (`register_minimize`): each run
replays the loss and the fetches, then `loss.backward()` runs the
compiled backward and the optimizer steps eagerly, as `to_static`
training does.

Known capture boundary: anything that does not flow through a torch call
(host numpy math on `.numpy()` reads, Python scalars read with
`.item()`) is baked as a constant, and a shape read at build time from a
placeholder holds its build-time size (1 for a `None` dim).
"""
from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

_state = {"enabled": False, "main": None, "startup": None, "mode": None}
_graph_ids = itertools.count(1)

# train-only ops replayed as inference by a clone(for_test=True) program
# (reference: Program.clone rewrites op test attrs)
_TEST_REMAP = {
    torch.nn.functional.dropout: lambda x, *a, **k: x,
    torch.nn.functional.dropout1d: lambda x, *a, **k: x,
    torch.nn.functional.dropout2d: lambda x, *a, **k: x,
    torch.nn.functional.dropout3d: lambda x, *a, **k: x,
    torch.nn.functional.alpha_dropout: lambda x, *a, **k: x,
    torch.dropout: lambda x, *a, **k: x,
}
# key-less random creation: marked pending in static mode
# (record_rng_creation), materialised into the program when used
_RNG_FACTORIES = {torch.rand, torch.randn, torch.randint, torch.randperm,
                  torch.normal, torch.rand_like, torch.randn_like,
                  torch.randint_like, torch.bernoulli, torch.multinomial}
_INPLACE_DUNDER = {"__setitem__", "__iadd__", "__isub__", "__imul__",
                   "__itruediv__", "__ior__", "__iand__"}


def enabled() -> bool:
    return _state["enabled"]


# ------------------------------------------------------------------- nodes
class FeedNode:
    __slots__ = ("name", "shape", "dtype", "graph_id", "seq")

    def __init__(self, name, shape, dtype, graph_id, seq):
        self.name = name
        self.shape = shape
        self.dtype = dtype
        self.graph_id = graph_id
        self.seq = seq


class LeafNode:
    """A live tensor captured by reference: its CURRENT value is read at
    run time, so eager updates (optimizer steps, BN stats) stay visible."""
    __slots__ = ("tensor", "trainable", "graph_id", "seq")

    def __init__(self, tensor, graph_id, seq):
        self.tensor = tensor
        self.trainable = tensor.requires_grad
        self.graph_id = graph_id
        self.seq = seq


class ConstNode:
    """A non-tensor value is kept in the op's arguments; this node is the
    reference's baked array, kept for its API (a tensor argument is
    always a live `LeafNode` in the port)."""
    __slots__ = ("array", "graph_id", "seq")

    def __init__(self, array, graph_id, seq):
        self.array = array
        self.graph_id = graph_id
        self.seq = seq


class OpNode:
    """One recorded call: `fn(*args, **consts)` with each tensor argument
    a `_Ref` to its producer; `inplace` when the call mutates its first
    argument (the node's output is that argument's new value)."""
    __slots__ = ("name", "fn", "parents", "consts", "n_outs", "graph_id",
                 "seq", "args", "spec", "inplace")

    def __init__(self, name, fn, parents, consts, n_outs, graph_id, seq,
                 args=(), spec=None, inplace=False):
        self.name = name
        self.fn = fn
        self.parents = parents          # list of (node, out_index)
        self.consts = consts
        self.n_outs = n_outs
        self.graph_id = graph_id
        self.seq = seq
        self.args = args                # flat (args, kwargs) leaves
        self.spec = spec                # their pytree spec
        self.inplace = inplace


class _Ref:
    """A tensor argument of a recorded call: output `index` of `node`."""
    __slots__ = ("node", "index")

    def __init__(self, node, index):
        self.node, self.index = node, index


# ----------------------------------------------------------------- program
class Program:
    """Recorded op DAG (reference: base.framework.Program)."""

    def __init__(self, is_startup=False):
        self.ops = []
        self.feeds = {}                 # name -> FeedNode
        self._leaf_by_id = {}           # id(tensor) -> LeafNode
        self._leaf_keepalive = []
        self._train = None              # {"optimizer", "loss_ref"}
        self._is_startup = is_startup
        self._for_test = False
        # stable identity shared with clone(for_test) views; rejects
        # fetches recorded in another program, and keys the Executor's
        # cache (id() of freed objects can recycle)
        self.graph_id = next(_graph_ids)
        self._node_seq = itertools.count()

    # reference-API parity shims
    def global_block(self):
        return self

    def clone(self, for_test=False):
        """for_test=True: same graph, but WITHOUT the registered training
        op, and train-only ops (dropout) replayed as inference."""
        if not for_test:
            return self
        p = Program.__new__(Program)
        p.ops = self.ops
        p.feeds = self.feeds
        p._leaf_by_id = self._leaf_by_id
        p._leaf_keepalive = self._leaf_keepalive
        p._train = None
        p._is_startup = False
        p._for_test = True
        p.graph_id = self.graph_id
        p._node_seq = self._node_seq
        return p

    @property
    def random_seed(self):
        return 0

    def leaf_for(self, tensor):
        node = self._leaf_by_id.get(id(tensor))
        if node is None:
            node = LeafNode(tensor, self.graph_id, next(self._node_seq))
            # keep every keyed tensor alive: a freed tensor's id() can be
            # recycled by a later one
            self._leaf_keepalive.append(tensor)
            self._leaf_by_id[id(tensor)] = node
        return (node, 0)

    def add_feed(self, name, shape, dtype):
        if name in self.feeds:
            raise ValueError(f"duplicate static.data name {name!r}")
        node = FeedNode(name, shape, dtype, self.graph_id,
                        next(self._node_seq))
        self.feeds[name] = node
        return node

    def leaves(self):
        seen, t_leaves, f_leaves = set(), [], []
        for node in self._leaf_by_id.values():
            if isinstance(node, LeafNode) and id(node) not in seen:
                seen.add(id(node))
                (t_leaves if node.trainable else f_leaves).append(node)
        return t_leaves, f_leaves


def default_main_program() -> Program:
    if _state["main"] is None:
        _state["main"] = Program()
    return _state["main"]


def default_startup_program() -> Program:
    if _state["startup"] is None:
        _state["startup"] = Program(is_startup=True)
    return _state["startup"]


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev = (_state["main"], _state["startup"])
    _state["main"] = main_program
    if startup_program is not None:
        _state["startup"] = startup_program
    try:
        yield
    finally:
        _state["main"], _state["startup"] = prev


class _Capture(TorchFunctionMode):
    """Sees every torch call while static mode is on and records those
    that take a graph-tracked tensor (`record_op`)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _state["enabled"] and _state["main"] is not None:
            if func in _RNG_FACTORIES and isinstance(out, torch.Tensor):
                flat = pytree.tree_leaves((args, kwargs))
                if not any(_tracked(t) for t in flat):
                    record_rng_creation(func, args, kwargs, out)
                    return out
            record_op(getattr(func, "__name__", str(func)), func,
                      (args, kwargs), None, out)
        return out


def enable_static():
    _state["enabled"] = True
    if _state["main"] is None:
        _state["main"] = Program()
    if _state["startup"] is None:
        _state["startup"] = Program(is_startup=True)
    if _state["mode"] is None:
        mode = _Capture()
        mode.__enter__()
        _state["mode"] = mode


def disable_static():
    _state["enabled"] = False
    mode, _state["mode"] = _state["mode"], None
    if mode is not None:
        mode.__exit__(None, None, None)


@contextlib.contextmanager
def _suspended():
    """The capture mode off for a block (an Executor run, an optimizer
    step): those calls are execution, not program."""
    mode = _state["mode"]
    if mode is None:
        yield
        return
    with torch.overrides._pop_mode_temporarily():
        yield


def reset():
    _state["main"] = Program()
    _state["startup"] = Program(is_startup=True)


# ---------------------------------------------------------------- recording
def _sym_of(t, prog):
    sym = getattr(t, "_sym", None)
    # a _sym from another program (stale after reset, or cross-program
    # reuse) must not splice that graph in here
    if sym is not None and sym[0].graph_id != prog.graph_id:
        return None
    return sym


def _tracked(t):
    return isinstance(t, torch.Tensor) and (
        getattr(t, "_sym", None) is not None
        or getattr(t, "_pending_creation", None) is not None)


def record_op(name, fn, tensor_args, consts, result):
    """Append an OpNode for `fn` called on `tensor_args` (the call's
    (args, kwargs)) when an input is graph-tracked or a tensor that
    requires grad under grad mode; `consts` is unused (the reference's
    keyword constants ride in the arguments)."""
    prog = _state["main"]
    if prog is None:
        return
    flat, spec = pytree.tree_flatten(tensor_args)
    tensors = [t for t in flat if isinstance(t, torch.Tensor)]
    grad_on = torch.is_grad_enabled()
    if not any((_sym_of(t, prog) is not None
                or getattr(t, "_pending_creation", None) is not None)
               or (grad_on and t.requires_grad) for t in tensors):
        return
    inplace = name in _INPLACE_DUNDER or (
        name.endswith("_") and not name.endswith("__"))
    outs = result if isinstance(result, (tuple, list)) else (result,)
    if not inplace and not any(isinstance(o, torch.Tensor) for o in outs):
        return
    if inplace and not (flat and _tracked(flat[0])):
        return      # in-place on untracked state (an init): not program
    args, parents = [], []
    for a in flat:
        if isinstance(a, torch.Tensor):
            sym = _sym_of(a, prog)
            if sym is None and \
                    getattr(a, "_pending_creation", None) is not None:
                sym = _materialize_creation(prog, a)
            if sym is None:
                sym = prog.leaf_for(a)
            parents.append(sym)
            args.append(_Ref(*sym))
        else:
            args.append(a)
    node = OpNode(name, fn, parents, {}, 1 if inplace else len(outs),
                  prog.graph_id, next(prog._node_seq), tuple(args), spec,
                  inplace)
    prog.ops.append(node)
    if inplace:
        flat[0]._sym = (node, 0)
        return
    for i, o in enumerate(outs):
        if isinstance(o, torch.Tensor):
            o._sym = (node, i)


def data(name, shape, dtype="float32", lod_level=0):
    """Create a feed placeholder (reference: paddle.static.data).  Returns
    a tensor of zeros (None or negative dims -> 1), on the card unless
    the CPU is the current device, so shapes and dtypes propagate at
    build; Executor.run substitutes the fed value."""
    if not _state["enabled"]:
        raise RuntimeError("static.data requires paddle.enable_static()")
    from ..device import resolve_device
    from ..dtypes import convert_dtype
    node = default_main_program().add_feed(name, tuple(shape), dtype)
    concrete = [1 if (d is None or int(d) < 0) else int(d) for d in shape]
    with _suspended():
        t = torch.zeros(concrete, dtype=convert_dtype(dtype),
                        device=resolve_device(None))
    t._sym = (node, 0)
    return t


# --------------------------------------------------------------- evaluation
def _live_order(refs):
    """The OpNodes `refs` depend on, in recording order."""
    seen, stack = set(), [r[0] for r in refs]
    nodes = []
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, OpNode):
            nodes.append(node)
            stack.extend(p[0] for p in node.parents)
    return sorted(nodes, key=lambda n: n.seq)


def _build_forward(refs, for_test=False):
    """The replay of graph `refs`: forward(leaves, feeds) -> list of the
    refs' values, `leaves` the live tensors by LeafNode seq, `feeds` the fed
    tensors by name.  Straight-line Python over the recorded calls, which
    Dynamo traces into one graph."""
    steps = []
    for node in _live_order(refs):
        fn = _TEST_REMAP.get(node.fn, node.fn) if for_test else node.fn
        steps.append((node, fn))

    def value(a, env, leaves, feeds):
        if not isinstance(a, _Ref):
            return a
        node = a.node
        if isinstance(node, OpNode):
            return env[node.seq][a.index]
        if isinstance(node, FeedNode):
            return feeds[node.name]
        return leaves[node.seq]

    def forward(leaves, feeds):
        env = {}
        for node, fn in steps:
            flat = [value(a, env, leaves, feeds) for a in node.args]
            args, kwargs = pytree.tree_unflatten(flat, node.spec)
            out = fn(*args, **kwargs)
            if node.inplace:
                out = flat[0]
            env[node.seq] = out if isinstance(out, (tuple, list)) \
                else (out,)
        return [value(_Ref(n, i), env, leaves, feeds) for n, i in refs]

    return forward


def _leaf_nodes(refs):
    leaves = {}
    for node in _live_order(refs):
        for p, _ in node.parents:
            if isinstance(p, LeafNode):
                leaves[id(p)] = p
    return list(leaves.values())


class Executor:
    """Runs a recorded Program as one compiled call (reference:
    paddle.static.Executor over the C++ StandaloneExecutor)."""

    def __init__(self, place=None):
        self.place = place
        self._cache = {}

    def close(self):
        self._cache.clear()

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True):
        prog = program if program is not None else default_main_program()
        if getattr(prog, "_loaded_call", None) is not None:
            with _suspended():
                return prog._loaded_call(feed or {}, fetch_list,
                                         return_numpy)
        if prog._is_startup:
            return []   # parameters are initialized eagerly at build
        feed = feed or {}
        refs = []
        for t in list(fetch_list or []):
            sym = getattr(t, "_sym", None)
            if (sym is None or sym[0].graph_id != prog.graph_id) and \
                    getattr(t, "_pending_creation", None) is not None:
                # a random creation never used by a recorded op:
                # materialise it now so it draws anew
                sym = _materialize_creation(prog, t)
            if sym is None or sym[0].graph_id != prog.graph_id:
                raise ValueError(
                    "fetch target was not recorded in this program (it was "
                    "computed outside static mode, before a reset, or in a "
                    "different Program)")
            refs.append(sym)
        train = prog._train is not None
        all_refs = ([prog._train["loss_ref"]] if train else []) + refs
        used = {n.name for n in _feeds_of(all_refs)}
        missing = [n for n in prog.feeds if n in used and n not in feed]
        if missing:
            raise ValueError(f"feed missing placeholders: {missing}")
        with _suspended():
            device = _program_device(prog)
            feeds = {k: _as_feed(v, device) for k, v in feed.items()
                     if k in used}
            outs = self._run(prog, all_refs, feeds, train)
            if train:
                loss, outs = outs[0], outs[1:]
                opt = prog._train["optimizer"]
                loss.backward()
                opt.step()
                opt.clear_grad()
            outs = [o.detach() for o in outs]
        if return_numpy:
            return [_numpy(o) for o in outs]
        return outs

    def _run(self, prog, refs, feeds, train):
        key = (prog.graph_id, len(prog.ops), tuple(refs_id(refs)), train,
               prog._for_test,
               tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in feeds.items())))
        entry = self._cache.get(key)
        if entry is None:
            from ..jit import StaticFunction, not_to_static
            forward = _build_forward(refs, for_test=prog._for_test)
            leaf_nodes = _leaf_nodes(refs)

            @not_to_static
            def program(leaf_values, feeds):
                leaves = {n.seq: v for n, v in zip(leaf_nodes, leaf_values)}
                return forward(leaves, feeds)

            program.__qualname__ = f"Program{prog.graph_id}"
            entry = (StaticFunction(None, fn=program), leaf_nodes)
            self._cache[key] = entry
        fn, leaf_nodes = entry
        with torch.set_grad_enabled(train):
            return fn([n.tensor for n in leaf_nodes], feeds)


def _feeds_of(refs):
    out = []
    for node in _live_order(refs):
        out.extend(p for p, _ in node.parents if isinstance(p, FeedNode))
    out.extend(n for n, _ in refs if isinstance(n, FeedNode))
    return out


def _program_device(prog):
    for node in prog._leaf_by_id.values():
        return node.tensor.device
    from ..device import resolve_device
    return resolve_device(None)


def _as_feed(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


def _numpy(t):
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def refs_id(refs):
    return [(n.graph_id, n.seq, i) for n, i in refs]


def register_minimize(optimizer, loss):
    """optimizer.minimize(loss) under static mode: record ONE training op
    (each Executor.run replays the loss, runs its backward and steps the
    optimizer)."""
    prog = _state["main"]
    sym = getattr(loss, "_sym", None)
    if prog is None or sym is None:
        raise RuntimeError(
            "minimize() in static mode needs a loss recorded in the "
            "current program")
    if prog._train is not None:
        raise NotImplementedError(
            "one optimizer per static Program is supported")
    prog._train = {"optimizer": optimizer, "loss_ref": sym}


def record_rng_creation(name, fn, key, result):
    """Mark a key-less random creation (`torch.randn`, ... in static mode)
    as a PENDING creation: it becomes a node only when a recorded op uses
    it, and then draws anew on every run.  Here `name` is the torch
    factory, `fn` and `key` its call's args and kwargs (the reference's
    regenerating closure and PRNG key)."""
    if not _state["enabled"]:
        return
    result._pending_creation = (name, fn, key)


def _materialize_creation(prog, t):
    """Turn a pending creation mark into a real OpNode (first use)."""
    func, args, kwargs = t._pending_creation
    flat, spec = pytree.tree_flatten((args, kwargs))
    node = OpNode(getattr(func, "__name__", str(func)), func, [], {}, 1,
                  prog.graph_id, next(prog._node_seq), tuple(flat), spec)
    prog.ops.append(node)
    t._sym = (node, 0)
    t._pending_creation = None
    return (node, 0)

