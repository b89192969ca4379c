"""Automatic mixed precision: per-op casting (`auto_cast`, O1 and O2) and
low-precision parameters (`decorate`).

Counterparts: `paddle_tpu/amp/__init__.py` (`auto_cast` `:21-61`,
`decorate` `:64-98`) and the cast policy of its op dispatch
(`paddle_tpu/ops/dispatch.py:74-102`).  Inside `auto_cast` a
thread-local state holds the dtype, the level and the custom lists, and
every op of the JAX package's registry gets a policy:

* allow (cast to the AMP dtype): matmul, bmm, mm, mv, einsum, addmm,
  the convolutions, sdpa and paged_attention;
* deny (compute in float32): layer_norm, rms_norm, group_norm,
  batch_norm_train / batch_norm_infer, softmax, log_softmax, logsumexp,
  softmax_ce and bce_with_logits;
* keep: every other op.

`custom_white_list` / `custom_black_list` take those op names and move
an op to allow / deny; black wins over white (`_AmpState.policy_for`).
Under O1 an allow op casts its floating inputs to the AMP dtype, a deny
op to float32, and a keep op casts nothing; under O2 every op casts to
the AMP dtype except deny ops, which cast to float32.  A cast touches
only floating tensors of another dtype.

How the policy reaches the ops: PyTorch code calls torch functions, not
a registry, so while `auto_cast` is on a `TorchFunctionMode` maps the
torch callables to those op names (`F.linear` and `torch.matmul` to
"matmul", `F.layer_norm` to "layer_norm", `F.softmax` to "softmax", ...;
the table is `_OPS`) and casts their inputs first.  The port's own ops
read the state themselves: `ops.sdpa` ("sdpa"), `ops.paged_attention`,
`ops.rms_norm` and `nn.functional.cross_entropy` ("softmax_ce"); they
call `cast_inputs` and run their bodies under `no_cast()`, so that the
torch functions inside them are not cast again, as the JAX kernels'
inner jnp calls are not.  Where the JAX package calls a kernel outside
its dispatch, the port does the same: an `sdpa` without a mask and a
`layer_norm` without weight or bias keep their dtypes under either
level.

The dtype flow of a linear layer follows the JAX package op by op: its
`F.linear` is a `matmul` (allow) and then `+ bias` (keep), so under O1 a
float32 bias promotes the output back to float32, q / k / v reach
`sdpa` in float32, and `sdpa` casts them, and the additive mask, to the
AMP dtype (BERT's -1e4 becomes -9984 in bfloat16).  `torch.autocast`
is not used: its op lists differ between CUDA and the CPU, it has no
lists by Paddle op name, and it rounds `F.linear` with its bias in the
low dtype.

`decorate` casts every floating parameter to the target dtype in place
and turns the optimizers' float32 master weights on, whatever `level`
says, as the JAX package does (it never reads `level`).  `GradScaler`
scales the loss of float16 training (`amp/grad_scaler.py`).
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from .grad_scaler import AmpScaler, GradScaler

__all__ = ["AmpScaler", "GradScaler", "amp_guard", "amp_state",
           "auto_cast", "cast_inputs", "decorate", "no_cast"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}

_tls = threading.local()


def _dtype(d):
    return _DTYPES[d] if isinstance(d, str) else d


class _AmpState:
    __slots__ = ("dtype", "level", "white", "black")

    def __init__(self, dtype, level, white=(), black=()):
        self.dtype = dtype
        self.level = level
        self.white = frozenset(white or ())
        self.black = frozenset(black or ())

    def policy_for(self, op_name, default):
        """The custom lists move an op between allow ("white") and deny
        ("black"); black wins over white."""
        if op_name in self.black:
            return "deny"
        if op_name in self.white:
            return "allow"
        return default

    def target(self, op_name, default):
        """The dtype the floating inputs of `op_name` cast to, or None for
        none (keep under O1)."""
        policy = self.policy_for(op_name, default)
        if self.level == "O2":
            return torch.float32 if policy == "deny" else self.dtype
        if policy == "allow":
            return self.dtype
        return torch.float32 if policy == "deny" else None


def amp_state():
    """The `auto_cast` state of this thread, or None outside one (and
    inside the port's own ops, see `no_cast`)."""
    if getattr(_tls, "suspended", 0):
        return None
    return getattr(_tls, "state", None)


def _cast(x, dtype):
    if dtype is not None and isinstance(x, torch.Tensor) and \
            x.is_floating_point() and x.dtype != dtype:
        return x.to(dtype)
    if isinstance(x, (list, tuple)):
        return type(x)(_cast(v, dtype) for v in x)
    return x


def cast_inputs(op_name, default, *tensors):
    """The tensors cast as op `op_name` (default policy `default`) casts
    its inputs under the current `auto_cast` (unchanged outside one).
    The port's own ops call it on entry."""
    st = amp_state()
    if st is None:
        return tensors
    dtype = st.target(op_name, default)
    return tuple(_cast(t, dtype) for t in tensors)


@contextlib.contextmanager
def no_cast():
    """Run a port op's body without the cast of its inner torch calls."""
    _tls.suspended = getattr(_tls, "suspended", 0) + 1
    try:
        yield
    finally:
        _tls.suspended -= 1


# --------------------------------------------------- the torch callables
def _linear(st, args, kwargs, conv_dims=None, name="matmul", fn=F.linear):
    """A linear (or convolution) as the JAX package composes it: the
    product under `name`'s policy, then `+ bias` as a keep op."""
    args = list(args)
    for i, k in enumerate(("input", "weight")):
        if len(args) <= i:
            args.append(kwargs.pop(k))
    b = args.pop(2) if len(args) > 2 else kwargs.pop("bias", None)
    dt = st.target(name, "allow")
    out = fn(_cast(args[0], dt), _cast(args[1], dt), None, *args[2:],
             **kwargs)
    if b is None:
        return out
    if conv_dims is not None:
        b = b.reshape((1, -1) + (1,) * conv_dims)
    keep = st.target("add", "keep")
    return _cast(out, keep) + _cast(b, keep)


def _conv(name, dims, fn):
    return lambda st, args, kwargs: _linear(st, args, kwargs, dims, name, fn)


def _batch_norm(st, args, kwargs):
    """F.batch_norm: input, weight and bias cast; the running statistics
    are left alone (they are updated in place)."""
    names = ("input", "running_mean", "running_var", "weight", "bias",
             "training")
    a = dict(zip(names, args))
    a.update(kwargs)
    op = "batch_norm_train" if a.get("training") else "batch_norm_infer"
    dt = st.target(op, "deny")
    for k in ("input", "weight", "bias"):
        if k in a:
            a[k] = _cast(a[k], dt)
    return F.batch_norm(**a)


def _layer_norm(st, args, kwargs):
    """F.layer_norm: a deny op when it has a weight and a bias; without
    them the JAX package runs its kernel outside the dispatch, and its
    dtypes stay."""
    names = ("input", "normalized_shape", "weight", "bias", "eps")
    a = dict(zip(names, args))
    a.update(kwargs)
    if a.get("weight") is not None and a.get("bias") is not None:
        dt = st.target("layer_norm", "deny")
        for k in ("input", "weight", "bias"):
            a[k] = _cast(a[k], dt)
    return F.layer_norm(**a)


def _plain(name, default, only=None):
    """A handler that casts the floating tensor arguments (those at the
    positions / keywords `only` when given) and calls the function."""
    def handle(st, args, kwargs, func):
        dt = st.target(name, default)
        if only is None:
            args = [_cast(a, dt) for a in args]
            kwargs = {k: _cast(v, dt) for k, v in kwargs.items()}
        else:
            pos, kws = only
            args = [_cast(a, dt) if i in pos else a
                    for i, a in enumerate(args)]
            kwargs = {k: _cast(v, dt) if k in kws else v
                      for k, v in kwargs.items()}
        return func(*args, **kwargs)
    return handle


def _table():
    T = torch.Tensor
    ops = {}

    def add(funcs, handler):
        for f in funcs:
            ops[f] = handler

    add((torch.matmul, T.matmul, T.__matmul__, T.__rmatmul__),
        _plain("matmul", "allow"))
    add((torch.bmm, T.bmm), _plain("bmm", "allow"))
    add((torch.mm, T.mm), _plain("mm", "allow"))
    add((torch.mv, T.mv), _plain("mv", "allow"))
    add((torch.einsum,), _plain("einsum", "allow"))
    add((torch.addmm, T.addmm), _plain("addmm", "allow"))
    # input, weight and bias; normalized_shape / num_groups stay
    add((F.group_norm,), _plain("group_norm", "deny",
                                ({0, 2, 3}, {"input", "weight", "bias"})))
    add((F.softmax, torch.softmax, T.softmax), _plain("softmax", "deny"))
    add((F.log_softmax, torch.log_softmax, T.log_softmax),
        _plain("log_softmax", "deny"))
    add((torch.logsumexp, T.logsumexp), _plain("logsumexp", "deny"))
    add((F.cross_entropy,), _plain("softmax_ce", "deny"))
    add((F.binary_cross_entropy_with_logits,),
        _plain("bce_with_logits", "deny"))
    special = {F.linear: lambda st, a, k: _linear(st, a, k),
               F.conv1d: _conv("conv1d", 1, F.conv1d),
               F.conv2d: _conv("conv2d", 2, F.conv2d),
               F.conv3d: _conv("conv3d", 3, F.conv3d),
               F.conv_transpose2d: _conv("conv2d_transpose", 2,
                                         F.conv_transpose2d),
               F.conv_transpose3d: _conv("conv3d_transpose", 3,
                                         F.conv_transpose3d),
               F.batch_norm: _batch_norm, F.layer_norm: _layer_norm}
    return ops, special


_OPS, _SPECIAL = _table()

# Keep ops cast under O2 or when a custom list names them, but never
# these: casts and conversions (the JAX package's "cast" op is exempt
# too), metadata, and anything that writes into an existing tensor
# (in-place ops, property setters), which a cast would redirect into a
# copy.
_O2_EXEMPT = frozenset((
    "to", "float", "double", "half", "bfloat16", "int", "long", "bool",
    "type", "type_as", "cpu", "cuda", "detach", "backward", "item",
    "tolist", "numpy", "size", "dim", "numel", "stride", "data_ptr",
    "is_contiguous", "is_floating_point", "is_complex", "element_size",
    "storage_offset", "__get__", "__set__", "__delete__", "__setitem__",
    "__len__", "__bool__", "__format__", "__repr__", "__hash__",
    "__array__", "__reduce_ex__", "__deepcopy__", "__getstate__",
    "__setstate__", "empty_like", "zeros_like", "ones_like", "full_like",
    "rand_like", "randn_like", "new_empty", "new_zeros", "new_ones",
    "new_full", "new_tensor", "copy_", "set_"))


# the JAX package's names of the Tensor operators
_ALIASES = {"__add__": "add", "__radd__": "add", "__sub__": "subtract",
            "__rsub__": "subtract", "__mul__": "multiply",
            "__rmul__": "multiply", "__truediv__": "divide",
            "__rtruediv__": "divide", "__pow__": "pow", "__neg__": "neg",
            "__abs__": "abs", "__getitem__": "getitem", "mul": "multiply",
            "sub": "subtract", "div": "divide"}


def _exempt(func):
    name = getattr(func, "__name__", "")
    return (name in _O2_EXEMPT or name.endswith("_")
            and not name.startswith("__")
            or name.startswith("__i") and name.endswith("__"))


def _op_name(func):
    """The JAX op name of a torch callable outside the tables: its own
    name, or the JAX package's for a Tensor operator."""
    name = getattr(func, "__name__", "")
    return _ALIASES.get(name, name)


class _CastMode(TorchFunctionMode):
    """Casts the inputs of the torch callables of `_OPS` / `_SPECIAL`,
    and of every other op (by its name, `_op_name`) that O2 or a custom
    list casts, by the current `auto_cast` state."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        st = amp_state()
        if st is None:
            return func(*args, **kwargs)
        special = _SPECIAL.get(func)
        if special is not None:
            return special(st, args, dict(kwargs))
        handler = _OPS.get(func)
        if handler is not None:
            return handler(st, args, kwargs, func)
        # a keep op, unless a custom list names it (or the level is O2)
        dt = None if _exempt(func) else st.target(_op_name(func), "keep")
        if dt is None:
            return func(*args, **kwargs)
        return func(*[_cast(a, dt) for a in args],
                    **{k: _cast(v, dt) for k, v in kwargs.items()})


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """paddle.amp.auto_cast: ops inside the block cast their inputs by
    the policy above.  `enable=False` turns casting off inside the block
    (also inside an outer auto_cast); blocks nest, the inner state
    winning until it ends."""
    prev = getattr(_tls, "state", None)
    _tls.state = _AmpState(_dtype(dtype), level, custom_white_list,
                           custom_black_list) if enable else None
    mode = None
    if enable and not getattr(_tls, "mode_on", False):
        mode = _CastMode()
        mode.__enter__()
        _tls.mode_on = True
    try:
        yield
    finally:
        if mode is not None:
            mode.__exit__(None, None, None)
            _tls.mode_on = False
        _tls.state = prev


amp_guard = auto_cast


@torch.no_grad()
def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None):
    """Cast the floating parameters of `models` to `dtype` IN PLACE (each
    Parameter keeps its identity, so an optimizer built before keeps
    pointing at it).  `master_weight` None or True turns the optimizers'
    float32 master copies on (`:94-96`); only False leaves them off.
    `level` is taken and read by nothing, as in the JAX package.
    Returns (models, optimizers) as given (a single model, or a list), or
    models alone when `optimizers` is None."""
    target = _dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for m in model_list:
        if m is None:
            continue
        for p in m.parameters():
            if p.is_floating_point():
                p.data = p.data.to(target)
    if optimizers is None:
        return models if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    for o in opt_list:
        if o is not None and master_weight is not False:
            o._use_master_weights = True
    return (models if single else model_list,
            optimizers if opt_single else opt_list)
