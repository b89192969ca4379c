"""dy2static: AST conversion of data-dependent Python control flow
(counterpart: `paddle_tpu/jit/dy2static.py`, whose AST half this module
keeps as it is).

Reference: python/paddle/jit/dy2static — the reference rewrites if/while/for
over tensor values into cond_op/while_op graph nodes.  Here the targets are
`torch.compile`'s structured control flow: `torch.cond` for `if`,
`torch._higher_order_ops.while_loop` for an unbounded `while` (forward
only, as `lax.while_loop` is in the JAX package), a masked loop of
`while_max_iters` steps that Dynamo unrolls for a bounded `while` (which
can be differentiated, as the JAX package's masked `lax.scan`), and
Dynamo's own unrolling for a `for` over a tensor's rows.

Two halves:
  * `convert_to_static(fn)` — parses the function source, rewrites every
    eligible `if` / `while` / `for` statement (and `and`/`or`/`not` inside
    their tests) into calls to the runtime converters below, and compiles
    the new AST back to a function.
  * runtime converters (`convert_if` / `convert_while` / `convert_for` /
    `convert_range` / …) — decide while Dynamo traces which path to take:
    a Python-valued predicate executes natively (loops unroll exactly like
    plain tracing), a tensor predicate maps onto the structured operator.
    Outside a trace (`enable_to_static(False)` runs the original function
    anyway) every predicate is decided in Python.

Dynamo turns an exception raised while it traces into its own error.
`jit.StaticFunction` then runs the converted code once more in Python
with the converters on their traced path (`diagnosing`): the structural
checks raise the reference's errors (`_mismatch`'s ValueError, `_Undefined`'s
NameError) as they are, and the structured operators are not called.

The transform is top-down and deliberately conservative.  A block
containing `break`/`continue` (bound to that block), nested `def`/`class`,
`global`/`nonlocal`, `del`, `yield`, or stores to attributes/subscripts is
left untouched: native Python semantics are preserved there, and a
tensor-dependent predicate in such a block surfaces Dynamo's
data-dependent branching error.  `return` inside an `if` converts only in
the every-path-returns form (if/elif/else chains where each tail
returns); early returns under a tensor predicate are a documented
limitation, mirroring the reference's
(python/paddle/jit/dy2static/transformers/return_transformer.py).
"""
from __future__ import annotations

import ast
import contextlib
import functools
import inspect
import sys
import textwrap
import time
import types

import torch
from torch.utils import _pytree as pytree


# ===================================================================
# runtime
# ===================================================================
class _Undefined:
    """Placeholder for a name not yet bound when a converted block runs.
    Any meaningful use raises, restoring (approximate) NameError
    semantics; the generated cleanup `if x is _jst.UNDEF: del x` restores
    the exact ones after the block."""

    _MSG = "variable is not defined on this code path (dy2static)"

    def __repr__(self):
        return "<dy2static UNDEF>"

    def _raise(self, *a, **k):
        raise NameError(self._MSG)

    def __getattr__(self, name):
        if name.startswith("_"):
            # protocol probes (inspect, copy, Dynamo) find nothing
            raise AttributeError(name)
        raise NameError(self._MSG)

    __bool__ = __iter__ = __len__ = __call__ = __index__ = _raise
    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _raise
    __getitem__ = _raise


UNDEF = _Undefined()


class RangeSpec:
    """`range()` whose bounds are traced tensors (convert_range)."""

    def __init__(self, start, stop, step):
        self.start, self.stop, self.step = start, stop, step


_DIAGNOSING = False     # set by diagnosing(): the traced path, in Python


@contextlib.contextmanager
def diagnosing():
    """Run converted code in Python as if Dynamo traced it: tensor
    predicates take the structured path, whose structural checks raise
    the reference's errors; the structured operators themselves are not
    called (each converter returns what its checks ran)."""
    global _DIAGNOSING
    old, _DIAGNOSING = _DIAGNOSING, True
    try:
        yield
    finally:
        _DIAGNOSING = old


def _is_traced(x):
    return isinstance(x, torch.Tensor) and (
        _DIAGNOSING or torch.compiler.is_compiling())


def _python_pred(p):
    """bool(p) when p is decidable in Python; None when p is traced."""
    if _is_traced(p):
        return None
    return bool(p)


def _is_dyn(leaf):
    return isinstance(leaf, torch.Tensor) or \
        type(leaf) in (bool, int, float, complex)


def _flatten_vals(vals):
    """Split a tuple of block-output values into dynamic leaves and a
    rebuild recipe.  Tensors and numeric Python scalars are dynamic and
    cross the structured operator as tensors; everything else (UNDEF,
    None, strings, ...) is static and must match across
    branches/iterations.  Returns (leaves, comparable_key, rebuild)."""
    flat, spec = pytree.tree_flatten(list(vals))
    leaves, rebuild, keyparts = [], [], []
    for leaf in flat:
        if _is_dyn(leaf):
            leaves.append(leaf)
            rebuild.append("dyn")
            keyparts.append("dyn")
        else:
            rebuild.append(("static", leaf))
            keyparts.append(("static", leaf))
    return leaves, (spec, keyparts), rebuild


def _same_key(a, b):
    (sa, ka), (sb, kb) = a, b
    if sa != sb or len(ka) != len(kb):
        return False
    for x, y in zip(ka, kb):
        if x == "dyn" or y == "dyn":
            if x != y:
                return False
        elif x[1] is not y[1] and not (
                type(x[1]) is type(y[1]) and x[1] == y[1]):
            return False
    return True


def _rebuild_vals(leaves, spec, rebuild):
    out, it = [], iter(leaves)
    for r in rebuild:
        out.append(next(it) if r == "dyn" else r[1])
    return tuple(pytree.tree_unflatten(out, spec))


def _device_of(*vals):
    for v in pytree.tree_leaves(list(vals)):
        if isinstance(v, torch.Tensor):
            return v.device
    return None


def _tensor(x, device, dtype=None):
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.tensor(x, device=device, dtype=dtype)


def _mismatch(names, what):
    return ValueError(
        f"dy2static: the {what} produce different structures for "
        f"output variable(s) {tuple(names)}; both paths of a "
        f"tensor-dependent control-flow block must bind the same "
        f"variables with matching shapes/dtypes (assign them before "
        f"the block)")


def _meta(leaves):
    return [(tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor)
            else type(t) for t in leaves]


def _pred_tensor(p):
    return p.to(torch.bool).reshape(())


def _run_cond(pred, true_fn, false_fn, init, names):
    """The `torch.cond` lowering: fns take init values, return value
    tuples.  Each branch runs once first, outside the operator (Dynamo
    traces it; the compiled graph drops the unused values), to find
    which outputs are tensors and to check that both branches bind the
    same structure; then the operator runs both as subgraphs."""
    t_out = true_fn(*init)
    f_out = false_fn(*init)
    t_leaves, t_key, rebuild = _flatten_vals(t_out)
    f_leaves, f_key, _ = _flatten_vals(f_out)
    if not _same_key(t_key, f_key):
        raise _mismatch(names, "branches of this `if`")
    dev = _device_of(pred, init, t_out)
    t_ts = [_tensor(x, dev) for x in t_leaves]
    f_ts = [_tensor(x, dev) for x in f_leaves]
    if _meta(t_ts) != _meta(f_ts):
        raise _mismatch(names, "branches of this `if`")
    if _DIAGNOSING:
        return _rebuild_vals(t_ts, t_key[0], rebuild)
    in_leaves, (in_spec, _), in_rebuild = _flatten_vals(init)
    dyn_in = tuple(_tensor(x, dev) for x in in_leaves)

    def wrap(fn):
        def g(*operands):
            out = fn(*_rebuild_vals(list(operands), in_spec, in_rebuild))
            # outputs are copied: the operator's subgraphs may not alias
            # their inputs, operands or tensors they close over alike
            return tuple(_tensor(v, dev).clone()
                         for v in _flatten_vals(out)[0])
        return g

    res = torch.cond(_pred_tensor(pred), wrap(true_fn), wrap(false_fn),
                     dyn_in)
    return _rebuild_vals(list(res), t_key[0], rebuild)


def convert_if(pred, true_fn, false_fn, init, names):
    pv = _python_pred(pred)
    if pv is not None:
        return (true_fn if pv else false_fn)(*init)
    return _run_cond(pred, true_fn, false_fn, init, names)


def convert_if_return(pred, true_fn, false_fn, init):
    """Both-branches-return form: branch fns return the function's return
    value; the converted statement is `return convert_if_return(...)`."""
    pv = _python_pred(pred)
    if pv is not None:
        return (true_fn if pv else false_fn)(*init)
    out = _run_cond(pred, lambda *a: (true_fn(*a),),
                    lambda *a: (false_fn(*a),), init,
                    ("<return value>",))
    return out[0]


_WHILE_MAX_ITERS = None  # set via while_bound() around a to_static call


@contextlib.contextmanager
def while_bound(n):
    """Bound traced `while` loops to n iterations, lowering them to a
    masked loop that Dynamo unrolls — which can be differentiated, unlike
    `while_loop`.  Threaded from to_static(..., while_max_iters=n)."""
    global _WHILE_MAX_ITERS
    old = _WHILE_MAX_ITERS
    _WHILE_MAX_ITERS = n
    try:
        yield
    finally:
        _WHILE_MAX_ITERS = old


def _seed_undef(init, run_body, names):
    """Replace UNDEF init slots with zeros of the structure one body
    iteration produces.  Loop temps are written before read, so the seed
    value is never observed while the loop runs; after ZERO iterations a
    seeded temp reads as zeros instead of raising NameError — the one
    documented divergence (reference dy2static requires pre-assignment
    outright)."""
    if not any(v is UNDEF for v in init):
        return init
    try:
        out = run_body(init)
    except NameError as e:
        raise NameError(
            f"dy2static: a loop body reads a variable before assigning "
            f"it and it is undefined before the loop (vars "
            f"{tuple(names)}): {e}") from None
    dev = _device_of(init, out)
    return tuple(
        pytree.tree_map(lambda x: torch.zeros_like(_tensor(x, dev))
                        if _is_dyn(x) else x, o) if v is UNDEF else v
        for v, o in zip(init, out))


def _stabilize_carry(body, leaves, names, what):
    """Fix the loop-carry dtypes by promoting the SEED to what one body
    iteration produces (int seed + float body → float carry), never the
    reverse — silently truncating the body's floats back to an int seed
    dtype would change values (or spin the loop forever).  A carry that
    still drifts after one promotion is genuinely unstable."""
    out = body(leaves)
    if len(out) != len(leaves):
        raise _mismatch(names, f"iterations of this {what}")
    promoted = tuple(a if a.dtype == o.dtype else a.to(o.dtype)
                     for a, o in zip(leaves, out))
    out2 = body(promoted)
    for o, a, n in zip(out2, promoted,
                       list(names) + ["?"] * len(promoted)):
        if o.dtype != a.dtype or tuple(o.shape) != tuple(a.shape):
            raise ValueError(
                f"dy2static: loop variable '{n}' changes "
                f"{'dtype' if o.dtype != a.dtype else 'shape'} across "
                f"iterations of this {what} "
                f"({a.dtype}{list(a.shape)} → {o.dtype}{list(o.shape)}); "
                f"tensor loops need loop-invariant shapes/dtypes")
    return promoted


def convert_while(cond_fn, body_fn, init, names):
    pv = _python_pred(cond_fn(*init))
    if pv is not None:
        vals = init
        while pv:
            vals = body_fn(*vals)
            pv = _python_pred(cond_fn(*vals))
            if pv is None:
                raise ValueError(
                    f"dy2static: this `while` condition became "
                    f"tensor-dependent mid-loop (vars {tuple(names)}); "
                    f"make the first condition evaluation tensor-"
                    f"dependent too")
        return vals

    init = _seed_undef(init, lambda i: body_fn(*i), names)
    in_leaves, (in_spec, _), in_rebuild = _flatten_vals(init)
    dev = _device_of(init, cond_fn(*init))
    in_leaves = tuple(_tensor(x, dev) for x in in_leaves)

    def cond(*carry):
        p = cond_fn(*_rebuild_vals(list(carry), in_spec, in_rebuild))
        return _pred_tensor(_tensor(p, dev))

    def body(*carry):
        out = body_fn(*_rebuild_vals(list(carry), in_spec, in_rebuild))
        leaves, _, _ = _flatten_vals(out)
        if len(leaves) != len(carry):
            raise _mismatch(names, "iterations of this `while`")
        return tuple(_tensor(x, dev, c.dtype)
                     for x, c in zip(leaves, carry))

    in_leaves = _stabilize_carry(
        lambda c: tuple(_tensor(x, dev) for x in _flatten_vals(body_fn(
            *_rebuild_vals(list(c), in_spec, in_rebuild)))[0]),
        in_leaves, names, "`while`")
    if _DIAGNOSING:
        return _rebuild_vals(list(in_leaves), in_spec, in_rebuild)
    if _WHILE_MAX_ITERS is not None:
        res = _bounded_while(cond, body, in_leaves, _WHILE_MAX_ITERS)
    else:
        from torch._higher_order_ops import while_loop
        res = while_loop(
            cond, lambda *c: tuple(
                x.clone() if any(x is o for o in c) else x
                for x in body(*c)), in_leaves)
    return _rebuild_vals(list(res), in_spec, in_rebuild)


def _bounded_while(cond, body, init, n):
    """while as n masked steps (unrolled by Dynamo; differentiable)."""
    carry = tuple(init)
    done = torch.zeros((), dtype=torch.bool, device=_device_of(init))
    for _ in range(n):
        active = torch.logical_and(torch.logical_not(done), cond(*carry))
        new = body(*carry)
        carry = tuple(torch.where(active, nw, a)
                      for a, nw in zip(carry, new))
        done = torch.logical_or(done, torch.logical_not(active))
    return carry


def convert_range(*args):
    if any(_is_traced(a) for a in args):
        dev = _device_of(args)
        vals = [_tensor(a, dev) for a in args]
        zero, one = _tensor(0, dev), _tensor(1, dev)
        if len(vals) == 1:
            return RangeSpec(zero, vals[0], one)
        if len(vals) == 2:
            return RangeSpec(vals[0], vals[1], one)
        return RangeSpec(*vals)
    return range(*(int(a) if isinstance(a, torch.Tensor) else a
                   for a in args))


def convert_for(iterable, body_fn, init, names):
    if isinstance(iterable, RangeSpec):
        return _for_range(iterable, body_fn, init, names)
    vals = init
    if isinstance(iterable, torch.Tensor):
        # a tensor's rows: a Python loop, which Dynamo unrolls
        iterable = [iterable[k] for k in range(iterable.shape[0])]
    for item in iterable:
        vals = body_fn(item, *vals)
    return vals


def _for_range(spec, body_fn, init, names):
    start, stop, step = spec.start, spec.stop, spec.step

    def cond_fn(i, *vals):
        return torch.where(step > 0, i < stop, i > stop)

    def body(i, *vals):
        out = body_fn(i, *vals)
        return (i + step,) + tuple(out)

    res = convert_while(cond_fn, body, (start,) + tuple(init),
                        ("<loop index>",) + tuple(names))
    return res[1:]


def convert_ifexp(pred, true_fn, false_fn):
    pv = _python_pred(pred)
    if pv is not None:
        return true_fn() if pv else false_fn()
    t, f = true_fn(), false_fn()
    dev = _device_of(pred, t, f)
    return torch.where(_tensor(pred, dev).to(torch.bool), _tensor(t, dev),
                       _tensor(f, dev))


def convert_bool_op(op, *operand_fns):
    """`and`/`or` inside a converted test: short-circuit + value semantics
    for Python operands, logical_and/or once a traced tensor appears."""
    acc = operand_fns[0]()
    for fn in operand_fns[1:]:
        if not _is_traced(acc):
            pv = bool(acc)
            if (op == "and" and not pv) or (op == "or" and pv):
                return acc                      # short-circuit
            acc = fn()                          # `a and b` returns b
        else:
            v = fn()
            dev = _device_of(acc, v)
            a = _tensor(acc, dev).to(torch.bool)
            b = _tensor(v, dev).to(torch.bool)
            acc = torch.logical_and(a, b) if op == "and" \
                else torch.logical_or(a, b)
    return acc


def convert_not(v):
    if _is_traced(v):
        return torch.logical_not(v.to(torch.bool))
    return not v


# ===================================================================
# AST analysis
# ===================================================================
_BLOCKERS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
             ast.Import, ast.ImportFrom, ast.Global, ast.Nonlocal,
             ast.Delete, ast.Yield, ast.YieldFrom, ast.Await,
             ast.AsyncFor, ast.AsyncWith)


class _BlockInfo(ast.NodeVisitor):
    """Scan one block body: assigned names + transformability."""

    def __init__(self):
        self.assigned = set()
        self.blocked = False        # defs/imports/del/global/...
        self.has_return = False
        self.has_loopjump = False   # break/continue bound to THIS block
        self._loop_depth = 0

    def scan(self, body):
        for stmt in body:
            self.visit(stmt)
        return self

    # --- blockers
    def generic_visit(self, node):
        if isinstance(node, _BLOCKERS):
            self.blocked = True
            return
        super().generic_visit(node)

    def visit_Return(self, node):
        self.has_return = True
        self.generic_visit(node)

    def visit_Break(self, node):
        if self._loop_depth == 0:
            self.has_loopjump = True

    def visit_Continue(self, node):
        if self._loop_depth == 0:
            self.has_loopjump = True

    # break/continue inside a nested loop belong to that loop
    def visit_While(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_For(self, node):
        self._target(node.target)
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    # --- assignments
    def _target(self, t):
        if isinstance(t, ast.Name):
            self.assigned.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._target(e)
        elif isinstance(t, ast.Starred):
            self._target(t.value)
        else:
            # store into attribute/subscript: a side effect torch.cond
            # can't capture functionally — refuse the whole block
            self.blocked = True

    def visit_Assign(self, node):
        for t in node.targets:
            self._target(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._target(node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._target(node.target)
        self.generic_visit(node)

    def visit_NamedExpr(self, node):
        self._target(node.target)
        self.generic_visit(node)

    def visit_With(self, node):
        for item in node.items:
            if item.optional_vars is not None:
                self._target(item.optional_vars)
        self.generic_visit(node)


def _all_paths_return(body):
    """True when every terminal path of `body` ends in `return <expr>`."""
    if not body:
        return False
    last = body[-1]
    if isinstance(last, ast.Return):
        return last.value is not None
    if isinstance(last, ast.If):
        return _all_paths_return(last.body) and \
            _all_paths_return(last.orelse)
    return False


# ===================================================================
# codegen helpers
# ===================================================================
def _no_args():
    return ast.arguments(posonlyargs=[], args=[], vararg=None,
                         kwonlyargs=[], kw_defaults=[], kwarg=None,
                         defaults=[])


def _params(names):
    a = _no_args()
    a.args = [ast.arg(arg=n, annotation=None) for n in names]
    return a


def _call(name, args):
    return ast.Call(
        func=ast.Attribute(value=ast.Name("_jst", ast.Load()),
                           attr=name, ctx=ast.Load()),
        args=args, keywords=[])


def _fndef(name, params, body):
    fd = ast.FunctionDef(name=name, args=params, body=body,
                         decorator_list=[], returns=None)
    fd.type_params = []
    return fd


def _load_tuple(names):
    return ast.Tuple([ast.Name(n, ast.Load()) for n in names], ast.Load())


def _preamble(outputs, uid):
    """_d2s_pre_x_N = x, per name.  Every name is bound here: a user
    function binds its block outputs to UNDEF on entry
    (`_undef_bindings`), and a generated function takes them as
    parameters.  (The JAX package reads them in try / except NameError;
    Dynamo cannot trace the read of an unbound local.)"""
    stmts, pre_names = [], []
    for o in outputs:
        pre = f"_d2s_pre_{o}_{uid}"
        pre_names.append(pre)
        stmts.append(ast.Assign([ast.Name(pre, ast.Store())],
                                ast.Name(o, ast.Load())))
    return stmts, pre_names


def _undef_bindings(fdef, names):
    """`x = _jst.UNDEF` for each of `names` that is not a parameter of
    `fdef`, to go first in its body."""
    a = fdef.args
    params = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    params |= {x.arg for x in (a.vararg, a.kwarg) if x is not None}
    return [ast.Assign([ast.Name(n, ast.Store())],
                       ast.Attribute(ast.Name("_jst", ast.Load()), "UNDEF",
                                     ast.Load()))
            for n in sorted(set(names) - params)]


def _assign_outputs(outputs, call):
    if not outputs:
        return ast.Expr(call)
    return ast.Assign(
        [ast.Tuple([ast.Name(o, ast.Store()) for o in outputs],
                   ast.Store())], call)


def _cleanup(outputs):
    """if x is _jst.UNDEF: del x — restores NameError semantics."""
    return [ast.If(
        test=ast.Compare(
            left=ast.Name(o, ast.Load()), ops=[ast.Is()],
            comparators=[ast.Attribute(ast.Name("_jst", ast.Load()),
                                       "UNDEF", ast.Load())]),
        body=[ast.Delete([ast.Name(o, ast.Del())])],
        orelse=[]) for o in outputs]


# ===================================================================
# the transformer (top-down: decide on pristine AST, then recurse into
# the generated branch/body functions)
# ===================================================================
class _Dy2StTransformer(ast.NodeTransformer):
    def __init__(self):
        self.changed = False
        self._n = 0
        self._outputs = []      # per user function: its blocks' outputs
        self._generated = 0     # depth inside generated functions

    def _block_outputs(self, outputs):
        if not self._generated and self._outputs:
            self._outputs[-1].update(outputs)

    def _visit_generated(self, *fds):
        self._generated += 1
        try:
            for fd in fds:
                self.generic_visit(fd)
        finally:
            self._generated -= 1

    def _uid(self):
        self._n += 1
        return self._n

    def visit_FunctionDef(self, node):
        # a fn using global/nonlocal writes can't have its assignments
        # moved into nested branch functions — skip the whole fn
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Global, ast.Nonlocal)):
                return node
        outer, self._generated = self._generated, 0
        self._outputs.append(set())
        try:
            self.generic_visit(node)
        finally:
            names = self._outputs.pop()
            self._generated = outer
        node.body[:0] = _undef_bindings(node, names)
        return node

    # ---------------------------------------------------------- if
    def visit_If(self, node):
        t_info = _BlockInfo().scan(node.body)
        f_info = _BlockInfo().scan(node.orelse)
        if t_info.blocked or f_info.blocked or \
                t_info.has_loopjump or f_info.has_loopjump:
            self.generic_visit(node)
            return node

        all_ret = _all_paths_return(node.body) and \
            _all_paths_return(node.orelse)
        if (t_info.has_return or f_info.has_return) and not all_ret:
            self.generic_visit(node)
            return node

        self.changed = True
        uid = self._uid()
        outputs = sorted(t_info.assigned | f_info.assigned)
        test = _TestTransformer().visit(node.test)
        self._block_outputs(outputs)
        stmts, pre_names = _preamble(outputs, uid)
        tn, fn_ = f"_d2s_true_{uid}", f"_d2s_false_{uid}"

        if all_ret:
            t_fd = _fndef(tn, _params(outputs), list(node.body))
            f_fd = _fndef(fn_, _params(outputs), list(node.orelse))
            tail = [ast.Return(_call("convert_if_return", [
                test, ast.Name(tn, ast.Load()), ast.Name(fn_, ast.Load()),
                _load_tuple(pre_names)]))]
        else:
            ret = ast.Return(_load_tuple(outputs))
            t_fd = _fndef(tn, _params(outputs), list(node.body) + [ret])
            f_fd = _fndef(fn_, _params(outputs),
                          (list(node.orelse) or [ast.Pass()]) +
                          [ast.Return(_load_tuple(outputs))])
            tail = [_assign_outputs(outputs, _call("convert_if", [
                test, ast.Name(tn, ast.Load()), ast.Name(fn_, ast.Load()),
                _load_tuple(pre_names), ast.Constant(tuple(outputs))]))]
            tail += _cleanup(outputs)
        # recurse into the branch bodies for nested control flow
        self._visit_generated(t_fd, f_fd)
        return stmts + [t_fd, f_fd] + tail

    # ---------------------------------------------------------- while
    def visit_While(self, node):
        info = _BlockInfo().scan(node.body)
        if info.blocked or info.has_loopjump or info.has_return or \
                node.orelse:
            self.generic_visit(node)
            return node
        self.changed = True
        uid = self._uid()
        outputs = sorted(info.assigned)
        test = _TestTransformer().visit(node.test)
        self._block_outputs(outputs)
        stmts, pre_names = _preamble(outputs, uid)
        cn, bn = f"_d2s_cond_{uid}", f"_d2s_body_{uid}"
        c_fd = _fndef(cn, _params(outputs), [ast.Return(test)])
        b_fd = _fndef(bn, _params(outputs),
                      list(node.body) + [ast.Return(_load_tuple(outputs))])
        self._visit_generated(b_fd)
        tail = [_assign_outputs(outputs, _call("convert_while", [
            ast.Name(cn, ast.Load()), ast.Name(bn, ast.Load()),
            _load_tuple(pre_names), ast.Constant(tuple(outputs))]))]
        return stmts + [c_fd, b_fd] + tail + _cleanup(outputs)

    # ---------------------------------------------------------- for
    def visit_For(self, node):
        info = _BlockInfo().scan(node.body)
        tgt = _BlockInfo()
        tgt._target(node.target)
        if info.blocked or tgt.blocked or info.has_loopjump or \
                info.has_return or node.orelse:
            self.generic_visit(node)
            return node
        self.changed = True
        uid = self._uid()
        outputs = sorted(info.assigned | tgt.assigned)

        it = node.iter
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "range" and not it.keywords and \
                not any(isinstance(a, ast.Starred) for a in it.args):
            it = _call("convert_range", it.args)

        self._block_outputs(outputs)
        stmts, pre_names = _preamble(outputs, uid)
        bn, item = f"_d2s_forbody_{uid}", f"_d2s_item_{uid}"
        params = _params(outputs)
        params.args.insert(0, ast.arg(arg=item, annotation=None))
        unpack = ast.Assign([node.target], ast.Name(item, ast.Load()))
        b_fd = _fndef(bn, params,
                      [unpack] + list(node.body) +
                      [ast.Return(_load_tuple(outputs))])
        self._visit_generated(b_fd)
        tail = [_assign_outputs(outputs, _call("convert_for", [
            it, ast.Name(bn, ast.Load()), _load_tuple(pre_names),
            ast.Constant(tuple(outputs))]))]
        return stmts + [b_fd] + tail + _cleanup(outputs)


    # ------------------------------------------------------- ternary
    def visit_IfExp(self, node):
        self.generic_visit(node)
        self.changed = True
        return _call("convert_ifexp", [
            node.test,
            ast.Lambda(args=_no_args(), body=node.body),
            ast.Lambda(args=_no_args(), body=node.orelse)])


class _TestTransformer(ast.NodeTransformer):
    """Inside an if/while test: and/or/not → tensor-aware converters."""

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        op = "and" if isinstance(node.op, ast.And) else "or"
        return _call("convert_bool_op", [ast.Constant(op)] + [
            ast.Lambda(args=_no_args(), body=v) for v in node.values])

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return _call("convert_not", [node.operand])
        return node


# ===================================================================
# entry
# ===================================================================
_N_CONVERTED = 0


def convert_to_static(fn):
    """Return (converted_fn, changed).  On any reason the source can't be
    transformed (no source, lambda, decorated wrapper chain, opted out via
    jit.not_to_static, no control flow) the original function comes back
    with changed=False.

    Known limitation (shared with reference dy2static, which also
    recompiles sources): the converted function resolves module globals
    through a snapshot taken at conversion time, so rebinding a bare
    module-level name afterwards (e.g. mock.patch of a helper) is not
    visible to the converted code; attribute access through a module
    object stays live."""
    raw = fn.__func__ if inspect.ismethod(fn) else fn
    if getattr(raw, "_paddle_not_to_static", False):
        return fn, False
    if getattr(raw, "__wrapped__", None) is not None:
        # decorated: recompiling the inner function would silently drop
        # the wrapper's behavior — leave the chain alone
        return fn, False
    if not inspect.isfunction(raw):
        return fn, False
    t0 = time.perf_counter()
    try:
        src = textwrap.dedent(inspect.getsource(raw))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return fn, False
    fdef = tree.body[0]
    if not isinstance(fdef, ast.FunctionDef):
        return fn, False
    fdef.decorator_list = []
    tr = _Dy2StTransformer()
    tree = tr.visit(tree)
    if not tr.changed:
        return fn, False
    ast.fix_missing_locations(tree)
    code = compile(tree, f"<dy2static:{getattr(raw, '__qualname__', '?')}>",
                   "exec")
    # the globals snapshot is a module of its own, registered under a
    # name of its own: Dynamo guards an inlined function's globals through
    # `sys.modules[globals["__name__"]]`
    global _N_CONVERTED
    _N_CONVERTED += 1
    mod_name = (f"{raw.__globals__.get('__name__', 'dy2static')}"
                f".__dy2static_{_N_CONVERTED}")
    module = types.ModuleType(mod_name)
    glb = module.__dict__
    glb.update(raw.__globals__)
    glb["__name__"] = mod_name
    glb["_jst"] = sys.modules[__name__]
    sys.modules[mod_name] = module
    # snapshot closure cells as globals (the re-compiled source has no
    # enclosing scope; late rebinding of closures is not visible)
    if raw.__closure__:
        for name, cell in zip(raw.__code__.co_freevars, raw.__closure__):
            try:
                glb[name] = cell.cell_contents
            except ValueError:  # pragma: no cover - empty cell
                pass
    exec(code, glb)
    new_fn = glb[fdef.name]
    new_fn.__defaults__ = raw.__defaults__
    new_fn.__kwdefaults__ = raw.__kwdefaults__
    functools.update_wrapper(new_fn, raw)
    from .. import observability as _obs
    if _obs.enabled():
        qn = getattr(raw, "__qualname__", "?")
        _obs.trace.add_complete(f"dy2static:{qn}", "compile", t0,
                                time.perf_counter() - t0)
        _obs.metrics.registry().counter("dy2static_conversions_total").inc()
    return new_fn, True
