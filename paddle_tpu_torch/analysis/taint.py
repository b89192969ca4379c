"""tracelint taint analysis of the port (counterpart:
`paddle_tpu/analysis/taint.py`): which expressions hold traced tensors?

A tiny abstract interpreter over the function AST with a three-point
lattice:

    UNTAINTED < SHAPE < TENSOR

  * TENSOR — the value may be a traced tensor (function inputs, what
    `torch.*` creation functions return, and anything computed from
    them).  Predicates on TENSOR values go through dy2static's tensor
    control-flow conversion; host conversions on them (`.item()`,
    `float()`) break Dynamo's graph.
  * SHAPE  — a host-side value derived from a tensor's *metadata*
    (`x.shape`, `x.ndim`, `x.dtype`, `x.size()`, `x.dim()`,
    `x.numel()`, `len(x)`).  Static under one trace, but branching on it
    specializes the compiled program per shape — the recompile hazard the
    runtime compile_tracker diagnoses as "shape change".
  * UNTAINTED — plain Python values, and a tensor's placement
    (`x.device`, `x.is_cuda`, `x.requires_grad`), which no shape
    changes.

Parameters seed the analysis as TENSOR except `self`/`cls`, params
annotated with scalar Python types, and params whose default is a
Python scalar/string (an `dim=-1` or `approximate=False` knob, not a
tensor input); `nn.Module.forward` is the trace path (`core`), so a
Layer's inputs are TENSOR and its sublayers' calls carry their taint.
The pass is flow-ordered and joins branches by lattice max; loop bodies
run twice so loop-carried taint reaches the test.

Every visited expression node is annotated in place with `_tl_taint`;
rules read it via `taint_of(node)` (unvisited nodes — e.g. inside
nested `def`s, which trace separately — read UNTAINTED).
"""
from __future__ import annotations

import ast

UNTAINTED, SHAPE, TENSOR = 0, 1, 2

# attribute reads that turn a TENSOR into host-side metadata
_META_ATTRS = {"shape", "ndim", "dtype", "size"}
# ... and torch's metadata methods
_META_METHODS = {"size", "dim", "ndimension", "numel", "nelement",
                 "element_size", "stride"}
# a tensor's placement: static, and no shape change alters it
_PLACEMENT_ATTRS = {"device", "is_cuda", "is_cpu", "requires_grad",
                    "layout", "is_sparse"}

# method calls that leave trace land (host sync; reported by TL001, so
# their *result* is host data, not a tensor)
_HOST_SYNC_METHODS = {"numpy", "item", "tolist"}

# torch's creation functions: inside a traced function their result is a
# traced tensor whatever their (host) arguments
_TORCH_CREATORS = {"zeros", "ones", "full", "empty", "arange", "linspace",
                   "logspace", "eye", "rand", "randn", "randint",
                   "randperm", "tensor", "as_tensor", "from_numpy",
                   "zeros_like", "ones_like", "full_like", "empty_like",
                   "rand_like", "randn_like", "randint_like"}
_TORCH_ROOTS = {"torch", "paddle", "paddle_tpu_torch"}

# builtins whose result is a plain host value regardless of arguments
_HOST_BUILTINS = {"int", "float", "bool", "complex", "str", "repr",
                  "isinstance", "issubclass", "hasattr", "callable",
                  "id", "type", "format"}

_SCALAR_ANNOTATIONS = {"int", "float", "bool", "str", "bytes"}


def _root(attr):
    """The name an Attribute chain starts from (torch.nn.functional.x ->
    torch), or None."""
    node = attr
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def taint_of(node):
    return getattr(node, "_tl_taint", UNTAINTED)


def _mark(node, t):
    node._tl_taint = t
    return t


class TaintPass:
    def __init__(self, fctx):
        self.fctx = fctx

    # ------------------------------------------------------------ run
    def run(self):
        env = {}
        fdef = self.fctx.node
        a = fdef.args
        pos = a.posonlyargs + a.args
        defaults = dict(zip([p.arg for p in pos[len(pos) -
                                               len(a.defaults):]],
                            a.defaults))
        defaults.update({p.arg: d for p, d in
                         zip(a.kwonlyargs, a.kw_defaults) if d is not None})
        seed = TENSOR if self.fctx.trace_path else UNTAINTED
        for p in pos + a.kwonlyargs:
            env[p.arg] = min(seed,
                             self._param_taint(p, defaults.get(p.arg)))
        if a.vararg:
            env[a.vararg.arg] = seed
        if a.kwarg:
            env[a.kwarg.arg] = seed
        if pos and pos[0].arg in ("self", "cls"):
            env[pos[0].arg] = UNTAINTED
        for name in self.fctx.closure_tensors | self.fctx.global_tensors:
            env.setdefault(name, TENSOR)
        self._block(fdef.body, env)
        return env

    def _param_taint(self, p, default):
        ann = p.annotation
        if isinstance(ann, ast.Name) and ann.id in _SCALAR_ANNOTATIONS:
            return UNTAINTED
        if isinstance(default, ast.Constant) and isinstance(
                default.value, (bool, int, float, str, bytes)):
            return UNTAINTED
        return TENSOR

    # ------------------------------------------------------- statements
    def _block(self, stmts, env):
        for s in stmts:
            self._stmt(s, env)

    def _stmt(self, s, env):
        if isinstance(s, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            val = s.value
            t = self._expr(val, env) if val is not None else UNTAINTED
            targets = s.targets if isinstance(s, ast.Assign) else [s.target]
            for tgt in targets:
                if isinstance(s, ast.AugAssign):
                    t = max(t, self._expr(tgt, env))
                self._bind(tgt, t, env)
        elif isinstance(s, ast.If):
            self._expr(s.test, env)
            e1, e2 = dict(env), dict(env)
            self._block(s.body, e1)
            self._block(s.orelse, e2)
            self._merge(env, e1, e2)
        elif isinstance(s, (ast.While, ast.For)):
            # two passes so loop-carried taint reaches the test/body
            for _ in range(2):
                if isinstance(s, ast.While):
                    self._expr(s.test, env)
                else:
                    it = self._expr(s.iter, env)
                    # iterating host data (incl. a python `range` built
                    # from shapes) yields host values; iterating a
                    # tensor yields tensor slices
                    self._bind(s.target,
                               TENSOR if it >= TENSOR else UNTAINTED, env)
                body_env = dict(env)
                self._block(s.body, body_env)
                self._merge(env, body_env, env)
            self._block(s.orelse, env)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                t = self._expr(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, t, env)
            self._block(s.body, env)
        elif isinstance(s, ast.Try):
            self._block(s.body, env)
            for h in s.handlers:
                he = dict(env)
                if h.name:
                    he[h.name] = UNTAINTED
                self._block(h.body, he)
                self._merge(env, he, env)
            self._block(s.orelse, env)
            self._block(s.finalbody, env)
        elif isinstance(s, ast.Return) and s.value is not None:
            self._expr(s.value, env)
        elif isinstance(s, (ast.Expr, ast.Assert)):
            if isinstance(s, ast.Assert):
                self._expr(s.test, env)
                if s.msg is not None:
                    self._expr(s.msg, env)
            else:
                self._expr(s.value, env)
        elif isinstance(s, ast.Delete):
            for t in s.targets:
                if isinstance(t, ast.Name):
                    env.pop(t.id, None)
        elif isinstance(s, ast.Raise):
            if s.exc is not None:
                self._expr(s.exc, env)
        elif hasattr(ast, "Match") and isinstance(s, ast.Match):
            subject = self._expr(s.subject, env)
            branch_envs = []
            for case in s.cases:
                ce = dict(env)
                for sub in ast.walk(case.pattern):
                    # capture patterns (MatchAs/MatchStar .name,
                    # MatchMapping .rest) bind pieces of the subject
                    for attr in ("name", "rest"):
                        n = getattr(sub, attr, None)
                        if isinstance(n, str):
                            ce[n] = subject
                if case.guard is not None:
                    self._expr(case.guard, ce)
                self._block(case.body, ce)
                branch_envs.append(ce)
            for ce in branch_envs:
                self._merge(env, ce, env)
        # nested defs/classes trace separately — leave them unannotated
        # (rules treat unvisited expressions as UNTAINTED)

    def _bind(self, tgt, t, env):
        if isinstance(tgt, ast.Name):
            env[tgt.id] = t
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._bind(e, t, env)
        elif isinstance(tgt, ast.Starred):
            self._bind(tgt.value, t, env)
        elif isinstance(tgt, (ast.Attribute, ast.Subscript)):
            self._expr(tgt.value, env)

    @staticmethod
    def _merge(env, e1, e2):
        for k in set(e1) | set(e2):
            env[k] = max(e1.get(k, UNTAINTED), e2.get(k, UNTAINTED))

    # ------------------------------------------------------ expressions
    def _expr(self, node, env):
        if node is None:
            return UNTAINTED
        if isinstance(node, ast.Name):
            return _mark(node, env.get(node.id, UNTAINTED))
        if isinstance(node, ast.Constant):
            return _mark(node, UNTAINTED)
        if isinstance(node, ast.Attribute):
            base = self._expr(node.value, env)
            if node.attr in _META_ATTRS and base >= TENSOR:
                return _mark(node, SHAPE)
            if node.attr in _PLACEMENT_ATTRS and base >= TENSOR:
                return _mark(node, UNTAINTED)
            return _mark(node, base)
        if isinstance(node, ast.Call):
            return _mark(node, self._call(node, env))
        if isinstance(node, ast.Compare):
            t = self._expr(node.left, env)
            for c in node.comparators:
                t = max(t, self._expr(c, env))
            # `x is None` / `k in d` produce host booleans at trace time
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                t = UNTAINTED
            return _mark(node, t)
        if isinstance(node, ast.BoolOp):
            return _mark(node, max(self._expr(v, env)
                                   for v in node.values))
        if isinstance(node, ast.BinOp):
            return _mark(node, max(self._expr(node.left, env),
                                   self._expr(node.right, env)))
        if isinstance(node, ast.UnaryOp):
            return _mark(node, self._expr(node.operand, env))
        if isinstance(node, ast.IfExp):
            self._expr(node.test, env)
            return _mark(node, max(self._expr(node.body, env),
                                   self._expr(node.orelse, env)))
        if isinstance(node, ast.Subscript):
            t = max(self._expr(node.value, env),
                    self._expr(node.slice, env)
                    if not isinstance(node.slice, ast.Slice) else UNTAINTED)
            if isinstance(node.slice, ast.Slice):
                for part in (node.slice.lower, node.slice.upper,
                             node.slice.step):
                    self._expr(part, env)
            return _mark(node, t)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            t = UNTAINTED
            for e in node.elts:
                t = max(t, self._expr(e, env))
            return _mark(node, t)
        if isinstance(node, ast.Dict):
            t = UNTAINTED
            for k, v in zip(node.keys, node.values):
                if k is not None:
                    t = max(t, self._expr(k, env))
                t = max(t, self._expr(v, env))
            return _mark(node, t)
        if isinstance(node, ast.Starred):
            return _mark(node, self._expr(node.value, env))
        if isinstance(node, ast.NamedExpr):
            t = self._expr(node.value, env)
            self._bind(node.target, t, env)
            return _mark(node, t)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            cenv = dict(env)
            for gen in node.generators:
                it = self._expr(gen.iter, cenv)
                self._bind(gen.target,
                           TENSOR if it >= TENSOR else UNTAINTED, cenv)
                for cond in gen.ifs:
                    self._expr(cond, cenv)
            if isinstance(node, ast.DictComp):
                t = max(self._expr(node.key, cenv),
                        self._expr(node.value, cenv))
            else:
                t = self._expr(node.elt, cenv)
            return _mark(node, t)
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self._expr(v.value, env)
            return _mark(node, UNTAINTED)
        if isinstance(node, ast.Lambda):
            return _mark(node, UNTAINTED)
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                self._expr(part, env)
            return _mark(node, UNTAINTED)
        # fallback: walk children conservatively
        t = UNTAINTED
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                t = max(t, self._expr(child, env))
        return _mark(node, t)

    def _call(self, node, env):
        arg_t = UNTAINTED
        for a in node.args:
            arg_t = max(arg_t, self._expr(a, env))
        for kw in node.keywords:
            arg_t = max(arg_t, self._expr(kw.value, env))
        f = node.func
        if isinstance(f, ast.Attribute):
            base = self._expr(f.value, env)
            if f.attr in _HOST_SYNC_METHODS:
                return UNTAINTED
            if f.attr in _META_METHODS and base >= TENSOR:
                return SHAPE
            if f.attr in _TORCH_CREATORS and \
                    _root(f) in _TORCH_ROOTS:
                return TENSOR
            if f.attr in ("astype", "reshape", "cast", "view", "to"):
                return base
            return max(base, arg_t)
        if isinstance(f, ast.Name):
            _mark(f, UNTAINTED)
            if f.id == "len":
                return SHAPE if arg_t >= TENSOR else UNTAINTED
            if f.id in _HOST_BUILTINS:
                return UNTAINTED
            if f.id == "range":
                # python range over shapes stays host-side; a tensor
                # bound becomes dy2static's RangeSpec (tensor loop)
                return TENSOR if arg_t >= TENSOR else UNTAINTED
            if f.id == "getattr":
                return self._expr(node.args[0], env) if node.args \
                    else UNTAINTED
            return arg_t
        self._expr(f, env)
        return arg_t
