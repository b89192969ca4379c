"""tracelint rule catalog of the port (counterpart:
`paddle_tpu/analysis/rules.py`): trace-safety rules for code headed into
`jit.to_static`, whose Dynamo capture plays `jax.jit`'s trace.

Severity contract (as the reference):
  * error — the capture will break (a graph break, which to_static's
    default `full_graph=True` raises on) or silently compute the wrong
    thing.
  * warn  — legal but hazardous: recompile storms, baked entropy/time,
    side effects that do not happen per step as written.
  * info  — harmless at runtime but usually not what the author meant.

The rule ids, names, severities and the anchoring of each finding are
the reference's, on the same hazards in torch spelling (`x.size(0)` as
`x.shape[0]`, `torch.zeros` as `jnp.zeros`).  Under Dynamo some hazards
change their mechanism; `DYNAMO_DIVERGENCES` names each rule that does
and what the port does about it:

  * "reworded": the rule fires where the reference's does, its message
    and hint describe what Dynamo does there: a host scalar (`.item()`,
    `float()`) or a tensor `assert` is a data-dependent value Dynamo
    keeps in the graph or breaks the graph on (depending on the torch
    version; branching on it raises), instead of a concretization error;
    a clock read, `random.*` or `print` breaks the graph (which
    to_static's `full_graph=True` raises on) instead of running once at
    trace time; `np.random.*` is traced onto torch's generator (numpy's
    seed has no effect) instead of baked; a side effect on closure state
    is replayed after every call instead of once; a default's contents
    are guarded on;
  * "silent": the rule stays registered (its id is kept) but fires on
    nothing, because Dynamo removes the hazard: TL008, a tensor captured
    from a closure or a module global, which Dynamo lifts as a graph
    input (an in-place update is seen by the next call) instead of
    baking it as a constant.

Suppress a finding with `# tracelint: disable=TLxxx` on the offending
line.

Cross-reference to the runtime half (observability/compile_tracker):
`STATIC_RULE_FOR_CAUSE` maps each recompile cause the port's tracker
diagnoses to the static rule id that catches it before the first
compile; RecompileWarning messages name it.
"""
from __future__ import annotations

import ast

from .core import Rule, register_rule
from .taint import TENSOR, SHAPE, taint_of

# the port tracker's recompile causes (compile_tracker.diagnose, and
# "guard failure" for a recompile no new signature explains: Dynamo
# guards on a global that traced code rebinds) -> static rule id
STATIC_RULE_FOR_CAUSE = {
    "shape change": "TL010",
    "shape+dtype change": "TL010",
    "new static arg": "TL009",
    "guard failure": "TL006",
}

# rules whose hazard changes under Dynamo: "reworded" or "silent" (see
# the module note); every other rule carries over as the reference's
DYNAMO_DIVERGENCES = {
    "TL001": "reworded", "TL002": "reworded", "TL003": "reworded",
    "TL004": "reworded", "TL005": "reworded", "TL006": "reworded",
    "TL008": "silent", "TL009": "reworded", "TL012": "reworded",
}

_HOST_SYNC_METHODS = ("numpy", "item", "tolist")

# dotted-call prefixes considered wall-clock / entropy sources
_TIME_CALLS = {"time.time", "time.perf_counter", "time.monotonic",
               "time.process_time", "time.time_ns", "time.sleep",
               "datetime.now", "datetime.utcnow",
               "datetime.datetime.now", "datetime.datetime.utcnow"}
_RANDOM_PREFIXES = ("random.", "np.random.", "numpy.random.")

_MUTATING_METHODS = {"append", "extend", "insert", "add", "update",
                     "pop", "popitem", "remove", "discard", "clear",
                     "setdefault", "sort", "reverse"}


def _dotted(node):
    """a.b.c for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ===================================================================
# host synchronization
# ===================================================================
@register_rule
class HostSyncCall(Rule):
    """TL001 — `.numpy()` / `.item()` / `.tolist()` on a traced tensor.

    bad:  threshold = loss.item()
    good: keep the value on the device (tensor ops), or compute it
          outside the compiled function.
    """
    id = "TL001"
    severity = "error"
    name = "host-sync-call"
    description = ("host-synchronizing method on a traced tensor "
                   "(a data-dependent scalar under Dynamo)")
    interests = (ast.Call,)

    def visit(self, node, fctx):
        f = node.func
        if isinstance(f, ast.Attribute) and \
                f.attr in _HOST_SYNC_METHODS and \
                taint_of(f.value) >= TENSOR:
            yield fctx.finding(
                self, node,
                f"'.{f.attr}()' on a traced tensor forces a host sync: "
                f"Dynamo breaks the graph here or keeps a data-dependent "
                f"scalar, which raises once a branch or a shape depends "
                f"on it (to_static's full_graph=True raises on a break)",
                hint="compute on-device, or move this out of the traced "
                     "function (jit.not_to_static)")


@register_rule
class HostSyncCast(Rule):
    """TL002 — `float()` / `int()` / `bool()` over a traced tensor.

    bad:  if bool(mask.sum()): ...
    good: use tensor ops (`torch.where`, `torch.cond` via dy2static `if`).
    """
    id = "TL002"
    severity = "error"
    name = "host-scalar-cast"
    description = "python scalar cast concretizes a traced tensor"
    interests = (ast.Call,)

    def visit(self, node, fctx):
        f = node.func
        if isinstance(f, ast.Name) and \
                f.id in ("float", "int", "bool", "complex") and \
                node.args and taint_of(node.args[0]) >= TENSOR:
            yield fctx.finding(
                self, node,
                f"'{f.id}()' on a traced tensor needs its value on the "
                f"host: Dynamo breaks the graph here or keeps a data-"
                f"dependent scalar, which raises once a branch or a "
                f"shape depends on it",
                hint="keep the value as a 0-d tensor; dy2static converts "
                     "tensor predicates to torch.cond")


# ===================================================================
# impure calls (trace-time baking)
# ===================================================================
@register_rule
class WallClockCall(Rule):
    """TL003 — wall-clock reads inside traced code.

    bad:  t0 = time.time()   # a graph break under Dynamo
    good: time outside the traced function.
    """
    id = "TL003"
    severity = "warn"
    name = "trace-time-clock"
    description = "wall-clock call inside traced code (a graph break)"
    interests = (ast.Call,)

    def visit(self, node, fctx):
        d = _dotted(node.func)
        if d in _TIME_CALLS:
            yield fctx.finding(
                self, node,
                f"'{d}()' is not traced: Dynamo breaks the graph on it "
                f"(to_static's full_graph=True raises)",
                hint="measure outside the traced function")


@register_rule
class ImpureRandom(Rule):
    """TL004 — `random.*` / `np.random.*` inside traced code.

    bad:  noise = np.random.randn(*x.shape)   # same noise every step
    good: torch random ops (torch.randn, dropout), which the compiled
          graph draws on every call.
    """
    id = "TL004"
    severity = "warn"
    name = "trace-time-random"
    description = ("host RNG inside traced code (a graph break, or "
                   "numpy's draws moved onto torch's generator)")
    interests = (ast.Call,)

    def visit(self, node, fctx):
        d = _dotted(node.func)
        if d and (d.startswith(_RANDOM_PREFIXES)):
            yield fctx.finding(
                self, node,
                f"'{d}()' draws host randomness in traced code: Dynamo "
                f"breaks the graph on `random.*` and traces `np.random.*` "
                f"onto torch's generator, so numpy's seed no longer "
                f"decides the values",
                hint="use torch tensor RNG ops (torch.randn/rand/"
                     "dropout), which draw on every call")


@register_rule
class PrintInTrace(Rule):
    """TL005 — `print` in traced code (fires at trace time only).

    bad:  print("step", loss)
    good: log outside the compiled function.
    """
    id = "TL005"
    severity = "info"
    name = "trace-time-print"
    description = "print breaks Dynamo's graph"
    interests = (ast.Call,)

    def visit(self, node, fctx):
        if isinstance(node.func, ast.Name) and node.func.id == "print":
            yield fctx.finding(
                self, node,
                "print() in traced code breaks Dynamo's graph (to_static's "
                "full_graph=True raises)",
                hint="return the value and print it outside the compiled "
                     "function")


# ===================================================================
# side effects
# ===================================================================
@register_rule
class ClosureSideEffect(Rule):
    """TL006 — mutating closure/global state from traced code.

    bad:  history.append(loss)        # replayed by Dynamo every call
    bad:  global step; step += 1      # the rebound global fails a guard
    good: return the value; keep state in buffers/outputs.
    """
    id = "TL006"
    severity = "warn"
    name = "closure-side-effect"
    description = "python side effect on closure/global state in trace"
    interests = (ast.Global, ast.Nonlocal, ast.Call)

    def visit(self, node, fctx):
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            kind = "global" if isinstance(node, ast.Global) else "nonlocal"
            yield fctx.finding(
                self, node,
                f"'{kind} {', '.join(node.names)}': Dynamo replays the "
                f"rebinding after each call, and a rebound global the "
                f"graph reads fails its guard: a recompile per call "
                f"(runtime cause 'guard failure'; it also blocks dy2static "
                f"conversion of this function)",
                hint="thread the value through function outputs instead")
            return
        f = node.func
        if isinstance(f, ast.Attribute) and \
                f.attr in _MUTATING_METHODS and \
                isinstance(f.value, ast.Name) and \
                f.value.id not in fctx.bound_names:
            yield fctx.finding(
                self, node,
                f"'{f.value.id}.{f.attr}(...)' mutates closure/global "
                f"state from traced code — Dynamo replays the mutation "
                f"after every call of the graph, outside it",
                hint="return the value from the traced function instead")


# ===================================================================
# dy2static convertibility
# ===================================================================
def _all_paths_return(body):
    if not body:
        return False
    last = body[-1]
    if isinstance(last, ast.Return):
        return last.value is not None
    if isinstance(last, ast.If):
        return _all_paths_return(last.body) and \
            _all_paths_return(last.orelse)
    return False


class _BlockScan(ast.NodeVisitor):
    """break/continue bound to this block + effect stores, mirroring
    dy2static._BlockInfo's convertibility contract."""

    def __init__(self):
        self.has_return = False
        self.loopjumps = []       # Break/Continue nodes bound here
        self.effect_stores = []   # attribute/subscript store targets
        self._loop_depth = 0

    def scan(self, body):
        for s in body:
            self.visit(s)
        return self

    def visit_Return(self, node):
        self.has_return = True

    def visit_Break(self, node):
        if self._loop_depth == 0:
            self.loopjumps.append(node)

    def visit_Continue(self, node):
        if self._loop_depth == 0:
            self.loopjumps.append(node)

    def visit_While(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_For(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_FunctionDef(self, node):
        pass   # nested defs are their own scope

    visit_AsyncFunctionDef = visit_FunctionDef

    def _store(self, t):
        if isinstance(t, (ast.Attribute, ast.Subscript)) and \
                isinstance(t.ctx, (ast.Store, ast.Del)):
            self.effect_stores.append(t)

    def visit_Assign(self, node):
        for t in node.targets:
            self._store(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._store(node.target)
        self.generic_visit(node)


@register_rule
class TensorIfEarlyExit(Rule):
    """TL007 — early return/break/continue under a tensor predicate.

    dy2static converts tensor `if`s to torch.cond only when control flow
    is structured: a `return` must appear in the every-path-returns form
    and `break`/`continue` cannot cross the block (see the
    jit/dy2static.py docstring contract).  Anything else is left
    unconverted and Dynamo breaks the graph on the tensor predicate.

    bad:  if x.sum() > 0: return x
          y = x + 1 ...
    good: give both paths a return, or compute a mask instead.
    """
    id = "TL007"
    severity = "error"
    name = "tensor-early-exit"
    description = ("early return/break/continue under a tensor `if` is "
                   "unconvertible (dy2static contract)")
    interests = (ast.If,)

    def visit(self, node, fctx):
        if taint_of(node.test) < TENSOR:
            return
        t = _BlockScan().scan(node.body)
        f = _BlockScan().scan(node.orelse)
        for jump in t.loopjumps + f.loopjumps:
            word = "break" if isinstance(jump, ast.Break) else "continue"
            yield fctx.finding(
                self, jump,
                f"'{word}' under a tensor-valued `if` cannot convert to "
                f"torch.cond; Dynamo breaks the graph on the predicate "
                f"(to_static's full_graph=True raises)",
                hint="rewrite with a boolean mask or loop-carried flag")
        if (t.has_return or f.has_return) and not (
                _all_paths_return(node.body) and
                _all_paths_return(node.orelse)):
            yield fctx.finding(
                self, node,
                "early `return` under a tensor-valued `if` only converts "
                "in the every-path-returns form; this shape is left "
                "unconverted and breaks Dynamo's graph",
                hint="make every path of the if/elif/else chain return, "
                     "or select with torch.where")


@register_rule
class TensorIfEffectStore(Rule):
    """TL011 — attribute/subscript store under a tensor predicate.

    bad:  if x.sum() > 0: self.hits[k] = 1
    good: functional update threaded through outputs/buffers.
    """
    id = "TL011"
    severity = "warn"
    name = "tensor-if-effect-store"
    description = ("attribute/subscript store under a tensor `if` blocks "
                   "dy2static conversion (side effect torch.cond can't "
                   "capture)")
    interests = (ast.If,)

    def visit(self, node, fctx):
        if taint_of(node.test) < TENSOR:
            return
        scan = _BlockScan().scan(node.body + node.orelse)
        for store in scan.effect_stores:
            yield fctx.finding(
                self, store,
                "store into an attribute/subscript inside a tensor-"
                "predicate `if`: dy2static refuses the block (side "
                "effects can't cross torch.cond) and Dynamo breaks the "
                "graph on the predicate",
                hint="bind a local name in both branches and assign "
                     "after the if")


# ===================================================================
# staleness / specialization hazards
# ===================================================================
@register_rule
class ClosureTensorConstant(Rule):
    """TL008 — closure-captured tensor baked into the trace.

    Silent in the port (`DYNAMO_DIVERGENCES`): Dynamo lifts a tensor
    read from a closure cell or a module global as an input of the graph
    (guarded on its identity), so an in-place update is seen by the next
    call, where `jax.jit` bakes the value as a constant.  The rule keeps
    its id and fires on nothing: it declares no visitor interests.
    """
    id = "TL008"
    severity = "warn"
    name = "closure-tensor-constant"
    description = ("tensor captured from closure/module scope is baked "
                   "as a trace constant (stale-weight hazard)")
    interests = ()

    def visit(self, node, fctx):
        if not isinstance(node.ctx, ast.Load):
            return
        names = fctx.closure_tensors | fctx.global_tensors
        if node.id not in names:
            return
        # per-name dedup lives on the fctx (rule instances are shared
        # module singletons — state here would leak across runs/threads)
        seen = getattr(fctx, "_tl008_seen", None)
        if seen is None:
            seen = fctx._tl008_seen = set()
        if node.id in seen:
            return
        seen.add(node.id)
        origin = "closure" if node.id in fctx.closure_tensors else \
            "module-global"
        yield fctx.finding(
            self, node,
            f"'{node.id}' is a {origin} tensor: jax.jit bakes its current "
            f"value into the compiled program — later in-place updates "
            f"are invisible (stale-constant hazard)",
            hint="pass it as an argument or register it as a Layer "
                 "parameter/buffer")


@register_rule
class MutableDefaultArg(Rule):
    """TL009 — mutable/unhashable default in a to_static signature.

    Dynamo guards on a default's contents: mutating it recompiles, and a
    mutable default aliases across calls.

    bad:  def forward(self, x, scales=[1.0, 2.0]): ...
    good: scales=(1.0, 2.0)  (tuple), or None + in-body default.
    """
    id = "TL009"
    severity = "warn"
    name = "mutable-default-arg"
    description = ("mutable default argument is an unhashable static-"
                   "argnum hazard for to_static(input_spec=...)")
    interests = (ast.FunctionDef, ast.AsyncFunctionDef)

    def visit(self, node, fctx):
        a = node.args
        for d in list(a.defaults) + [x for x in a.kw_defaults
                                     if x is not None]:
            bad = None
            if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                bad = {ast.List: "list", ast.Dict: "dict",
                       ast.Set: "set"}[type(d)]
            elif isinstance(d, ast.Call) and \
                    isinstance(d.func, ast.Name) and \
                    d.func.id in ("list", "dict", "set", "bytearray"):
                bad = d.func.id
            if bad:
                yield fctx.finding(
                    self, d,
                    f"{bad} default argument: Dynamo guards on its "
                    f"contents, so a mutation recompiles (runtime cause "
                    f"'new static arg' when passed); a mutable default "
                    f"also aliases across calls",
                    hint="use a tuple / None-plus-in-body default")


@register_rule
class ShapeDependentBranch(Rule):
    """TL010 — python branching on tensor *shape* metadata.

    Legal (shapes are static per trace) but each distinct shape
    specializes a new compiled program — the recompile storm the
    runtime compile_tracker diagnoses as cause "shape change".

    bad:  if x.size(0) > 128: ...
    good: pad/bucket inputs to stable shapes; branch outside the
          compiled function.
    """
    id = "TL010"
    severity = "warn"
    name = "shape-dependent-branch"
    description = ("branching on tensor shape metadata specializes the "
                   "trace per shape (recompile hazard; runtime cause "
                   "'shape change')")
    interests = (ast.If, ast.While)

    def visit(self, node, fctx):
        if taint_of(node.test) == SHAPE:
            kind = "if" if isinstance(node, ast.If) else "while"
            yield fctx.finding(
                self, node.test,
                f"`{kind}` on shape-derived value: compiles one program "
                f"per distinct input shape (runtime RecompileWarning "
                f"cause 'shape change' maps to this rule)",
                hint="pad/bucket batch shapes, or hoist the branch out "
                     "of the traced function")


_SHAPE_CONSTRUCTORS = {"zeros", "ones", "full", "empty", "arange",
                       "linspace", "eye", "broadcast_to", "tile",
                       "reshape", "resize", "pad"}
# dotted-prefix roots that make a bare constructor name an ARRAY
# constructor (cuts host-side noise: `mylist.pad(i)` is not a trace)
_ARRAY_ROOTS = {"torch", "np", "numpy", "paddle", "paddle_tpu_torch",
                "pt", "F"}


@register_rule
class LoopVariantShape(Rule):
    """TL013 — python-int shape construction inside a decode/step loop.

    The recompile-storm pattern: a HOST loop builds arrays whose shape
    depends on the loop variable, so every iteration hands to_static a
    never-seen shape and compiles a brand-new program — per-token cache
    growth in an autoregressive decode loop is the classic offender (one
    XLA compile per generated token; runtime RecompileWarning cause
    "shape change").  Host-only: a python loop INSIDE a trace unrolls
    into one program and cannot storm.

    bad:  for t in range(max_new):                 # host decode loop
              k = torch.zeros((b, t + 1, d))       # new shape per token
              step(ids.reshape(b, t + 1))
    good: preallocate at a bucketed max length and mask, or capture the
          loop's step once (`text.decode.jit_generate`).
    """
    id = "TL013"
    severity = "warn"
    name = "loop-variant-shape"
    description = ("array shape built from a python loop variable — one "
                   "compiled program per iteration (recompile storm; "
                   "runtime cause 'shape change')")
    interests = ()          # finish-based: owns its descent
    host = True

    @staticmethod
    def _loop_vars(node, body_iter):
        out = set()
        if isinstance(node, ast.For):
            for t in ast.walk(node.target):
                if isinstance(t, ast.Name):
                    out.add(t.id)
        else:
            # while-loop counters: names the body steps itself (i += 1)
            for sub in body_iter:
                if isinstance(sub, ast.AugAssign) and \
                        isinstance(sub.target, ast.Name):
                    out.add(sub.target.id)
        return out

    @staticmethod
    def _iter_body(loop):
        """The loop's own statements: nested loops analyze themselves,
        nested defs/lambdas run at call time, not per-iteration here."""
        stack = list(loop.body) + list(loop.orelse)
        out = []
        while stack:
            n = stack.pop()
            out.append(n)
            for c in ast.iter_child_nodes(n):
                if not isinstance(c, (ast.For, ast.While, ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    stack.append(c)
        return out

    @staticmethod
    def _uses(expr, names):
        return sorted(n.id for n in ast.walk(expr)
                      if isinstance(n, ast.Name) and n.id in names
                      and taint_of(n) < TENSOR)

    def _check_loop(self, loop, fctx):
        body = self._iter_body(loop)
        lvars = self._loop_vars(loop, body)
        if not lvars:
            return
        for sub in body:
            if not isinstance(sub, ast.Call) or not sub.args:
                continue
            f = sub.func
            if isinstance(f, ast.Attribute):
                last, root = f.attr, _dotted(f)
                root = root.split(".")[0] if root else None
                # module-function form (`F.pad(x, ...)`) vs method
                # form (`x.reshape(b, t)`): the receiver of a method
                # call IS the data, so every positional arg is shape-ish
                func_form = root in _ARRAY_ROOTS
                is_array = func_form or isinstance(f.value, ast.Name)
            elif isinstance(f, ast.Name):
                # bare zeros()/pad() from-imports: function form
                last, func_form, is_array = f.id, True, True
            else:
                continue
            if last not in _SHAPE_CONSTRUCTORS or not is_array:
                continue
            # which positional args determine the output shape
            if last in ("arange", "linspace"):
                shape_args = sub.args          # start/stop/num all count
            elif last in ("zeros", "ones", "full", "empty"):
                shape_args = sub.args[:1]      # shape first
            elif last == "eye":
                shape_args = sub.args[:2]      # N, M
            elif func_form:
                # (data, shape/reps/pad_width, ...) — broadcast_to,
                # tile, pad, reshape, resize
                shape_args = (sub.args[1:2]
                              if last in ("broadcast_to", "tile", "pad")
                              else sub.args[1:])
            else:
                shape_args = sub.args          # x.reshape(b, t + 1)
            used = sorted({v for a in shape_args
                           for v in self._uses(a, lvars)})
            if used:
                yield fctx.finding(
                    self, sub,
                    f"'{last}' shape depends on loop variable"
                    f"{'s' if len(used) > 1 else ''} {', '.join(used)}: "
                    f"each iteration hands the compiled function a new "
                    f"shape — one compiled graph per step (decode "
                    f"recompile storm; runtime cause 'shape change')",
                    hint="preallocate at a bucketed max size and mask")

    def finish(self, fctx):
        if fctx.trace_path:
            return      # in-trace loops unroll into ONE program
        stack = [fctx.node]
        while stack:
            n = stack.pop()
            for c in ast.iter_child_nodes(n):
                # descend into nested host defs (they are covered by
                # this lint) but not nested trace-path defs (they get
                # their own full-catalog lint)
                if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    from .core import is_trace_path
                    if is_trace_path(c):
                        continue
                stack.append(c)
            if isinstance(n, (ast.For, ast.While)):
                yield from self._check_loop(n, fctx)


@register_rule
class AssertOnTensor(Rule):
    """TL012 — `assert` over a traced tensor.

    bad:  assert (x > 0).all()
    good: validate outside the compiled function.
    """
    id = "TL012"
    severity = "warn"
    name = "tensor-assert"
    description = "assert on a traced tensor (data-dependent)"
    interests = (ast.Assert,)

    def visit(self, node, fctx):
        if taint_of(node.test) >= TENSOR:
            yield fctx.finding(
                self, node,
                "assert on a traced tensor is data-dependent: Dynamo keeps "
                "it as an assert inside the graph or breaks the graph on "
                "it (to_static's full_graph=True raises on a break)",
                hint="validate inputs before the traced call")
