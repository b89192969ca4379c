"""tracelint core of the port (counterpart: `paddle_tpu/analysis/core.py`):
the rule framework, findings, suppression and the lint drivers.

The analyzer is AST-based and purely static: it parses the source of
functions headed into the compile path (`jit.to_static`, whose Dynamo
capture plays the reference's `jax.jit` trace) and reports trace hazards
BEFORE the first compile: the static half of
`observability.compile_tracker`'s runtime recompile detector.

Framework pieces:
  * `Finding`   — structured result (file, line, rule, severity, message,
                  fix hint); JSON-able via `as_dict()`.
  * `Rule`      — visitor-driven base class: declares `interests` (AST
                  node types) and receives exactly those nodes from the
                  single shared walk in `_RuleDriver`.
  * `register_rule` / `all_rules` — the rule registry (rules.py fills it
    at import).
  * suppression — `# tracelint: disable=TL001,TL002` (or bare
    `# tracelint: disable` for all rules) on the offending line.
  * drivers     — `lint_source` / `lint_file` / `lint_function` /
                  `lint_path`; a syntax error is reported as a TL999
                  finding, not raised.
"""
from __future__ import annotations

import ast
import inspect
import os
import re
import textwrap

import torch

SEVERITIES = ("error", "warn", "info")

# severity rank for sorting: errors first
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


class Finding:
    """One diagnostic: where, which rule, what, and how to fix it."""

    __slots__ = ("file", "line", "col", "rule", "severity", "message",
                 "hint", "func")

    def __init__(self, file, line, col, rule, severity, message,
                 hint="", func=""):
        self.file = file
        self.line = line
        self.col = col
        self.rule = rule
        self.severity = severity
        self.message = message
        self.hint = hint
        self.func = func

    def as_dict(self):
        return {"file": self.file, "line": self.line, "col": self.col,
                "rule": self.rule, "severity": self.severity,
                "message": self.message, "hint": self.hint,
                "func": self.func}

    def render(self):
        loc = f"{self.file}:{self.line}:{self.col}"
        s = f"{loc}: {self.rule} [{self.severity}] {self.message}"
        if self.hint:
            s += f"  (fix: {self.hint})"
        return s

    def __repr__(self):
        return f"Finding({self.render()!r})"


def sort_findings(findings):
    return sorted(findings, key=lambda f: (f.file, f.line, f.col,
                                           _SEV_RANK.get(f.severity, 9),
                                           f.rule))


# ===================================================================
# rule registry
# ===================================================================
_RULES: dict = {}   # rule id -> Rule instance


class Rule:
    """Base rule.  Subclasses set `id` (TLxxx), `severity`, `name`, and
    `interests` (tuple of ast node classes); the driver calls
    `visit(node, fctx)` for every matching node in one shared walk and
    `finish(fctx)` once at the end.  Both yield `Finding`s (use
    `fctx.finding(...)` to build them)."""

    id = "TL000"
    severity = "warn"
    name = "unnamed"
    description = ""
    interests: tuple = ()
    # host rules lint the functions file-mode otherwise skips: host-side
    # driver code (eager decode/step loops) whose hazard is how it CALLS
    # jit, not what happens inside a trace (e.g. TL013 recompile storms)
    host = False

    def visit(self, node, fctx):
        return ()

    def finish(self, fctx):
        return ()


def register_rule(cls):
    """Class decorator: instantiate + add to the registry (unique ids)."""
    inst = cls()
    if inst.id in _RULES:
        raise ValueError(f"duplicate tracelint rule id {inst.id}")
    if inst.severity not in SEVERITIES:
        raise ValueError(f"{inst.id}: bad severity {inst.severity!r}")
    _RULES[inst.id] = inst
    return cls


def all_rules():
    """id -> Rule instance, import-order stable."""
    from . import rules  # noqa: F401  (populates the registry)
    return dict(_RULES)


# ===================================================================
# suppression comments
# ===================================================================
_SUPPRESS_RE = re.compile(
    r"#\s*tracelint:\s*disable(?:=([A-Za-z0-9_,\s]+))?")


def parse_suppressions(source):
    """line number (1-based) -> set of rule ids, or {'*'} for all."""
    out = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        ids = m.group(1)
        out[i] = ({s.strip().upper() for s in ids.split(",") if s.strip()}
                  if ids else {"*"})
    return out


def _suppressed(finding, suppressions):
    ids = suppressions.get(finding.line)
    return bool(ids) and ("*" in ids or finding.rule in ids)


# ===================================================================
# per-function context
# ===================================================================
# `forward` is the traced entry (Layer.__call__ wraps it); data-pipeline
# classes use __call__ for HOST-side work, so it deliberately doesn't count
_TRACE_NAMES = ("forward",)
_TRACE_DECOS = ("to_static", "train_step", "compile", "jit", "grad",
                "value_and_grad", "checkpoint", "vmap")


def is_trace_path(node):
    """Heuristic: is this def headed into the jit/dy2static path?

    True for `forward` methods (`nn.Module.forward`; `__call__`
    deliberately does NOT count — see _TRACE_NAMES) and for functions
    whose decorator chain names a compile entry (to_static,
    torch.compile, train_step, ...).  File-mode linting
    skips host-side functions entirely: their prints / numpy RNG / host
    syncs are ordinary correct code, not trace hazards.
    """
    if node.name in _TRACE_NAMES:
        return True
    for dec in node.decorator_list:
        d = dec.func if isinstance(dec, ast.Call) else dec
        while isinstance(d, ast.Attribute):
            if d.attr == "not_to_static":
                return False
            if d.attr in _TRACE_DECOS:
                return True
            d = d.value
        if isinstance(d, ast.Name):
            if d.id == "not_to_static":
                return False
            if d.id in _TRACE_DECOS:
                return True
    return False


class FunctionContext:
    """Everything a rule may consult about the function under lint."""

    def __init__(self, node, file, qualname, line_offset=0,
                 freevars=(), closure_tensors=(), global_tensors=(),
                 trace_path=None):
        self.node = node                      # ast.FunctionDef
        self.file = file
        self.qualname = qualname
        self.line_offset = line_offset        # source-extract line shift
        self.freevars = frozenset(freevars)
        # names whose closure cell / module global holds a Tensor/array
        self.closure_tensors = frozenset(closure_tensors)
        self.global_tensors = frozenset(global_tensors)
        self.trace_path = is_trace_path(node) if trace_path is None \
            else trace_path
        a = node.args
        self.params = tuple(p.arg for p in
                            a.posonlyargs + a.args + a.kwonlyargs +
                            ([a.vararg] if a.vararg else []) +
                            ([a.kwarg] if a.kwarg else []))
        self.bound_names = self._collect_bound()

    def _collect_bound(self):
        bound = set(self.params)
        for sub in ast.walk(self.node):
            if isinstance(sub, ast.Name) and isinstance(
                    sub.ctx, (ast.Store, ast.Del)):
                bound.add(sub.id)
            elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)) and sub is not self.node:
                bound.add(sub.name)
            elif isinstance(sub, (ast.Import, ast.ImportFrom)):
                for al in sub.names:
                    bound.add((al.asname or al.name).split(".")[0])
        return bound

    def real_line(self, node):
        return getattr(node, "lineno", 1) + self.line_offset

    def finding(self, rule, node, message, hint=""):
        return Finding(self.file, self.real_line(node),
                       getattr(node, "col_offset", 0) + 1,
                       rule.id, rule.severity, message, hint=hint,
                       func=self.qualname)


class _RuleDriver(ast.NodeVisitor):
    """One walk of the function AST dispatching nodes to interested
    rules — the visitor half of the framework."""

    def __init__(self, rules, fctx):
        self._dispatch = {}
        for r in rules:
            for t in r.interests:
                self._dispatch.setdefault(t, []).append(r)
        self.fctx = fctx
        self.findings = []

    def run(self, rules):
        self.visit(self.fctx.node)
        for r in rules:
            self.findings.extend(r.finish(self.fctx))
        return self.findings

    def generic_visit(self, node):
        for r in self._dispatch.get(type(node), ()):
            self.findings.extend(r.visit(node, self.fctx))
        super().generic_visit(node)


# ===================================================================
# lint drivers
# ===================================================================
def lint_function_node(node, file, qualname, line_offset=0, rules=None,
                       suppressions=None, **ctx_kwargs):
    """Lint one ast.FunctionDef.  Returns raw (unsuppressed) findings
    unless `suppressions` is given."""
    from .taint import TaintPass
    fctx = FunctionContext(node, file, qualname, line_offset=line_offset,
                           **ctx_kwargs)
    TaintPass(fctx).run()
    if rules is None:
        rules = all_rules()
    rule_list = list(rules.values()) if isinstance(rules, dict) \
        else list(rules)
    findings = _RuleDriver(rule_list, fctx).run(rule_list)
    if suppressions is not None:
        findings = [f for f in findings
                    if not _suppressed(f, suppressions)]
    return findings


def _iter_functions(tree, prefix=""):
    """Yield (node, qualname) for every def in a module tree, outermost
    first.  Nested defs are linted as part of their enclosing function's
    walk AND on their own (so findings carry the precise qualname)."""
    for node in tree.body if isinstance(tree, ast.Module) else []:
        yield from _iter_in(node, prefix)


def _stmt_blocks(node):
    """Every statement list hanging off a compound statement — body,
    orelse, try handlers/finalbody, match case bodies."""
    for attr in ("body", "orelse", "finalbody"):
        block = getattr(node, attr, None)
        if isinstance(block, list):
            yield from block
    for h in getattr(node, "handlers", []) or []:
        yield from h.body
    for c in getattr(node, "cases", []) or []:
        yield from c.body


def _iter_in(node, prefix):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        qn = prefix + node.name
        yield node, qn
        for sub in node.body:
            yield from _iter_in(sub, qn + ".<locals>.")
    elif isinstance(node, ast.ClassDef):
        for sub in node.body:
            yield from _iter_in(sub, prefix + node.name + ".")
    else:
        for sub in _stmt_blocks(node):
            yield from _iter_in(sub, prefix)


def lint_source(source, file="<string>", rules=None):
    """Lint every function in a source string; returns sorted findings
    with suppressions applied."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(file, e.lineno or 1, (e.offset or 0) + 1, "TL999",
                        "error", f"syntax error: {e.msg}")]
    sup = parse_suppressions(source)
    if rules is None:
        rules = all_rules()
    rule_list = list(rules.values()) if isinstance(rules, dict) \
        else list(rules)
    host_rules = [r for r in rule_list if r.host]
    findings, covered = [], set()
    for node, qualname in _iter_functions(tree):
        # file mode lints trace-path functions with the full catalog;
        # host-side helpers legitimately print/seed numpy/sync tensors,
        # so they get only the `host` rules (how-you-call-jit hazards,
        # e.g. TL013 recompile storms).  A def nested in an already-
        # linted function was walked with its parent — skip re-linting.
        if id(node) in covered:
            continue
        on_trace = is_trace_path(node)
        if not on_trace and not host_rules:
            continue
        for sub in ast.walk(node):
            if sub is not node and isinstance(
                    sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a host lint must NOT swallow a nested trace-path def
                # (the `step_fn` built inside a host factory): it still
                # needs its own full-catalog lint
                if on_trace or not is_trace_path(sub):
                    covered.add(id(sub))
        findings.extend(lint_function_node(
            node, file, qualname,
            rules=(rule_list if on_trace else host_rules),
            suppressions=sup))
    return sort_findings(findings)


def lint_file(path, rules=None):
    with open(path, encoding="utf-8") as f:
        src = f.read()
    return lint_source(src, file=path, rules=rules)


def lint_path(path, rules=None):
    """Lint a file or (recursively) every .py file under a directory."""
    if os.path.isfile(path):
        return lint_file(path, rules=rules)
    findings = []
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                findings.extend(lint_file(os.path.join(dirpath, fn),
                                          rules=rules))
    return sort_findings(findings)


def _tensorish(v):
    return isinstance(v, torch.Tensor)


def lint_function(fn, rules=None):
    """Lint a live function/method object.  Knows what static file mode
    cannot: real closure-cell and module-global values (the tensors a
    closure captures) and the defining file/line."""
    raw = fn.__func__ if inspect.ismethod(fn) else fn
    raw = inspect.unwrap(raw)
    if not inspect.isfunction(raw):
        return []
    try:
        src = textwrap.dedent(inspect.getsource(raw))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return []
    node = tree.body[0]
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    node.decorator_list = []
    closure_tensors, freevars = set(), set(raw.__code__.co_freevars)
    if raw.__closure__:
        for name, cell in zip(raw.__code__.co_freevars, raw.__closure__):
            try:
                if _tensorish(cell.cell_contents):
                    closure_tensors.add(name)
            except ValueError:
                pass
    global_tensors = set()
    for name in raw.__code__.co_names:
        if _tensorish(raw.__globals__.get(name)):
            global_tensors.add(name)
    file = raw.__code__.co_filename
    # co_firstlineno is the file line of the snippet's FIRST line (the
    # first decorator when present, else the def) and inspect.getsource
    # starts at that same line — so the offset is independent of how
    # many decorator lines precede the def
    offset = raw.__code__.co_firstlineno - 1
    sup = {ln + offset: ids
           for ln, ids in parse_suppressions(src).items()}
    findings = lint_function_node(
        node, file, raw.__qualname__, line_offset=offset, rules=rules,
        suppressions=sup, freevars=freevars,
        closure_tensors=closure_tensors, global_tensors=global_tensors,
        trace_path=True)
    return sort_findings(findings)
