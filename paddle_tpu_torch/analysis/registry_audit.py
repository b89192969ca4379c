"""tracelint registry auditor of the port (counterpart:
`paddle_tpu/analysis/registry_audit.py`).

The reference audits `ops.dispatch._REGISTRY`, which the port does not
have: its hand kernels reach compiled graphs as `torch.library` operators
(`paddle_tpu_torch::flash_fwd`, `flash_bwd`, `paged_decode`,
`count_plain_sdpa`), and `ops/__init__.py` routes each call in Python.
So the audit checks what takes the registry's place, in two views:

  * the LIVE operators (after `import paddle_tpu_torch.ops`): every
    `paddle_tpu_torch::` operator has a CPU body (the plain version), a
    CUDA body (the kernel's wrapper), a fake implementation (what
    Dynamo and AOTAutograd trace), and passes `torch.library.opcheck` on
    a small sample on the audited device;
  * the SOURCE under `ops/` (AST): an operator name is defined once
    (`torch.library.custom_op("paddle_tpu_torch::x", ...)`), a literal
    AMP policy at a `cast_inputs(op, policy, ...)` call is valid, and
    every `module.name` the routing reads from a module of the package
    (`_flash.flash_attention`, `nn_kernels.sdpa`) names a function that
    exists there.

Findings reuse the tracelint `Finding` shape with the reference's REG
ids where a check carries over:

  REG001  invalid AMP policy (a `cast_inputs` literal; the reference
          reads it from the registry, the port from each call site)
  REG002  duplicate source registration of an operator
  REG003  the routing names a function its module does not define (the
          reference: an override target never registered)
  REG004  an operator's bodies disagree with its schema or its fake
          implementation (`opcheck`; the reference: an override's
          signature incompatible with its base)
  REG005  bad operator entry (a missing CPU or CUDA body or fake
          implementation, or an operator without an audit sample)
"""
from __future__ import annotations

import ast
import os

import torch

from .core import Finding, sort_findings

VALID_AMP = ("allow", "deny", "keep")
NAMESPACE = "paddle_tpu_torch"


def _finding(rule, message, file="<registry>", line=0, hint="", func=""):
    return Finding(file, line, 0, rule, "error", message, hint=hint,
                   func=func)


# ===================================================================
# live-operator checks
# ===================================================================
def _samples(device):
    """name -> (args of one small call), on `device`."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(device)

    q, k, v = rnd(1, 4, 2, 8), rnd(1, 4, 2, 8), rnd(1, 4, 2, 8)
    o, lse = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, None, True,
                                                  0.35, 0)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32,
                          device=device)
    lens = torch.tensor([5, 7], dtype=torch.int32, device=device)
    return {
        f"{NAMESPACE}::flash_fwd": (q, k, v, None, True, 0.35, 0),
        f"{NAMESPACE}::flash_bwd": (q, k, v, o, lse, rnd(1, 4, 2, 8),
                                    None, True, 0.35, 0),
        f"{NAMESPACE}::paged_decode": (rnd(2, 1, 4, 8), rnd(5, 4, 2, 8),
                                       rnd(5, 4, 2, 8), tables, lens, 0.35),
        f"{NAMESPACE}::count_plain_sdpa": (
            torch.zeros((), dtype=torch.int32, device=device),),
    }


def operator_names():
    """The `paddle_tpu_torch::` operators registered in this process."""
    from .. import ops  # noqa: F401  (registers them)
    return sorted(n for n in torch._C._dispatch_get_all_op_names()
                  if n.startswith(NAMESPACE + "::"))


def _has_body(name, key):
    return any(torch._C._dispatch_has_kernel_for_dispatch_key(name, k)
               for k in (key, "CompositeExplicitAutograd"))


def _has_fake(name):
    from torch._library import custom_ops
    from torch._library.simple_registry import singleton
    opdef = custom_ops.OPDEFS.get(name)
    if opdef is not None:     # a custom_op: its registered fake function
        return opdef._abstract_fn is not None
    return singleton.find(name).fake_impl.kernel is not None


def _overload(name):
    ns, op = name.split("::")
    return getattr(getattr(torch.ops, ns), op).default


def audit_live_registry(device=None):
    """Audit every live `paddle_tpu_torch::` operator; `opcheck` runs its
    sample on `device` (default: the current device, which raises without
    a card unless the CPU is named)."""
    from ..device import resolve_device
    device = resolve_device(device)
    samples = _samples(device)
    findings = []
    for name in operator_names():
        for key, what in (("CPU", "CPU body (the plain version)"),
                          ("CUDA", "CUDA body (the kernel's wrapper)")):
            if not _has_body(name, key):
                findings.append(_finding(
                    "REG005", f"operator '{name}' has no {what}",
                    func=name,
                    hint=f"register_kernel('{key.lower()}') on the "
                         f"custom op"))
        if not _has_fake(name):
            findings.append(_finding(
                "REG005", f"operator '{name}' has no fake implementation "
                f"(Dynamo and AOTAutograd cannot trace it)", func=name,
                hint="register_fake on the custom op"))
            continue
        args = samples.get(name)
        if args is None:
            findings.append(_finding(
                "REG005", f"operator '{name}' has no audit sample",
                func=name, hint="add one to registry_audit._samples"))
            continue
        try:
            torch.library.opcheck(_overload(name), args)
        except Exception as e:   # opcheck reports any failing check
            findings.append(_finding(
                "REG004", f"operator '{name}' fails opcheck on "
                f"{device.type}: {str(e).splitlines()[0][:300]}",
                func=name,
                hint="make the bodies and the fake implementation agree "
                     "with the schema"))
    return findings


# ===================================================================
# source checks (walk ops/ for operator definitions and routing)
# ===================================================================
def _call_name(node):
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _str_arg(node, i):
    if len(node.args) > i and isinstance(node.args[i], ast.Constant) \
            and isinstance(node.args[i].value, str):
        return node.args[i].value
    return None


def _top_names(tree):
    """Names a module defines at its top level."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names.add((a.asname or a.name).split(".")[0])
    return names


def _sibling_aliases(tree):
    """{alias: module name} of `from . import x [as y]` in `tree`."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1 and \
                node.module is None:
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out


def audit_ops_source(ops_dir=None):
    if ops_dir is None:
        ops_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "ops")
    findings, trees = [], {}
    for fn in sorted(os.listdir(ops_dir)):
        if not fn.endswith(".py"):
            continue
        path = os.path.join(ops_dir, fn)
        with open(path, encoding="utf-8") as f:
            try:
                trees[fn[:-3]] = (path, ast.parse(f.read()))
            except SyntaxError as e:
                findings.append(_finding(
                    "REG005", f"cannot parse: {e.msg}", file=path,
                    line=e.lineno or 0))
    defined = {mod: _top_names(tree) for mod, (_, tree) in trees.items()}
    registered = {}    # operator name -> (file, line)
    for mod, (path, tree) in trees.items():
        aliases = {a: m for a, m in _sibling_aliases(tree).items()
                   if m in defined}
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in aliases and \
                    isinstance(node.ctx, ast.Load):
                target = aliases[node.value.id]
                if node.attr not in defined[target]:
                    findings.append(_finding(
                        "REG003", f"routing reads '{node.value.id}."
                        f"{node.attr}', which ops/{target}.py does not "
                        f"define", file=path, line=node.lineno,
                        func=node.attr,
                        hint="route to a function that exists"))
            if not isinstance(node, ast.Call):
                continue
            kind = _call_name(node)
            if kind == "custom_op":
                name = _str_arg(node, 0)
                if name is None:
                    continue
                if name in registered:
                    pf, pl = registered[name]
                    findings.append(_finding(
                        "REG002", f"operator '{name}' defined twice "
                        f"(first at {os.path.basename(pf)}:{pl}); the "
                        f"second definition raises at import",
                        file=path, line=node.lineno, func=name))
                else:
                    registered[name] = (path, node.lineno)
            elif kind == "cast_inputs":
                op, policy = _str_arg(node, 0), _str_arg(node, 1)
                if policy is not None and policy not in VALID_AMP:
                    findings.append(_finding(
                        "REG001", f"op '{op}' cast with invalid amp "
                        f"policy {policy!r} (must be one of {VALID_AMP})",
                        file=path, line=node.lineno, func=str(op)))
    return findings


def audit_registry(ops_dir=None, device=None):
    """Full audit: live operators + ops/ source.  Returns findings
    (empty = healthy)."""
    return sort_findings(audit_live_registry(device=device) +
                         audit_ops_source(ops_dir=ops_dir))
