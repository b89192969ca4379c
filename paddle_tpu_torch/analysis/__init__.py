"""paddle_tpu_torch.analysis — "tracelint" of the port (counterpart:
`paddle_tpu/analysis`): static trace-safety analysis.

The static half of the correctness tooling: where
`observability.compile_tracker` diagnoses recompile storms at RUNTIME,
tracelint parses the source of functions headed into `jit.to_static`
(Dynamo's capture) and reports trace hazards BEFORE the first compile —
host syncs and prints that break the graph, trace-time impurity,
unconvertible control flow, and shape-specialization recompile hazards
— plus an auditor of the `torch.library` operators that carry the hand
kernels into compiled graphs and of the routing in `ops/`.

Entry points:
  * `lint_function(fn)` / `lint_source(src)` / `lint_path(path)`
  * `audit_registry(device=...)` — the operators + ops/ source
  * `check_traceable(target)` — the warning-emitting hook of
    `jit.to_static(..., check=True)` and PADDLE_TPU_TRACELINT=1
  * CLI: `python -m paddle_tpu_torch.analysis [--json|--audit|--self]
    PATH...`

The rule catalog is the reference's (`rules.py`, TL001-TL013), with the
rules Dynamo changes reworded or silent (`rules.DYNAMO_DIVERGENCES`).
Suppress a finding with `# tracelint: disable=TL001` on its line.
"""
from __future__ import annotations

import os
import warnings

from .core import (Finding, Rule, all_rules, lint_file, lint_function,  # noqa: F401
                   lint_path, lint_source, register_rule, sort_findings,
                   SEVERITIES)
from .rules import DYNAMO_DIVERGENCES, STATIC_RULE_FOR_CAUSE  # noqa: F401
from .registry_audit import audit_registry  # noqa: F401

__all__ = ["DYNAMO_DIVERGENCES", "Finding", "Rule", "SEVERITIES",
           "STATIC_RULE_FOR_CAUSE", "TraceLintWarning", "all_rules",
           "audit_registry", "check_traceable", "env_enabled",
           "lint_file", "lint_function", "lint_path", "lint_source",
           "register_rule", "sort_findings", "static_rule_for_cause"]


class TraceLintWarning(UserWarning):
    """A tracelint finding surfaced at to_static decoration time."""


def env_enabled():
    """The PADDLE_TPU_TRACELINT switch (read by jit.to_static)."""
    return os.environ.get("PADDLE_TPU_TRACELINT", "").lower() in \
        ("1", "true", "on")


def static_rule_for_cause(cause):
    """Static rule id covering a runtime recompile cause, or None — lets
    RecompileWarning point at the pre-compile diagnostic."""
    return STATIC_RULE_FOR_CAUSE.get(cause)


def check_traceable(target, warn=True, min_severity="info"):
    """Lint a function (or a Layer's forward) headed into to_static.

    Returns the findings; with `warn=True` each one is also surfaced as
    a TraceLintWarning.  Never raises, never mutates `target`: what is
    traced is the same whether or not the check runs."""
    fn = target
    forward = getattr(target, "forward", None)
    if forward is not None and not isinstance(target, type):
        fn = forward
    try:
        findings = lint_function(fn)
    except Exception:   # linting must never break decoration
        return []
    keep = SEVERITIES[:SEVERITIES.index(min_severity) + 1] \
        if min_severity in SEVERITIES else SEVERITIES
    findings = [f for f in findings if f.severity in keep]
    if warn:
        for f in findings:
            warnings.warn(f"tracelint: {f.render()}", TraceLintWarning,
                          stacklevel=3)
    return findings
