"""tracelint CLI of the port (counterpart: `paddle_tpu/analysis/cli.py`).

    python -m paddle_tpu_torch.analysis PATH...          text output
    python -m paddle_tpu_torch.analysis --json PATH...   JSON findings
    python -m paddle_tpu_torch.analysis --audit [--device cpu]
                                   the operators + ops/ routing audit
    python -m paddle_tpu_torch.analysis --self [--device cpu]
                                   the audit + self-lint of the port's
                                   model zoo and host code (text/, nn/,
                                   vision/, framework/, serving/) against
                                   the checked-in baseline
    python -m paddle_tpu_torch.analysis --write-baseline [--device cpu]

Exit code: 1 when findings at/above --fail-on severity exist — default
"error" for path lints, "info" (any new non-baselined finding) for
--self, where a failed registry audit always exits 1.  The audit runs
`opcheck` on --device (default: the current device, which needs a card
unless the CPU is named).

The baseline (`paddle_tpu_torch/analysis/tracelint_baseline.json`, in
the package: `tools/tracelint_baseline.json` is the reference's) keys
allowed findings by (relative file, rule id, function qualname) — line
numbers are omitted so unrelated edits don't churn it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .core import lint_path, sort_findings, SEVERITIES
from .registry_audit import audit_registry


def _repo_root():
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def default_baseline_path():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tracelint_baseline.json")


def self_lint_targets():
    """The self-lint corpus: the port's model zoo and layers, and the
    host-side code the TL013 host rules cover."""
    pkg = os.path.join(_repo_root(), "paddle_tpu_torch")
    return [os.path.join(pkg, d) for d in ("text", "nn", "vision",
                                            "framework", "serving")]


def finding_key(f, root):
    file = os.path.relpath(f.file, root) if os.path.isabs(f.file) \
        else f.file
    return f"{file.replace(os.sep, '/')}::{f.rule}::{f.func}"


def load_baseline(path):
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        return set(data.get("allowed", []))
    except (OSError, ValueError):
        return set()


def write_baseline(path, findings, root):
    data = {"comment": "tracelint allowed findings: file::rule::function "
                       "(regenerate with python -m "
                       "paddle_tpu_torch.analysis --write-baseline)",
            "allowed": sorted({finding_key(f, root) for f in findings})}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=1, sort_keys=True)
        fh.write("\n")


def run_self(baseline_path=None, write=False, out=sys.stdout,
             fail_on="info", device=None):
    """Registry audit + self-lint vs baseline.  Returns exit code.

    A failed registry audit always exits 1; un-baselined self-lint
    findings exit 1 when at/above `fail_on` (default: every severity —
    the tier-1 contract is that NEW findings of any kind are reviewed
    or baselined, not silently accumulated)."""
    root = _repo_root()
    audit = audit_registry(device=device)
    findings = []
    for target in self_lint_targets():
        findings.extend(lint_path(target))
    findings = sort_findings(findings)
    baseline_path = baseline_path or default_baseline_path()
    if write:
        for f in audit:
            print(f"tracelint: {f.render()}", file=out)
        write_baseline(baseline_path, findings, root)
        print(f"tracelint: baseline written to {baseline_path} "
              f"({len(findings)} findings); registry audit "
              f"{'FAILED' if audit else 'OK'}", file=out)
        return 1 if audit else 0
    allowed = load_baseline(baseline_path)
    gate = SEVERITIES[:SEVERITIES.index(fail_on) + 1] \
        if fail_on in SEVERITIES else SEVERITIES
    fresh = [f for f in findings
             if finding_key(f, root) not in allowed
             and f.severity in gate]
    for f in audit + fresh:
        print(f"tracelint: {f.render()}", file=out)
    n_base = sum(1 for f in findings
                 if finding_key(f, root) in allowed)
    print(f"tracelint --self: registry audit "
          f"{'FAILED' if audit else 'OK'} "
          f"({len(audit)} findings); self-lint {len(findings)} findings, "
          f"{n_base} baselined, {len(fresh)} new at/above "
          f"'{fail_on}'", file=out)
    return 1 if (audit or fresh) else 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis",
        description="static trace-safety analyzer for the port's "
                    "to_static path")
    ap.add_argument("paths", nargs="*", help="files or directories")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON")
    ap.add_argument("--audit", action="store_true",
                    help="audit the torch.library operators and the "
                         "ops/ routing")
    ap.add_argument("--self", dest="self_mode", action="store_true",
                    help="registry audit + self-lint vs the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="refresh the self-lint baseline")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: the package's "
                         "tracelint_baseline.json)")
    ap.add_argument("--device", default=None,
                    help="where the audit's opcheck runs (default: the "
                         "current device; cpu without a card)")
    ap.add_argument("--fail-on", default=None,
                    choices=list(SEVERITIES),
                    help="exit 1 when findings at/above this severity "
                         "exist (default: error for path lints, info — "
                         "i.e. any new finding — for --self)")
    args = ap.parse_args(argv)

    if args.self_mode or args.write_baseline:
        return run_self(baseline_path=args.baseline,
                        write=args.write_baseline,
                        fail_on=args.fail_on or "info",
                        device=args.device)

    findings = []
    if args.audit:
        findings.extend(audit_registry(device=args.device))
    for p in args.paths:
        if not os.path.exists(p):
            print(f"tracelint: error: no such file or directory: {p}",
                  file=sys.stderr)
            return 2
        findings.extend(lint_path(p))
    if not args.paths and not args.audit:
        ap.print_usage()
        return 2
    findings = sort_findings(findings)
    if args.json:
        print(json.dumps([f.as_dict() for f in findings], indent=1))
    else:
        for f in findings:
            print(f"tracelint: {f.render()}")
        by_sev = {s: sum(1 for f in findings if f.severity == s)
                  for s in SEVERITIES}
        print(f"tracelint: {len(findings)} finding(s) "
              f"({', '.join(f'{n} {s}' for s, n in by_sev.items())})")
    fail_on = args.fail_on or "error"
    gate = SEVERITIES[:SEVERITIES.index(fail_on) + 1]
    return 1 if any(f.severity in gate for f in findings) else 0
