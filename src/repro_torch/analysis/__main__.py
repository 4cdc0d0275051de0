"""Command-line driver: ``python -m repro_torch.analysis``.

Runs the registered static-analysis passes over the repository and
prints one line per finding (``path:line: [rule] message (hint)``) plus a
summary.  Exit status 0 means clean, 1 means findings survived
suppression.  ``--format json`` / ``--report`` emit the machine-readable
report CI uploads as an artifact.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from .core import SUPPRESSION_BUDGET, Finding, run_passes
from .registry import pass_names, pass_plugin

__all__ = ["main", "run", "report_dict"]


def run(root: "str | Path", select: Optional[List[str]] = None,
        paths: Optional[List[str]] = None,
        budget: int = SUPPRESSION_BUDGET) -> List[Finding]:
    """Run the selected passes and return their findings.

    Args:
        root: Repository root.
        select: Pass names to run (default: all registered passes).
        paths: Explicit files for file-scope passes (default: each pass's
            own globs).
        budget: Suppression budget forwarded to the reporting core.

    Returns:
        Findings surviving suppression, in pass order.
    """
    names = select or list(pass_names())
    passes = [pass_plugin(n) for n in names]
    return run_passes(passes, root, paths=paths, budget=budget)


def report_dict(findings: List[Finding], passes: List[str]) -> dict:
    """Build the JSON report structure written by ``--report``.

    Args:
        findings: Findings to serialize.
        passes: Names of the passes that ran.

    Returns:
        A JSON-serializable dict with schema version, pass list, counts,
        and one record per finding.
    """
    return {
        "schema_version": 1,
        "passes": list(passes),
        "count": len(findings),
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line,
             "message": f.message, "hint": f.hint}
            for f in findings
        ],
    }


def main(argv: Optional[List[str]] = None) -> int:
    """Entry point for ``python -m repro_torch.analysis``.

    Args:
        argv: Argument list (default ``sys.argv[1:]``).

    Returns:
        Process exit status: 0 when clean, 1 when findings remain.
    """
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based invariant linter for the control plane.")
    ap.add_argument("paths", nargs="*",
                    help="explicit files for file-scope passes "
                         "(default: each pass's configured globs)")
    ap.add_argument("--select", action="append", metavar="PASS",
                    help="run only this pass (repeatable)")
    ap.add_argument("--root", default=".",
                    help="repository root (default: cwd)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="stdout format")
    ap.add_argument("--report", metavar="PATH",
                    help="also write the JSON report to this file")
    ap.add_argument("--list", action="store_true",
                    help="list registered passes and rules, then exit")
    args = ap.parse_args(argv)

    if args.list:
        for name in pass_names():
            plugin = pass_plugin(name)
            print(f"{name}: {plugin.description} [{plugin.scope}]")
            for rule in plugin.rules:
                print(f"  {rule.id}: {rule.summary}")
        return 0

    names = args.select or list(pass_names())
    findings = run(args.root, select=names, paths=args.paths or None)
    report = report_dict(findings, names)
    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2) + "\n",
                                     encoding="utf-8")
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        for f in findings:
            print(f.render())
        ran = ", ".join(names)
        if findings:
            print(f"repro_torch.analysis: {len(findings)} finding(s) from "
                  f"passes: {ran}", file=sys.stderr)
        else:
            print(f"repro_torch.analysis: OK (passes: {ran})")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
