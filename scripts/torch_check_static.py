#!/usr/bin/env python3
"""CI wrapper for the port's static-analysis suite.

The port's counterpart of ``scripts/check_static.py``: it runs
``repro_torch.analysis`` the way that script runs ``repro.analysis``.

It runs every registered pass over the repository with the port's scopes
(``src/repro_torch/`` and ``docs/api.md``), writes the JSON report
(``ANALYSIS_REPORT_torch.json`` by default), and exits non-zero if any
finding survived suppression.  Pure stdlib: the analysis package imports
neither torch nor jax, so this check needs no runtime deps.

Usage: python scripts/torch_check_static.py [--report PATH]
       [--select PASS ...]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.__main__ import main as analysis_main  # noqa: E402


def main() -> int:
    """Run the suite repo-wide; print one summary line like its siblings."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--report", default="ANALYSIS_REPORT_torch.json",
                    help="JSON report path "
                         "(default: ANALYSIS_REPORT_torch.json)")
    ap.add_argument("--select", action="append", metavar="PASS",
                    help="run only this pass (repeatable)")
    args = ap.parse_args()

    argv = ["--root", str(ROOT), "--report", args.report]
    for name in args.select or ():
        argv += ["--select", name]
    rc = analysis_main(argv)
    if rc == 0:
        print(f"torch_check_static: OK (report: {args.report})")
    else:
        print("torch_check_static: findings above must be fixed (or "
              "suppressed within budget)", file=sys.stderr)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
