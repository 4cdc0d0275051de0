#!/usr/bin/env python3
"""Lint driver for the port: its checkers, one summary table.

The port's counterpart of ``scripts/lint.py``, whose driver it imports
and runs over four checkers in order: docs (the shared
``check_docs.py``), the port's docstrings, the port's API surface and
the port's static analysis, failing fast as ``lint.py`` does. It has no
bench-schema step: the port writes no ``BENCH_*.json`` yet.

Usage: python scripts/torch_lint.py [--no-fail-fast]
"""
from __future__ import annotations

import pathlib
import sys

SCRIPTS = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(SCRIPTS))

import lint as base  # noqa: E402

CHECKS = (
    ("docs", "check_docs.py", ()),
    ("docstrings", "torch_check_docstrings.py", ()),
    ("api-surface", "torch_check_api.py", ()),
    ("static-analysis", "torch_check_static.py", ()),
)


def main() -> int:
    """Run every checker; print the summary table; exit 1 on any failure."""
    base.CHECKS = CHECKS
    return base.main()


if __name__ == "__main__":
    raise SystemExit(main())
