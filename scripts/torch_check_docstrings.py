#!/usr/bin/env python3
"""Docstring discipline for the port's public core API.

The port's counterpart of ``scripts/check_docstrings.py``, whose checker
it imports and runs over ``src/repro_torch/{core,api}`` instead of
``src/repro/{core,api}``: the same two tiers (every public module,
class, function and method has a docstring whose summary line ends in
``.``, ``:`` or ``?``; the strict entries also carry the sections or
field names they list). Stdlib ``ast`` only; the package is not
imported.

The reference's lists are kept whole: each of its modules and strict
entries has its counterpart in the port, so none is dropped.

Exit status 0 = clean; 1 = violations (one line each on stderr).
"""
from __future__ import annotations

import pathlib
import sys

SCRIPTS = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(SCRIPTS))

import check_docstrings as base  # noqa: E402

CORE = "src/repro_torch/core"
API = "src/repro_torch/api"

MODULES = [m.replace(base.CORE, CORE).replace(base.API, API)
           for m in base.MODULES]
STRICT = dict(base.STRICT)


def main() -> int:
    """Run the reference's checker over the port's modules."""
    base.MODULES = MODULES
    base.STRICT = STRICT
    return base.main()


if __name__ == "__main__":
    raise SystemExit(main())
