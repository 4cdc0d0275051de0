#!/usr/bin/env python3
"""Public-API snapshot checker for the port: `repro_torch.analysis`,
`repro_torch.api` and `repro_torch.core`.

The port's counterpart of ``scripts/check_api.py``, which it runs with
its two roots swapped: every exported name (``__all__``) of the three
packages, the signatures of exported callables and the public methods of
exported classes, diffed against ``scripts/torch_api_snapshot.txt``. A
rename, a signature change or a dropped export fails the check (and the
tier-1 tests, via tests/test_torch_docs.py).

    python scripts/torch_check_api.py            # verify (exit 1 on drift)
    python scripts/torch_check_api.py --update   # rewrite the snapshot

The reference's messages name its own command; on drift this script
prints the port's after them.
"""
from __future__ import annotations

import pathlib
import sys

SCRIPTS = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(SCRIPTS))

import check_api as base  # noqa: E402

base.SNAPSHOT = SNAPSHOT = SCRIPTS / "torch_api_snapshot.txt"
base.MODULES = MODULES = ("repro_torch.analysis", "repro_torch.api",
                          "repro_torch.core")


def main(argv: list[str]) -> int:
    """Verify or update the snapshot; returns the process exit code."""
    rc = base.main(argv)
    if rc:
        print("(for the port's snapshot: python scripts/torch_check_api.py "
              "--update)", file=sys.stderr)
    return rc


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
