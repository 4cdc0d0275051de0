"""The check that decides ``correct``: the timed path's outputs against the
plain reference, after the window.

Every output the window kept (a sample of each client's launches, drawn
from the seed) is compared whole, as the launch assembled it from every
unit's packages, with the reference for that client's inputs. The
reference runs once a client, on the device the check runs on, after the
program's state is freed. Each number the configuration's ``check``
names is the worst over the compared outputs, held to its limit there.
"""
from __future__ import annotations

import math
from typing import Optional


def compare(cell, inputs: list, kept: dict, device: str) -> tuple[dict, int]:
    """The checked numbers and how many outputs were compared.

    Returns:
        ``({name: {"value": worst or None, "limit": limit}}, compared)``.
    """
    ref_mod = cell.module("reference")
    worst: dict = {}
    compared = 0
    for client, outs in sorted(kept.items()):
        if not outs:
            continue
        ref = ref_mod.reference(inputs[client], device)
        for out in outs:
            for name, value in ref_mod.compare(out, ref).items():
                worst[name] = max(worst.get(name, 0.0), float(value))
            compared += 1
        del ref
    limits = cell.config["check"]
    return {name: {"value": _finite(worst.get(name)), "limit": limit}
            for name, limit in limits.items()}, compared


def _finite(value: Optional[float]) -> Optional[float]:
    """JSON has no infinity: a gap that is not finite reads 1e300."""
    if value is None or math.isfinite(value):
        return value
    return 1e300


def passed(checks: dict) -> bool:
    """Every number read and within its limit (a missing one fails)."""
    return all(c["value"] is not None and c["limit"] is not None
               and c["value"] <= c["limit"] for c in checks.values())


def lines(checks: dict) -> list:
    """One line a number: its name, value and limit."""
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in checks.items()]
