"""Shared pieces of the benchmark's tests.

``python -m pytest bench/tests`` runs them from the root of the checkout.
Tests marked ``cuda`` need a CUDA card: the ``cuda_card`` fixture skips
them elsewhere (the decision is made when the fixture runs, never while
a module is imported).
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skipped without one)")


@pytest.fixture
def cuda_card():
    """Skip unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch.cuda.is_available() is false")
    return "cuda"


def benchmark(root: pathlib.Path = ROOT) -> dict:
    """``BENCHMARK.json`` of the checkout at ``root``."""
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_names(root: pathlib.Path = ROOT) -> list:
    """Every cell of ``BENCHMARK.json``."""
    return [w["name"] for w in benchmark(root)["workloads"]]


def small_cell(name: str, root: pathlib.Path = ROOT):
    """The cell ``name`` with its configuration cut to the size its file
    gives a test run (``test_size``, which may also set ``dtype`` and a
    ``check`` no looser than the card's); every other key as run."""
    from bench.harness import spec

    cell = spec.load_cell(name, root)
    cell.config.update(cell.config["test_size"])
    return cell


def cpu_devices(cell) -> list:
    """The mix's units, each on the CPU."""
    return ["cpu"] * len(cell.traffic["units"])


def run_small(name: str, *, trace: bool = False, seed: int = 2**31 + 7,
              devices=None, make_system=None, seconds: float = 0.3,
              root: pathlib.Path = ROOT):
    """One run of the cell at its small size (on the CPU by default)."""
    from bench.harness import runner

    cell = small_cell(name, root)
    return runner.run(cell, seed, seconds, trace,
                      setup_t0=time.perf_counter(),
                      devices=devices or cpu_devices(cell),
                      make_system=make_system)
