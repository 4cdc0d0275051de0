"""A whole run of every cell on the CPU at a small size: the same harness
the card runs, with the units on the CPU."""
from __future__ import annotations

import subprocess
import sys

import pytest

from conftest import ROOT, cell_names, run_small

CELLS = cell_names()


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_is_correct_and_reports_its_metrics(name, trace):
    from conftest import small_cell

    res = run_small(name, trace=bool(trace))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= len(
        small_cell(name).traffic["units"])
    assert list(res)[-2:] == ["checks", "_diagnostics"]
    if not trace:
        assert set(res["metrics"]) == {"items_per_s", "setup_s"}
    else:
        # CPU units: no device trace, no peaks; the host's counters read
        assert {"launch_overhead_ms", "host_overhead_frac"} <= set(
            res["metrics"])
        assert "device_idle_frac" not in res["metrics"]
    for m in res["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_every_kept_output_is_compared(name):
    from conftest import small_cell

    mix = small_cell(name).traffic
    one = run_small(name, seed=11)
    assert one["_diagnostics"]["compared"] == (mix["clients"]
                                               * mix["compared_per_client"])


def test_run_exits_2_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         cell_names()[0], "--seed", str(2**31 + 1), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "cuda" in proc.stderr.lower()
