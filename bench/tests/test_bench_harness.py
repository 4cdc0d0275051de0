"""A whole run of every cell on the CPU at a small size: the same harness
the card runs, with the units on the CPU."""
from __future__ import annotations

import subprocess
import sys

import pytest

from conftest import ROOT, cell_names, run_small

CELLS = cell_names()


def reported_on_the_cpu(cell, trace: bool) -> set:
    """The metrics a CPU run of the cell reports, from the cell's own
    entries in ``BENCHMARK.json`` and their readers: every program span,
    program counter and host-clock metric whose reader does not declare
    ``CPU_READS = False`` (a share of the card's peaks, or a span the CPU
    units never open, each with its reason beside it); none that reads
    the device trace, which is the card's."""
    from bench.harness import spec

    return {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)
            if m["source"] != "device_trace"
            and getattr(spec.reader(cell, m["name"]), "CPU_READS", True)}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_is_correct_and_reports_its_metrics(name, trace, root=ROOT):
    from conftest import small_cell

    cell = small_cell(name, root)
    res = run_small(name, trace=bool(trace), root=root)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= len(
        cell.traffic["units"])
    assert list(res)[-2:] == ["checks", "_diagnostics"]
    reported = reported_on_the_cpu(cell, bool(trace))
    assert reported and set(res["metrics"]) == reported
    for m in res["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_every_kept_output_is_compared(name, root=ROOT):
    from conftest import small_cell

    mix = small_cell(name, root).traffic
    one = run_small(name, seed=11, root=root)
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
