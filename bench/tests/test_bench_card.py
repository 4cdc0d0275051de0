"""On the card: every cell at a small size through the port's CUDA unit,
the control and a broken timed path. Skipped without a CUDA card.

    python -m pytest -q -m cuda bench/tests
"""
from __future__ import annotations


import pytest

from conftest import cell_names, run_small, small_cell

CELLS = cell_names()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_on_the_card_is_correct(cuda_card, name):
    res = run_small(name, devices=small_cell(name).traffic["units"],
                    trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_on_the_card_is_not_correct(cuda_card, name):
    from bench.harness.control_system import ControlSystem

    precision = small_cell(name).module("reference").CONTROL
    res = run_small(name, devices=small_cell(name).traffic["units"],
                    make_system=lambda c, i, n, d: ControlSystem(
                        c, i, d, precision))
    assert not res["correct"]
