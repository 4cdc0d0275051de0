"""The check fails what it must: the control (the plain reference in the
program's place, in the precision below the configuration's) and the
timed path broken underneath, each through a whole run on the CPU."""
from __future__ import annotations

import dataclasses

import pytest

from conftest import cell_names, cpu_devices, run_small, small_cell

CELLS = cell_names()


def program_system(fault):
    """A system whose kernel body is broken by ``fault``: the cell's own
    system (``systems/<system>.py``) with its kernel wrapped."""
    def make(cell, inputs, total, device):
        return _faulty(cell.system().System, fault)(cell, inputs, total,
                                                    cpu_devices(cell))

    return make


def _faulty(base, fault):
    class Faulty(base):
        def build_kernel(self):
            kernel = super().build_kernel()
            body = kernel.fn

            def broken(offset, *chunks, out):
                if fault == "unchanged":          # returns its output as is
                    return out
                res = body(offset, *chunks, out=out)
                if fault == "half":               # half the rows left out
                    res[res.shape[0] // 2:] = 0
                elif fault == "altered":          # one answer altered
                    res.view(-1)[0] += 0.01
                return res

            return dataclasses.replace(kernel, fn=broken)

    return Faulty


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    from bench.harness.control_system import ControlSystem

    precision = small_cell(name).module("reference").CONTROL
    res = run_small(name, make_system=lambda c, i, n, d: ControlSystem(
        c, i, d, precision))
    assert res["attempted"] > 0 and res["failed"] == 0
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(name, fault):
    res = run_small(name, make_system=program_system(fault))
    assert res["attempted"] > 0
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_the_f32_reference_in_the_programs_place_is_correct(name):
    """The comparison itself: the reference against itself reads 0."""
    from bench.harness.control_system import ControlSystem

    res = run_small(name, make_system=lambda c, i, n, d: ControlSystem(
        c, i, d, "f32"))
    assert res["correct"]
    assert all(c["value"] == 0.0 for c in res["checks"].values())
