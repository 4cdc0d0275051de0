"""The check fails what it must: the control (the plain reference in the
program's place, in the precision below the configuration's) and the
timed path broken underneath, each through a whole run on the CPU.

A system that exposes ``build_kernel()`` (the co-execution runtime) is
broken in its kernel's body; any other is broken in the output its
launch's handle returns, through the same three faults."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from conftest import ROOT, cell_names, cpu_devices, run_small, small_cell

CELLS = cell_names()


def program_system(fault):
    """A system whose timed path is broken by ``fault``: the cell's own
    system (``systems/<system>.py``) with its kernel wrapped where it
    exposes ``build_kernel()``, else with each launch's output broken."""
    def make(cell, inputs, total, device):
        return _faulty(cell.system().System, fault)(cell, inputs, total,
                                                    cpu_devices(cell))

    return make


def broken_output(out, fault):
    """A launch's output broken by ``fault`` (NumPy or torch): the
    launch's index space lies on axis 0.

    ``unchanged`` is a fresh output never written, zero as fresh pages
    read (an empty one may reuse the block of an earlier launch's output,
    which holds the right answer); ``half`` leaves out the second half of
    the index space; ``altered`` moves one value by 0.01.
    """
    if fault == "unchanged":
        return out.new_zeros(out.shape) if isinstance(out, torch.Tensor) \
            else np.zeros_like(out)
    if fault == "half":
        out[out.shape[0] // 2:] = 0
    elif fault == "altered":
        out[(0,) * out.ndim] += 0.01
    return out


class _BrokenHandle:
    """A launch's handle whose ``result()`` is broken by ``fault``."""

    def __init__(self, handle, fault):
        self._handle = handle
        self._fault = fault

    @property
    def stats(self):
        return self._handle.stats

    def result(self, timeout=None):
        return broken_output(self._handle.result(timeout=timeout),
                             self._fault)


def _faulty(base, fault):
    if not hasattr(base, "build_kernel"):
        class FaultyOutput(base):
            def submit(self, client):
                return _BrokenHandle(super().submit(client), fault)

        return FaultyOutput

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
def test_the_control_is_not_correct(name, root=ROOT):
    from bench.harness.control_system import ControlSystem

    precision = small_cell(name, root).module("reference").CONTROL
    res = run_small(name, root=root,
                    make_system=lambda c, i, n, d: ControlSystem(
                        c, i, d, precision))
    assert res["attempted"] > 0 and res["failed"] == 0
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(name, fault, root=ROOT):
    res = run_small(name, make_system=program_system(fault), root=root)
    assert res["attempted"] > 0
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_the_f32_reference_in_the_programs_place_is_correct(name, root=ROOT):
    """The comparison itself: the reference against itself reads 0."""
    from bench.harness.control_system import ControlSystem

    res = run_small(name, root=root,
                    make_system=lambda c, i, n, d: ControlSystem(
                        c, i, d, "f32"))
    assert res["correct"]
    assert all(c["value"] == 0.0 for c in res["checks"].values())
