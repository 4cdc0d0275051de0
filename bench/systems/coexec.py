"""The port's co-execution runtime, built as the cell's mix says.

The window drives the paper's entry: a ``repro_torch.api.CoexecSpec``
(units, policy, memory), ``CoexecutorRuntime.from_spec(spec, units=...)``
and ``launch_async(n, kernel, inputs)`` with
``kernel = repro_torch.api.build_kernel(name)``. Nothing else of the
program is called, but ``repro_torch.launch.serve.measured_dist`` in
set-up, for the speed shares of a pair (more than one unit).

A configuration names this file by its ``system`` key (``coexec``).
"""
from __future__ import annotations

from typing import Optional, Sequence


class System:
    """The port's co-execution runtime serving one cell's launches.

    Args:
        cell: the cell (its configuration and traffic mix).
        inputs: one input set a client (host arrays).
        total: a launch's index space.
        devices: the units' devices; default the mix's ``units``. The CPU
            tests pass ``["cpu", "cpu"]`` for a pair.
    """

    def __init__(self, cell, inputs: list, total: int,
                 devices: Optional[Sequence[str]] = None):
        self.cell = cell
        self.inputs = inputs
        self.total = int(total)
        self.devices = list(devices or cell.traffic["units"])
        self.rt = None
        self.kernel = None
        self.units = []
        self.dist = None

    def build_kernel(self):
        """The registered kernel the configuration names."""
        from repro_torch.api import build_kernel

        return build_kernel(self.cell.kernel)

    def start(self) -> None:
        """Build the units, measure the shares of a pair, start the
        runtime."""
        from repro_torch.api import CoexecSpec
        from repro_torch.core import CoexecutorRuntime, counits_from_devices

        mix = self.cell.traffic
        self.units = counits_from_devices(self.devices)
        self.kernel = self.build_kernel()
        builder = CoexecSpec.builder().policy(mix["policy"]).memory(
            mix["memory"])
        if len(self.units) > 1:
            from repro_torch.launch.serve import measured_dist

            self.dist = measured_dist(self.units, self.kernel,
                                      self.inputs[0], self.total,
                                      mix["memory"])
            builder = builder.dist(*self.dist)
        self.rt = CoexecutorRuntime.from_spec(builder.build(),
                                              units=self.units)

    def submit(self, client: int):
        """One launch of the client's inputs; its handle."""
        return self.rt.launch_async(self.total, self.kernel,
                                    self.inputs[client])

    def unit_kinds(self) -> dict:
        """Unit name -> device type (``cuda`` or ``cpu``)."""
        return {u.name: u.device.type for u in self.units}

    def close(self) -> None:
        """Drain and stop the runtime."""
        if self.rt is not None:
            self.rt.shutdown()
            self.rt = None
