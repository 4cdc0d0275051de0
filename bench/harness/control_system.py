"""The control: the plain reference in the program's place.

A system has ``start()``, ``submit(client) -> handle`` (the handle's
``result()`` is the output, its ``stats`` the launch's ``LaunchStats`` or
``None``), ``unit_kinds()`` and ``close()``. The program's system is
``systems/<name>.py`` by the configuration's ``system``; this one stands
in its place when the control is read.
"""
from __future__ import annotations

import threading


class _Done:
    """A finished launch's handle: its output and no stats."""

    stats = None

    def __init__(self, out):
        self._out = out

    def result(self, timeout=None):
        return self._out


class ControlSystem:
    """The plain reference in the program's place, in a lower precision.

    Each launch is the reference for the client's inputs computed in
    ``precision`` on ``device`` and copied to a fresh host array: what
    the comparison must reject.
    """

    def __init__(self, cell, inputs: list, device: str, precision: str):
        self.cell = cell
        self.inputs = inputs
        self.device = device
        self.precision = precision
        self.reference = cell.module("reference")
        # one at a time: a precision may be a process-wide switch (TF32)
        self._lock = threading.Lock()

    def start(self) -> None:
        """Nothing to build."""

    def submit(self, client: int):
        """The control's output for the client, as a finished handle."""
        with self._lock:
            out = self.reference.reference(self.inputs[client], self.device,
                                           self.precision)
            return _Done(out.cpu().numpy())

    def unit_kinds(self) -> dict:
        """The control runs on no unit of the program."""
        return {}

    def close(self) -> None:
        """Nothing to stop."""
