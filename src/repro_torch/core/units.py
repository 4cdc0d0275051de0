"""Coexecution Units (paper Fig. 2a) on torch devices.

A *Coexecution Unit* owns one execution resource and a management thread
that talks to the Commander loop. :class:`TorchUnit` is the real substrate:
it owns an explicit :class:`torch.device` and, on CUDA, its own
:class:`torch.cuda.Stream`, on which every package of the unit is staged,
launched and copied back; completion is a CUDA event recorded after the
launch. The CPU unit runs the kernels' plain PyTorch versions
synchronously. How chunks reach the unit (in-place USM views vs staged
per-package buffers) is decided by the data plane
(:mod:`repro_torch.core.dataplane`), which drives :meth:`TorchUnit.dispatch`.

The discrete-event ``SimUnit`` of the reference waits for the DES slice.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Sequence

import torch

from .dataplane import Pending


class TorchUnit:
    """A real Coexecution Unit backed by one torch device.

    Args:
        name: display name (the key of per-unit launch stats).
        device: the unit's device (``"cuda:0"``, ``"cpu"``, ...).
        kind: energy-model class (``"gpu"`` / ``"cpu"``).
        speed_hint: relative throughput hint for adaptive schedulers.
    """

    def __init__(self, name: str, device, *, kind: str = "cpu",
                 speed_hint: float = 1.0):
        self.name = name
        self.kind = kind
        self.device = torch.device(device)
        self.speed_hint = float(speed_hint)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.busy_s = 0.0  # guarded-by: _lock
        self._warm: set = set()  # guarded-by: _lock
        self._lock = threading.Lock()

    def stream_context(self):
        """Make the unit's stream current in this thread (CPU: no-op).

        The current stream is per thread, so every thread that stages,
        launches or completes packages on the unit enters this.
        """
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # -- execution ---------------------------------------------------------
    def dispatch(self, fn: Callable, offset: int, args: Sequence[Any],
                 out) -> Pending:
        """Launch ``fn(offset, *args, out=out)`` on this unit.

        On CUDA the kernel is queued on the unit's stream and a
        :class:`torch.cuda.Event` is recorded right after it, so
        :meth:`~repro_torch.core.dataplane.DataPlane.complete` waits on
        this package alone. The kernel sees the real offset for
        index-dependent work.

        Returns:
            The in-flight :class:`~repro_torch.core.dataplane.Pending`.
        """
        with self.stream_context():
            result = fn(offset, *args, out=out)
            event = None
            if self.stream is not None:
                event = torch.cuda.Event()
                event.record(self.stream)
        return Pending(result, out, event)

    def is_warm(self, kernel) -> bool:
        """Whether :meth:`mark_warm` ran for this kernel on this unit."""
        with self._lock:
            return kernel in self._warm

    def mark_warm(self, kernel) -> None:
        """Record that the kernel's one-time load happened on this unit."""
        with self._lock:
            self._warm.add(kernel)

    def add_busy(self, seconds: float) -> None:
        """Account dispatch-to-completion time against this unit."""
        with self._lock:
            self.busy_s += seconds
