"""Director — blocking-launch compatibility facade over the CoexecEngine.

The paper's Fig. 2a vocabulary: configure the units, run the Commander
protocol over one index space, merge the results. The execution core is
:class:`~.engine.CoexecEngine` (persistent worker threads, multi-tenant
launch queue); the Director is the thin blocking wrapper over it, with
the reference's surface.

The memory-model semantics are the data plane's
(:mod:`repro_torch.core.dataplane`):

* USM     — units compute in place on the shared host arrays (mapped
            page-locked memory on a CUDA unit) and write their slices
            straight into the host output array; no staging copies.
* BUFFERS — each package's inputs are staged into unit buffers and its
            output chunk copied back before the merge (explicit, counted
            copies).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from .engine import CoexecEngine
from .memory import MemoryModel
from .package import Package
from .runtime import counits_from_devices
from .scheduler import Scheduler
from .units import TorchUnit


class Director:
    """Configures units, drives one blocking co-execution at a time.

    Owns a lazily-started persistent engine; repeated ``launch`` calls
    reuse the same worker threads (and the same SpeedBoard, so adaptive
    policies keep their learned speeds across launches).

    Args:
        units: the Coexecution Units; ``None`` is the card's pair,
            [``cuda:0``, ``cpu``] (raises without CUDA).
        memory: the memory model of every launch.
    """

    def __init__(self, units: Optional[Sequence[TorchUnit]] = None, *,
                 memory: MemoryModel = MemoryModel.USM):
        from repro_torch.api.spec import CoexecSpec, MemorySpec

        if units is None:
            units = counits_from_devices()
        self.engine = CoexecEngine(
            units, spec=CoexecSpec(memory=MemorySpec(model=memory.value)))

    @property
    def units(self) -> list[TorchUnit]:
        return self.engine.units

    @property
    def memory(self) -> MemoryModel:
        return self.engine.memory

    @property
    def board(self):
        return self.engine.board

    def launch(self, scheduler: Scheduler, kernel: Callable,
               inputs: Sequence[np.ndarray], out: np.ndarray,
               *, adaptive: bool = True) -> list[Package]:
        """Blocking co-execution of ``kernel`` over the whole index space.

        ``kernel`` is a :class:`~repro_torch.core.dataplane.CoexecKernel`
        or a closure ``kernel(offset, *chunks) -> chunk_out`` on tensors;
        the chunks are staged from ``inputs`` by the engine's data plane
        per the configured memory model (and per the kernel's declared
        argument semantics).

        Returns:
            The packages served, with their units and timestamps.

        Raises:
            BaseException: the first package error of the launch.
        """
        self.engine.start()
        handle = self.engine.submit(scheduler, kernel, inputs, out,
                                    adaptive=adaptive)
        handle.result()          # re-raises the first package error, if any
        return handle.stats.packages

    def shutdown(self) -> None:
        self.engine.shutdown()

    def __enter__(self) -> "Director":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def __del__(self) -> None:
        # stop the (daemon) workers of a dropped Director so per-request
        # Director construction cannot accumulate parked threads
        try:
            engine = self.engine
        except AttributeError:
            return               # __init__ never got to set the engine
        try:
            engine.shutdown(wait=False)
        except RuntimeError:
            pass                 # interpreter teardown: threading gone
        except Exception:
            # anything else is a real bug in the shutdown path — keep it
            # visible instead of silently dropping it (raising from
            # __del__ would only reach sys.unraisablehook)
            import logging

            logging.getLogger(__name__).exception(
                "unexpected error shutting down a dropped Director")
