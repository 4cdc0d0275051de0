"""A system that is not the co-execution runtime: the planted two-layer
model in plain PyTorch, one batch of requests a launch, served by one
worker thread in submission order.

``submit`` returns a handle whose ``result()`` is the launch's logits
(the batch's requests on axis 0) and whose ``stats`` carry
``timeline()``: the root ``launch`` and its ``hidden`` and ``logits``
spans, on ``time.perf_counter``.
"""
from __future__ import annotations

import concurrent.futures
import itertools
import time
from typing import Optional, Sequence

import torch


class _Stats:
    """A launch's spans, the root first."""

    def __init__(self, spans: list):
        self.spans = spans

    def timeline(self) -> list:
        return list(self.spans)


class _Handle:
    """One launch: ``result()`` waits for its logits, then ``stats``."""

    def __init__(self, future):
        self._future = future
        self.stats = None

    def result(self, timeout=None):
        out, self.stats = self._future.result(timeout=timeout)
        return out


def _settled(t: torch.Tensor) -> float:
    """The clock once the device has finished ``t``."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


class System:
    """The planted model serving one cell's launches.

    Args:
        cell: the cell.
        inputs: one input set a client (the shared weights and the
            client's batch, on the device they were made on).
        total: a launch's index space (the batch).
        devices: the one unit's device; default the mix's ``units``.
    """

    def __init__(self, cell, inputs: list, total: int,
                 devices: Optional[Sequence[str]] = None):
        self.inputs = inputs
        self.total = int(total)
        self.devices = list(devices or cell.traffic["units"])
        self._pool = None
        self._ids = itertools.count()

    def start(self) -> None:
        """Start the worker."""
        self._pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="batched-model")

    def _serve(self, launch: int, client: int):
        from repro_torch.core import Span

        inputs = self.inputs[client]
        w = inputs["weights"]
        t0 = time.perf_counter()
        h = torch.nn.functional.gelu(inputs["x"] @ w["w1"])
        t1 = _settled(h)
        logits = (h @ w["w2"]).float()
        t2 = _settled(logits)
        return logits, _Stats([Span("launch", launch, None, t0, t2),
                               Span("hidden", launch, "launch", t0, t1),
                               Span("logits", launch, "launch", t1, t2)])

    def submit(self, client: int) -> _Handle:
        """One launch of the client's batch; its handle."""
        return _Handle(self._pool.submit(self._serve, next(self._ids),
                                         client))

    def unit_kinds(self) -> dict:
        """Unit name -> device type."""
        return {d: torch.device(d).type for d in self.devices}

    def close(self) -> None:
        """Finish what was submitted and stop the worker."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
