"""One run of one cell: set-up, the window, the check, the metrics.

Set-up makes each client's inputs from the seed, builds the system under
test (``systems/<system>.py``, by the configuration) and warms it with one
launch a client; ``setup_s`` runs from
the process's start to the window's. With ``trace`` the window runs under
the device profiler and the cell's per-layer metrics are read; without,
its end-to-end metrics. The check runs after the window, once the peak
of device memory has been read and the program is stopped.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional, Sequence

from . import check, loop, spec
from .trace import Tracer


@dataclasses.dataclass
class RunRecord:
    """What a metric's reader reads."""

    cell: spec.Cell
    setup_s: float
    window: loop.Window
    units: list            # [(name, device type)] in the runtime's order
    inputs: list
    total: int
    device: str            # where counts and the reference run
    peaks: Optional[dict]  # the device's peak rates, if listed
    trace: object = None   # a DeviceTrace with --trace 1
    _counters: dict = dataclasses.field(default_factory=dict)

    @property
    def work(self):
        """The configuration's kernel's work module."""
        return self.cell.module("work")

    def counter(self, client: int):
        """The work counter of one client's inputs (made once)."""
        if client not in self._counters:
            self._counters[client] = self.work.Counter(self.inputs[client],
                                                       self.device)
        return self._counters[client]

    def unit_kind(self, index: int) -> str:
        """``cuda`` or ``cpu``: the device type of the unit at ``index``."""
        return self.units[index][1]

    def bound_s(self, ops: int, nbytes: int) -> Optional[float]:
        """Least seconds the device could take: the roofline's bound."""
        if self.peaks is None:
            return None
        return max(ops / self.peaks[self.work.PEAK],
                   nbytes / self.peaks["hbm_bytes_per_s"])

    def host_spans(self) -> list:
        """``(kind, start, end)`` of the host's activity in the window:
        each client's submit (plan, admission) and wait, and the CPU
        unit's packages."""
        spans = []
        for r in self.window.records:
            spans.append(("submit", r.t_submit, r.t_handed))
            if r.ok:
                spans.append(("wait", r.t_handed, r.t_done))
            for p in getattr(r.stats, "packages", ()):
                if self.unit_kind(p.unit) == "cpu":
                    spans.append(("cpu package", p.t_launch, p.t_complete))
        return spans


def read_metrics(record: RunRecord, entries: list) -> dict:
    """Each metric's reader on the record; a reader that finds nothing to
    read returns ``None`` and the metric is left out."""
    out = {}
    for entry in entries:
        value = spec.reader(record.cell, entry["name"]).read(record)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
        setup_t0: float, devices: Optional[Sequence[str]] = None,
        make_system: Optional[Callable] = None) -> dict:
    """Run the cell once.

    Args:
        cell: the cell.
        seed: inputs and the check's sample are drawn from it.
        seconds: the window's length (the last launches then return).
        trace: read the per-layer metrics under the device profiler.
        setup_t0: ``perf_counter`` at the process's start.
        devices: the units' devices (default the mix's); the CPU tests
            give CPU units, and then everything runs on the CPU.
        make_system: ``(cell, inputs, total, device) -> system`` in place
            of the program (the control, or a planted fault).

    Returns:
        The result: ``correct``, ``attempted``, ``failed``, ``metrics``,
        ``device``, with ``trace`` ``breakdown``, then ``checks``.
    """
    import torch

    mix = cell.traffic
    devices = list(devices or mix["units"])
    on_card = any(d.startswith("cuda") for d in devices)
    device = "cuda" if on_card else "cpu"
    clients = int(mix["clients"])
    total = cell.module("inputs").total(cell.config)
    phases = {"imports": time.perf_counter() - setup_t0}
    t = time.perf_counter()
    inputs = cell.module("inputs").make(cell.config, clients, seed, device)
    phases["inputs"] = time.perf_counter() - t
    if make_system is None:
        system = cell.system().System(cell, inputs, total, devices)
    else:
        system = make_system(cell, inputs, total, device)
    tracer = Tracer() if trace and on_card else None
    try:
        t = time.perf_counter()
        system.start()
        phases["start"] = time.perf_counter() - t
        t = time.perf_counter()
        loop.warm_up(system, clients)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        phases["warm_up"] = time.perf_counter() - t
        setup_s = time.perf_counter() - setup_t0
        keep = int(mix["compared_per_client"])
        if tracer is not None:
            with tracer:
                window = loop.run_window(system, clients, seconds, keep, seed)
                torch.cuda.synchronize()
        else:
            window = loop.run_window(system, clients, seconds, keep, seed)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        units = list(system.unit_kinds().items())
        dist = getattr(system, "dist", None)
    finally:
        system.close()
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, compared = check.compare(cell, inputs, window.kept, device)
    failed = len(window.records) - len(window.ok)
    record = RunRecord(
        cell=cell, setup_s=setup_s, window=window, units=units, inputs=inputs,
        total=total, device=device,
        peaks=spec.peaks(torch.cuda.get_device_name(0)) if on_card else None,
        trace=tracer.trace(window.t_start, window.t_end) if tracer else None)
    metrics = read_metrics(record,
                           cell.per_layer if trace else cell.end_to_end)
    result = {
        "correct": bool(check.passed(checks) and failed == 0 and compared > 0),
        "attempted": len(window.records),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips if on_card else 0,
                   "memory_peak_bytes": int(peak)},
    }
    if record.trace is not None:
        result["device"]["busy_s"] = record.trace.busy_s
        result["device"]["window_s"] = record.trace.window_s
        result["breakdown"] = {
            "device_ops": record.trace.top_ops(),
            "idle_gaps": record.trace.idle_gaps(record.host_spans())}
    result["checks"] = checks
    result["_diagnostics"] = {
        "compared": compared,
        "errors": sorted({r.error for r in window.records if not r.ok}),
        "trace_kinds": dict(tracer.kinds) if tracer else {},
        "window_s": window.seconds,
        "dist": list(dist) if dist else None,
        "setup_phases_s": phases,
    }
    return result
