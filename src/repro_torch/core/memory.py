"""Memory models of the Coexecutor Runtime (paper §3.1, Fig. 2b).

Two strategies, selectable per launch (and combinable — each buffer is
governed by its own model, as in the paper):

* ``USM``     — one logical allocation shared by all Coexecution Units.
                In the port this is one host allocation per array. Every
                unit writes the output in place (the CPU through
                ``torch.from_numpy``, the GPU through mapped page-locked
                memory), so result collection is free; the CPU reads the
                inputs in place, the GPU from copies in its own memory
                (each package's rows, a broadcast input once a launch).
* ``BUFFERS`` — per-package disjoint buffers: inputs are staged to the unit
                (a copy of the slice to the unit) and outputs copied back into
                the host container. Costs one H2D + one D2H proportional to
                the package bytes, plus a fixed submission overhead.

Two layers consume the model selection:

* the **cost model** below drives the discrete-event simulator (paper
  reproduction) — the defaults calibrated to the paper's platform (Kaby
  Lake iGPU sharing LLC/DRAM with the CPU), ``H100_MEMORY_COSTS``
  measured on the port's card host;
* the **real data plane** (:mod:`repro_torch.core.dataplane`) implements the
  semantics on the live engine: ``MemoryModel.USM`` selects zero-copy
  shared-array movement with in-place collection, ``MemoryModel.BUFFERS``
  per-package staging copies and copy-back, both instrumented
  with copy/dispatch counters surfaced in launch stats.
"""
from __future__ import annotations

import dataclasses
import enum


class MemoryModel(enum.Enum):
    """Package data-movement strategy (paper §3.1): USM or Buffers.

    The enum selects both the DES cost model (:class:`MemoryCosts`) and
    the real engine's data plane
    (:func:`repro_torch.core.dataplane.make_plane`).
    """

    USM = "usm"
    BUFFERS = "buffers"


@dataclasses.dataclass(frozen=True)
class MemoryCosts:
    """Per-package data-movement cost parameters (seconds, bytes/second)."""

    # fixed host-side cost to emit one package. For BUFFERS this includes
    # SYCL buffer + accessor re-creation and DAG node insertion per package
    # (the dominant cost the paper observes for "Gaussian with Buffers" at
    # 200 packages); for USM only a queue submit is paid.
    submit_overhead_s: float = 250e-6
    buffer_submit_overhead_s: float = 15e-3
    # staging bandwidth for the BUFFERS model (effective SYCL buffer copy
    # bandwidth incl. first-touch paging; H2D and D2H assumed symmetric)
    copy_bw_Bps: float = 2e9
    # USM collection: pointer handoff + cacheline ping, effectively flat
    usm_collect_s: float = 50e-6
    buffer_collect_overhead_s: float = 6e-3
    # LLC/DRAM contention: dimensionless slowdown per byte of *simultaneous*
    # working set beyond the LLC capacity — reproduces the paper's MatMul
    # Fig. 8 observation (co-execution degrades to GPU-only for very large
    # matrices because the iGPU thrashes the shared LLC).
    llc_bytes: float = 6 * 2**20
    contention_per_B: float = 3.0e-10

    def launch_cost(self, model: MemoryModel, in_bytes: int) -> float:
        """Host-side cost to issue one package with `in_bytes` of inputs."""
        if model is MemoryModel.USM:
            return self.submit_overhead_s
        return self.buffer_submit_overhead_s + in_bytes / self.copy_bw_Bps

    def collect_cost(self, model: MemoryModel, out_bytes: int) -> float:
        """Host-side cost to collect one package's `out_bytes` of outputs."""
        if model is MemoryModel.USM:
            return self.usm_collect_s
        return self.buffer_collect_overhead_s + out_bytes / self.copy_bw_Bps

    def contention_penalty(self, working_set_bytes: float) -> float:
        """Multiplicative slowdown applied while >1 unit is busy and the
        combined working set spills the shared LLC."""
        spill = max(0.0, working_set_bytes - self.llc_bytes)
        return 1.0 + spill * self.contention_per_B


# The card's host, measured by chip_smoke.py phase 13 on "NVIDIA H100
# 80GB HBM3, 700.00 W" (its nvidia-smi name and power limit). A package's
# fixed cost is an empty (64-item) one's submit plus its fixed busy time
# on cuda:0 while the CPU unit computes, as it does in a pair, the medians
# of 30 (USM 231.5 + 250.4 us, BUFFERS 404.4 + 270.8 us); a SimUnit's
# speed excludes the fixed busy time of a package alone. Collections are
# the median mapped read-back of phase 4's USM cuda:0 packages and an
# empty BUFFERS package's copy back; the copy rate a pinned 256 MiB
# host-to-device copy's; the LLC the host's, from /proc/cpuinfo (the
# host's container hides sysfs's cache tree). A discrete card shares no
# cache with the host: no contention term.
H100_MEMORY_COSTS = MemoryCosts(
    submit_overhead_s=481.8e-6,
    buffer_submit_overhead_s=675.2e-6,
    copy_bw_Bps=52.17e9,
    usm_collect_s=5.61e-6,
    buffer_collect_overhead_s=39.4e-6,
    llc_bytes=8 * 2**20,
    contention_per_B=0.0,
)
