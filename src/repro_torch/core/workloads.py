"""The paper's six benchmarks: Table 1 parameters and profile names.

The Table 1 rows (work-items, local work size, memory footprint, ...) and
the device calibration are copied from the reference; the real engine's
full-size runs take their problem sizes from here. The discrete-event
profiles built on them (``paper_workload``) wait for the DES slice
(ROADMAP queue 1, item 7): the names register so specs validate exactly
as in the reference, and building one raises.
"""
from __future__ import annotations

import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class BenchSpec:
    """Table 1 row + device calibration (see the reference for the model)."""

    name: str
    work_items: int            # Table 1 (N x 1e5)
    local_work_size: int       # Table 1
    mem_mib: float             # Table 1
    read_write: tuple[int, int]  # Table 1 read:write buffers
    uses_local_mem: bool       # Table 1
    capacity_ratio: float      # GPU/CPU at cache-resident sizes
    bw_ratio: float            # GPU/CPU once DRAM-bandwidth-bound
    gpu_alpha: float           # divergence exponent of the iGPU
    irregular: bool

    @property
    def groups(self) -> int:
        return max(1, self.work_items // self.local_work_size)


SPECS: dict[str, BenchSpec] = {
    "gaussian": BenchSpec("gaussian", 262 * 10**5, 128, 195.0, (2, 1), False,
                          capacity_ratio=13.5, bw_ratio=2.0,
                          gpu_alpha=1.0, irregular=False),
    "matmul": BenchSpec("matmul", 237 * 10**5, 64, 264.0, (2, 1), True,
                        capacity_ratio=3.3, bw_ratio=1.75,
                        gpu_alpha=1.0, irregular=False),
    "taylor": BenchSpec("taylor", 10 * 10**5, 64, 46.0, (3, 2), True,
                        capacity_ratio=1.05, bw_ratio=1.05,
                        gpu_alpha=1.0, irregular=False),
    "ray": BenchSpec("ray", 94 * 10**5, 128, 35.0, (1, 1), True,
                     capacity_ratio=4.6, bw_ratio=4.6,
                     gpu_alpha=2.0, irregular=True),
    "rap": BenchSpec("rap", 5 * 10**5, 128, 6.0, (2, 1), False,
                     capacity_ratio=0.685, bw_ratio=0.685,
                     gpu_alpha=1.1, irregular=True),
    "mandelbrot": BenchSpec("mandelbrot", 703 * 10**5, 256, 1072.0, (0, 1),
                            False, capacity_ratio=4.8, bw_ratio=4.8,
                            gpu_alpha=1.5, irregular=True),
}

REGULAR = ("gaussian", "matmul", "taylor")
IRREGULAR = ("mandelbrot", "rap", "ray")
ALL_BENCHMARKS = REGULAR + IRREGULAR


def paper_workload(name: str, *, size_scale: float = 1.0):
    """Build one registered DES workload profile (not ported yet).

    Raises:
        KeyError: unknown profile name.
        NotImplementedError: for every built-in profile, until the DES
            slice lands (ROADMAP queue 1, item 7).
    """
    from repro_torch.api.registry import build_workload

    return build_workload(name, size_scale=size_scale)


def _des_profile(name: str, *, size_scale: float = 1.0):
    raise NotImplementedError(
        f"the DES profile {name!r} needs the simulator, which is not ported "
        f"to torch yet (ROADMAP queue 1, item 7)")


def _register_builtin_workloads() -> None:
    """Idempotently register the paper's six profile names (import side)."""
    from repro_torch.api.registry import register_workload

    for bench in ALL_BENCHMARKS:
        register_workload(bench, functools.partial(_des_profile, bench),
                          fields=("size_scale",), overwrite=True)


_register_builtin_workloads()
