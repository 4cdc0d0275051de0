"""Coexecutor Runtime on torch.

Public surface:
    CoexecutorRuntime, counits_from_devices     — real co-execution (Listing 1)
                                                  on [cuda:0, cpu]
    CoexecEngine, LaunchHandle, LaunchStats     — persistent engine
    ExecutionLoop, LaunchState                  — the shared control plane
    AdmissionConfig, AdmissionController, ...   — FIFO/WFQ/EDF admission,
                                                  preemption, shedding
    Static / Dynamic / HGuided / WorkStealing   — load balancers (§3.2)
    MemoryModel, MemoryCosts                    — USM vs Buffers (§3.1)
    CoexecKernel, ArgSpec, ArgRole, OutputSpec  — typed kernel protocol
    DataPlaneCounters, make_plane               — USM/BUFFERS data planes
    TorchUnit                                   — a unit on one torch device
    SPECS, ALL_BENCHMARKS                       — Table 1 rows

``repro_torch.core.director.Director`` is the blocking facade over the
engine, as in the reference (imported from its module).

The DES, traffic, cluster and energy tiers wait for later slices.
"""
from .admission import (ADMISSION_POLICIES, AdmissionConfig,
                        AdmissionController, AdmissionFull, LaunchShed,
                        fusion_bucket, jain_index, service_fairness_curve)
from .dataplane import (ArgRole, ArgSpec, CoexecKernel, DataPlaneCounters,
                        HaloChunk, OutputSpec, as_coexec_kernel, make_plane)
from .engine import (CoexecEngine, LaunchHandle, LaunchStats,
                     LaunchWaitTimeout)
from .exec import ExecutionLoop, LaunchState
from .memory import MemoryCosts, MemoryModel
from .package import Package, Range, validate_cover
from .profiler import EwmaThroughput, SpeedBoard
from .runtime import CoexecutorRuntime, counits_from_devices
from .scheduler import (SPEED_HINT_POLICIES, DynamicScheduler,
                        HGuidedScheduler, Scheduler, StaticScheduler,
                        WorkStealingScheduler, static_bounds)
from .units import TorchUnit
from .workloads import ALL_BENCHMARKS, IRREGULAR, REGULAR, SPECS

__all__ = [
    "ADMISSION_POLICIES", "ALL_BENCHMARKS", "AdmissionConfig",
    "AdmissionController", "AdmissionFull", "ArgRole", "ArgSpec",
    "CoexecEngine", "CoexecKernel", "CoexecutorRuntime",
    "DataPlaneCounters", "DynamicScheduler", "EwmaThroughput",
    "ExecutionLoop", "HGuidedScheduler", "HaloChunk", "IRREGULAR",
    "LaunchHandle", "LaunchShed", "LaunchState", "LaunchStats",
    "LaunchWaitTimeout", "MemoryCosts", "MemoryModel", "OutputSpec",
    "Package", "REGULAR", "Range", "SPECS", "SPEED_HINT_POLICIES",
    "Scheduler", "SpeedBoard", "StaticScheduler", "TorchUnit",
    "WorkStealingScheduler", "as_coexec_kernel", "counits_from_devices",
    "fusion_bucket", "jain_index", "make_plane", "service_fairness_curve",
    "static_bounds", "validate_cover",
]
