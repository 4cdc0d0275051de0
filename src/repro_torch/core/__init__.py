"""Coexecutor Runtime on torch.

Public surface:
    CoexecutorRuntime, counits_from_devices     — real co-execution (Listing 1)
                                                  on [cuda:0, cpu]
    CoexecEngine, LaunchHandle, LaunchStats     — persistent engine
    ExecutionLoop, LaunchState                  — the shared control plane
                                                  both backends drive
    AdmissionConfig, AdmissionController, ...   — FIFO/WFQ/EDF admission,
                                                  preemption, shedding
    Static / Dynamic / HGuided / WorkStealing   — load balancers (§3.2)
    simulate, solo_run, Workload, SimUnit       — DES reproduction engine
    simulate_multi, LaunchSpec, MultiSimResult  — multi-tenant DES (admission
                                                  policies in virtual time)
    Trace, synthesize_trace, replay_trace_sim   — open-loop traffic and its
                                                  DES / lockstep replays
    MemoryModel, MemoryCosts                    — USM vs Buffers (§3.1)
    CoexecKernel, ArgSpec, ArgRole, OutputSpec  — typed kernel protocol
    DataPlaneCounters, make_plane               — USM/BUFFERS data planes
    TorchUnit                                   — a unit on one torch device
    PowerModel, energy_report, edp_ratio        — energy/EDP model (§5.2)
    paper_workload, SPECS, ALL_BENCHMARKS       — Table 1 profiles
    UnitPool, Supervisor, Autoscaler,
        FailurePlan, replay_trace_cluster       — elastic cluster tier:
                                                  resizable pool, failure
                                                  detection, exact re-issue

``repro_torch.core.director.Director`` is the blocking facade over the
engine, as in the reference (imported from its module).
"""
from .admission import (ADMISSION_POLICIES, AdmissionConfig,
                        AdmissionController, AdmissionFull, LaunchShed,
                        fusion_bucket, jain_index, service_fairness_curve)
from .cluster import (Autoscaler, ClusterRealBackend, ClusterReplay,
                      ClusterSimBackend, FailurePlan, InjectedFailure,
                      Supervisor, UnitPool, absorb_share, grant_share,
                      replay_cluster_lockstep, replay_trace_cluster)
from .dataplane import (ArgRole, ArgSpec, CoexecKernel, DataPlaneCounters,
                        HaloChunk, OutputSpec, as_coexec_kernel, make_plane)
from .energy import (EnergyReport, PowerModel, PAPER_POWER, edp_ratio,
                     energy_report, geomean)
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
from .sim import (LaunchSimResult, LaunchSpec, MultiSimResult, ShedRecord,
                  SimResult, Workload, simulate, simulate_multi, solo_run)
from .traffic import (Arrival, TenantRow, Trace, TrafficReplay,
                      capacity_items_per_s, replay_trace_lockstep,
                      replay_trace_sim, synthesize_trace, tenant_rows)
from .units import SimUnit, TorchUnit
from .workloads import (ALL_BENCHMARKS, IRREGULAR, REGULAR, SPECS,
                        paper_workload)

__all__ = [
    "ADMISSION_POLICIES", "ALL_BENCHMARKS", "AdmissionConfig",
    "AdmissionController", "AdmissionFull", "ArgRole", "ArgSpec",
    "Arrival", "Autoscaler", "ClusterRealBackend", "ClusterReplay",
    "ClusterSimBackend", "CoexecEngine", "CoexecKernel",
    "CoexecutorRuntime", "DataPlaneCounters", "DynamicScheduler",
    "EnergyReport", "EwmaThroughput", "ExecutionLoop", "FailurePlan",
    "HGuidedScheduler", "HaloChunk", "IRREGULAR", "InjectedFailure",
    "LaunchHandle", "LaunchShed", "LaunchSimResult", "LaunchSpec",
    "LaunchState", "LaunchStats", "LaunchWaitTimeout", "MemoryCosts",
    "MemoryModel", "MultiSimResult", "OutputSpec", "PAPER_POWER",
    "Package", "PowerModel", "REGULAR", "Range", "SPECS",
    "SPEED_HINT_POLICIES", "Scheduler", "ShedRecord", "SimResult",
    "SimUnit", "SpeedBoard", "StaticScheduler", "Supervisor",
    "TenantRow", "TorchUnit", "Trace", "TrafficReplay", "UnitPool",
    "WorkStealingScheduler", "Workload", "absorb_share",
    "as_coexec_kernel", "capacity_items_per_s", "counits_from_devices",
    "edp_ratio", "energy_report", "fusion_bucket", "geomean",
    "grant_share", "jain_index", "make_plane", "paper_workload",
    "replay_cluster_lockstep", "replay_trace_cluster",
    "replay_trace_lockstep", "replay_trace_sim", "service_fairness_curve",
    "simulate", "simulate_multi", "solo_run", "static_bounds",
    "synthesize_trace", "tenant_rows", "validate_cover",
]
