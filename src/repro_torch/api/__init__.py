"""`repro_torch.api` — the declarative configuration surface of the port.

:class:`CoexecSpec` configures the real engine and the paper-facing
runtime, field for field as in the reference, and round-trips through
JSON. Schedulers, workload names and co-executable kernels plug in by name
through :mod:`repro_torch.api.registry`.
"""
from . import registry
from .registry import (KernelPlugin, SchedulerPlugin, WorkloadPlugin,
                       build_kernel, build_scheduler, build_workload,
                       kernel_demo_inputs, kernel_names, kernel_plugin,
                       register_kernel, register_scheduler,
                       register_workload, scheduler_names,
                       speed_hint_policies, temporary_plugins,
                       validate_scheduler_options, workload_names,
                       workload_plugin)
from .spec import (KERNEL_IMPL_CHOICES, SPEC_VERSION, AdmissionSpec,
                   ClusterSpec, CoexecSpec, CoexecSpecBuilder, MemorySpec,
                   SchedulerSpec, TrafficSpec, UnitsSpec, WorkloadSpec)

__all__ = [
    "AdmissionSpec", "ClusterSpec", "CoexecSpec", "CoexecSpecBuilder",
    "KERNEL_IMPL_CHOICES", "KernelPlugin", "MemorySpec", "SPEC_VERSION",
    "SchedulerPlugin", "SchedulerSpec", "TrafficSpec", "UnitsSpec",
    "WorkloadPlugin", "WorkloadSpec", "build_kernel", "build_scheduler",
    "build_workload", "kernel_demo_inputs", "kernel_names", "kernel_plugin",
    "register_kernel", "register_scheduler", "register_workload",
    "registry", "scheduler_names", "speed_hint_policies",
    "temporary_plugins", "validate_scheduler_options", "workload_names",
    "workload_plugin",
]
