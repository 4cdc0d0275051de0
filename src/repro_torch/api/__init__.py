"""`repro_torch.api` — the declarative configuration surface of the port.

:class:`CoexecSpec` configures the real engine, the paper-facing runtime,
the discrete-event simulators and the serve CLI (whose flags are derived
from the spec fields by :mod:`repro_torch.api.cli`), field for field as
in the reference, and round-trips through JSON. Schedulers, workload
profiles and co-executable kernels plug in by name through
:mod:`repro_torch.api.registry` (``registry_listing`` powers ``--list``).
"""
from . import registry
from .cli import (SPEC_SECTIONS, add_spec_args, args_from_spec,
                  registry_listing, spec_from_args)
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
    "KERNEL_IMPL_CHOICES", "KernelPlugin", "MemorySpec", "SPEC_SECTIONS",
    "SPEC_VERSION", "SchedulerPlugin", "SchedulerSpec", "TrafficSpec",
    "UnitsSpec", "WorkloadPlugin", "WorkloadSpec", "add_spec_args",
    "args_from_spec", "build_kernel", "build_scheduler",
    "build_workload", "kernel_demo_inputs", "kernel_names", "kernel_plugin",
    "register_kernel", "register_scheduler", "register_workload",
    "registry", "registry_listing", "scheduler_names", "spec_from_args",
    "speed_hint_policies", "temporary_plugins",
    "validate_scheduler_options", "workload_names", "workload_plugin",
]
