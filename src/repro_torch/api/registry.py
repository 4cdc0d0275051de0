"""Plugin registry for schedulers, workloads and kernels (`CoexecSpec` backend).

The paper's runtime selects its load balancer by name (Listing 1's
``<hg>`` template parameter). This module is one declarative registry
for schedulers, workload profiles and kernels, so third-party
policies and workload profiles register *without editing core*:

* :func:`register_scheduler` — a policy name, its factory, the exact
  option fields its constructor accepts, and an optional per-policy
  validation hook. Unknown/misspelled options raise :class:`ValueError`
  naming the offending key and the accepted fields (never silently
  ignored, never a bare ``TypeError`` from deep inside a constructor).
* :func:`register_workload` — a profile name and a factory returning
  ``(Workload, cpu_unit, gpu_unit)``, the contract of
  :func:`repro_torch.core.workloads.paper_workload`.
* :func:`register_kernel` — a kernel name and a factory returning a
  typed :class:`~repro_torch.core.dataplane.CoexecKernel` (per-argument
  SPLIT/BROADCAST semantics + output slot), optionally with a demo-input
  generator so benchmarks and parity tests can drive any registered
  kernel. This replaces the ``package_kernel`` if-chain of hand-written
  closures: the ported paper kernels register in
  :mod:`repro_torch.kernels.ops`, third-party kernels register here without
  editing core.
* shorthand resolvers — pattern aliases such as ``dyn5`` → Dynamic with 5
  packages register alongside the policy they expand to.

This module deliberately imports nothing from ``repro_torch.core``: core
modules import *it* and register their built-ins at import time, which is
what keeps the dependency graph acyclic (`api.registry` ← `core.*` ←
`api.spec` ← `api`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional

__all__ = [
    "KernelPlugin", "SchedulerPlugin", "WorkloadPlugin",
    "register_kernel", "register_scheduler", "register_workload",
    "kernel_names", "scheduler_names", "workload_names",
    "resolve_scheduler", "build_kernel", "build_scheduler",
    "build_workload", "kernel_demo_inputs", "kernel_plugin",
    "workload_plugin", "validate_scheduler_options",
    "speed_hint_policies", "temporary_plugins",
]


def _normalize(policy: str) -> str:
    return str(policy).lower().replace("-", "_")


@dataclasses.dataclass(frozen=True)
class SchedulerPlugin:
    """One registered load-balancing policy.

    Attributes:
        name: canonical policy name (lower-case, underscores).
        factory: ``factory(total, num_units, **options) -> Scheduler``.
        fields: option names the factory accepts beyond the positional
            ``(total, num_units)`` pair — the validation whitelist.
        speed_hint: whether the factory takes a ``speeds`` computing-power
            hint (the paper's ``dist(0.35)``).
        shorthand: optional ``fn(key) -> dict | None`` that recognizes
            alias spellings (``dyn5``) and returns the implied options.
        validate: optional ``fn(options: dict) -> None`` hook run before
            construction; raise :class:`ValueError` to reject a spec.
    """

    name: str
    factory: Callable
    fields: tuple[str, ...] = ()
    speed_hint: bool = False
    shorthand: Optional[Callable[[str], Optional[dict]]] = None
    validate: Optional[Callable[[dict], None]] = None


@dataclasses.dataclass(frozen=True)
class WorkloadPlugin:
    """One registered workload profile.

    Attributes:
        name: canonical profile name.
        factory: ``factory(**options) -> (Workload, cpu, gpu)``.
        fields: option names the factory accepts (e.g. ``size_scale``).
        validate: optional ``fn(options: dict) -> None`` pre-build hook.
    """

    name: str
    factory: Callable
    fields: tuple[str, ...] = ()
    validate: Optional[Callable[[dict], None]] = None


@dataclasses.dataclass(frozen=True)
class KernelPlugin:
    """One registered co-executable kernel.

    Attributes:
        name: canonical kernel name.
        factory: ``factory(**options) -> CoexecKernel`` — must return the
            *same* kernel object for the same options (cache it), so the
            units' one-time warm-up stays memoized across builds.
        fields: option names the factory accepts (the validation
            whitelist, e.g. ``terms`` for the Taylor kernel).
        demo_inputs: optional ``fn(n, rng) -> list[np.ndarray]``
            generating representative inputs for an ``n``-item launch —
            what lets benchmarks and parity tests drive *every*
            registered kernel without per-kernel glue.
        validate: optional ``fn(options: dict) -> None`` pre-build hook.
    """

    name: str
    factory: Callable
    fields: tuple[str, ...] = ()
    demo_inputs: Optional[Callable] = None
    validate: Optional[Callable[[dict], None]] = None


_SCHEDULERS: dict[str, SchedulerPlugin] = {}
_WORKLOADS: dict[str, WorkloadPlugin] = {}
_KERNELS: dict[str, KernelPlugin] = {}


def register_scheduler(name: str, factory: Callable, *,
                       fields: tuple[str, ...] = (),
                       speed_hint: bool = False,
                       shorthand: Optional[Callable] = None,
                       validate: Optional[Callable] = None,
                       overwrite: bool = False) -> SchedulerPlugin:
    """Register a scheduling policy under ``name``.

    Args:
        name: policy name; normalized to lower-case with underscores.
        factory: ``factory(total, num_units, **options) -> Scheduler``.
        fields: accepted option names (``granularity`` is implied — every
            scheduler takes it).
        speed_hint: the factory accepts a ``speeds`` hint.
        shorthand: alias matcher, e.g. ``dynN`` → implied options.
        validate: per-policy option validation hook.
        overwrite: allow replacing an existing registration.

    Returns:
        The stored :class:`SchedulerPlugin`.

    Raises:
        ValueError: duplicate name without ``overwrite``.
    """
    key = _normalize(name)
    if key in _SCHEDULERS and not overwrite:
        raise ValueError(f"scheduler policy {key!r} is already registered; "
                         f"pass overwrite=True to replace it")
    plugin = SchedulerPlugin(key, factory,
                             fields=tuple(dict.fromkeys(
                                 (*fields, "granularity"))),
                             speed_hint=speed_hint, shorthand=shorthand,
                             validate=validate)
    _SCHEDULERS[key] = plugin
    return plugin


def register_workload(name: str, factory: Callable, *,
                      fields: tuple[str, ...] = (),
                      validate: Optional[Callable] = None,
                      overwrite: bool = False) -> WorkloadPlugin:
    """Register a workload profile under ``name``.

    Args:
        name: profile name; normalized like policy names.
        factory: ``factory(**options) -> (Workload, cpu, gpu)``.
        fields: accepted option names.
        validate: per-profile option validation hook.
        overwrite: allow replacing an existing registration.

    Returns:
        The stored :class:`WorkloadPlugin`.

    Raises:
        ValueError: duplicate name without ``overwrite``.
    """
    key = _normalize(name)
    if key in _WORKLOADS and not overwrite:
        raise ValueError(f"workload {key!r} is already registered; "
                         f"pass overwrite=True to replace it")
    plugin = WorkloadPlugin(key, factory, fields=tuple(fields),
                            validate=validate)
    _WORKLOADS[key] = plugin
    return plugin


def register_kernel(name: str, factory: Callable, *,
                    fields: tuple[str, ...] = (),
                    demo_inputs: Optional[Callable] = None,
                    validate: Optional[Callable] = None,
                    overwrite: bool = False) -> KernelPlugin:
    """Register a co-executable kernel under ``name``.

    Args:
        name: kernel name; normalized like policy names.
        factory: ``factory(**options) -> CoexecKernel`` (should memoize).
        fields: accepted option names.
        demo_inputs: ``fn(n, rng) -> list[np.ndarray]`` demo generator.
        validate: per-kernel option validation hook.
        overwrite: allow replacing an existing registration.

    Returns:
        The stored :class:`KernelPlugin`.

    Raises:
        ValueError: duplicate name without ``overwrite``.
    """
    key = _normalize(name)
    if key in _KERNELS and not overwrite:
        raise ValueError(f"kernel {key!r} is already registered; "
                         f"pass overwrite=True to replace it")
    plugin = KernelPlugin(key, factory, fields=tuple(fields),
                          demo_inputs=demo_inputs, validate=validate)
    _KERNELS[key] = plugin
    return plugin


def _ensure_builtins() -> None:
    """Make sure core's built-in policies/workloads have registered.

    Importing ``repro_torch.core.scheduler`` / ``repro_torch.core.workloads`` runs
    their registration side effects; lazy so `repro_torch.api` alone works.
    """
    if not _SCHEDULERS:
        import repro_torch.core.scheduler  # noqa: F401  (registers built-ins)
    if not _WORKLOADS:
        import repro_torch.core.workloads  # noqa: F401


def _ensure_kernels() -> None:
    """Make sure the paper's built-in kernels have registered.

    Separate from :func:`_ensure_builtins` because the kernel package is
    the heavy import (Pallas modules); sim-only flows never pay it.
    """
    if not _KERNELS:
        import repro_torch.kernels.ops  # noqa: F401  (registers built-ins)


def scheduler_names() -> tuple[str, ...]:
    """Registered policy names, sorted (shorthand aliases excluded)."""
    _ensure_builtins()
    return tuple(sorted(_SCHEDULERS))


def workload_names() -> tuple[str, ...]:
    """Registered workload profile names, sorted."""
    _ensure_builtins()
    return tuple(sorted(_WORKLOADS))


def kernel_names() -> tuple[str, ...]:
    """Registered co-executable kernel names, sorted."""
    _ensure_kernels()
    return tuple(sorted(_KERNELS))


def workload_plugin(name: str) -> WorkloadPlugin:
    """Look one workload plugin up by name.

    Args:
        name: registered profile name (case/hyphen-insensitive).

    Returns:
        The stored :class:`WorkloadPlugin`.

    Raises:
        KeyError: no workload of that name is registered.
    """
    _ensure_builtins()
    key = _normalize(name)
    plugin = _WORKLOADS.get(key)
    if plugin is None:
        raise KeyError(f"unknown workload {name!r}; "
                       f"choose from {sorted(_WORKLOADS)}")
    return plugin


def kernel_plugin(name: str) -> KernelPlugin:
    """Look one kernel plugin up by name.

    Args:
        name: registered kernel name (case/hyphen-insensitive).

    Returns:
        The stored :class:`KernelPlugin`.

    Raises:
        KeyError: no kernel of that name is registered.
    """
    _ensure_kernels()
    key = _normalize(name)
    plugin = _KERNELS.get(key)
    if plugin is None:
        raise KeyError(f"unknown kernel {name!r}; "
                       f"choose from {sorted(_KERNELS)}")
    return plugin


def build_kernel(name: str, *, impl: Optional[str] = None, **options):
    """Build (resolve) a registered kernel by name.

    Args:
        name: registered kernel name.
        impl: implementation variant to select (``"pallas"`` / ``"xla"``
            / ``"ref"``). ``None`` or ``"auto"`` leaves the choice to the
            kernel's backend-aware default. Anything else requires the
            plugin to declare an ``impl`` field — kernels without
            variants reject the request loudly instead of silently
            serving their only body.
        **options: kernel options (validated against declared fields).

    Returns:
        The kernel object the factory returns — for the paper's
        built-ins, a :class:`~repro_torch.core.dataplane.CoexecKernel`.

    Raises:
        KeyError: unknown kernel.
        ValueError: unknown option key (named, with accepted fields), or
            an impl request against a kernel with no ``impl`` field.
    """
    plugin = kernel_plugin(name)
    if impl not in (None, "auto"):
        if "impl" not in plugin.fields:
            raise ValueError(
                f"kernel {plugin.name!r} has no implementation variants "
                f"(no 'impl' field); cannot select impl={impl!r}")
        options["impl"] = impl
    unknown = sorted(set(options) - set(plugin.fields))
    if unknown:
        raise ValueError(
            f"unknown option(s) {unknown!r} for kernel {plugin.name!r}; "
            f"accepted fields: {sorted(plugin.fields)}")
    if plugin.validate is not None:
        plugin.validate(dict(options))
    return plugin.factory(**options)


def kernel_demo_inputs(name: str, n: int, *, seed: int = 0) -> list:
    """Representative inputs for an ``n``-item launch of one kernel.

    Args:
        name: registered kernel name.
        n: launch index-space size.
        seed: RNG seed (vary it for independent requests).

    Returns:
        Host input arrays acceptable to the kernel's declared arguments,
        each owning its pages (USM on a CUDA unit maps them in place).

    Raises:
        KeyError: unknown kernel.
        ValueError: the kernel registered no demo-input generator.
    """
    import numpy as np

    from ..core.dataplane import page_exclusive

    plugin = kernel_plugin(name)
    if plugin.demo_inputs is None:
        raise ValueError(f"kernel {plugin.name!r} registered no "
                         f"demo-input generator")
    return [page_exclusive(a) for a in
            plugin.demo_inputs(int(n), np.random.default_rng(seed))]


def speed_hint_policies() -> tuple[str, ...]:
    """Names of policies whose factory takes a ``speeds`` hint."""
    _ensure_builtins()
    return tuple(sorted(k for k, p in _SCHEDULERS.items() if p.speed_hint))


def resolve_scheduler(policy: str) -> tuple[SchedulerPlugin, dict]:
    """Look a policy name up, expanding shorthand aliases.

    Args:
        policy: registered name (case/hyphen-insensitive) or an alias a
            plugin's shorthand matcher recognizes (``dyn5``).

    Returns:
        ``(plugin, implied_options)`` — implied options come from the
        shorthand expansion and are overridable by explicit options.

    Raises:
        KeyError: no registered policy or shorthand matches.
    """
    _ensure_builtins()
    key = _normalize(policy)
    plugin = _SCHEDULERS.get(key)
    if plugin is not None:
        return plugin, {}
    for plugin in _SCHEDULERS.values():
        if plugin.shorthand is not None:
            implied = plugin.shorthand(key)
            if implied is not None:
                return plugin, dict(implied)
    raise KeyError(f"unknown scheduling policy {policy!r}; "
                   f"choose from {sorted(_SCHEDULERS)}")


def validate_scheduler_options(policy: str, options: dict) -> None:
    """Reject unknown/misspelled options for a policy, loudly.

    Args:
        policy: registered policy name or shorthand alias.
        options: candidate keyword options.

    Raises:
        KeyError: unknown policy.
        ValueError: an option the policy's factory does not accept — the
            message names the offending key and the accepted fields.
    """
    plugin, _ = resolve_scheduler(policy)
    unknown = sorted(set(options) - set(plugin.fields))
    if unknown:
        raise ValueError(
            f"unknown option(s) {unknown!r} for scheduling policy "
            f"{plugin.name!r}; accepted fields: {sorted(plugin.fields)}")
    if plugin.validate is not None:
        plugin.validate(dict(options))


def build_scheduler(policy: str, total: int, num_units: int, **options):
    """Build a load balancer by name — the registry-backed policy factory.

    The non-deprecated replacement for ``repro_torch.core.make_scheduler``:
    exactly the same contract (``KeyError`` for unknown policies, the
    ``dynN`` shorthand, per-policy ``ValueError`` on bad sizes/speeds)
    plus strict option validation.

    Args:
        policy: registered policy name or shorthand alias.
        total: size of the 1-D index space to split.
        num_units: number of Coexecution Units the launch will run on.
        **options: policy-specific options (validated against the
            plugin's declared fields).

    Returns:
        A fresh one-shot scheduler for exactly one launch.

    Raises:
        KeyError: unknown policy.
        ValueError: unknown option key, or invalid sizes/speeds.
    """
    plugin, implied = resolve_scheduler(policy)
    merged = {**implied, **options}
    validate_scheduler_options(plugin.name, merged)
    return plugin.factory(total, num_units, **merged)


def build_workload(name: str, **options):
    """Build a registered workload profile by name.

    Args:
        name: registered profile name.
        **options: profile options (validated against declared fields).

    Returns:
        Whatever the profile factory returns — for the paper's built-ins,
        ``(Workload, cpu_unit, gpu_unit)``.

    Raises:
        KeyError: unknown profile.
        ValueError: unknown option key.
    """
    _ensure_builtins()
    key = _normalize(name)
    plugin = _WORKLOADS.get(key)
    if plugin is None:
        raise KeyError(f"unknown workload {name!r}; "
                       f"choose from {sorted(_WORKLOADS)}")
    unknown = sorted(set(options) - set(plugin.fields))
    if unknown:
        raise ValueError(
            f"unknown option(s) {unknown!r} for workload {plugin.name!r}; "
            f"accepted fields: {sorted(plugin.fields)}")
    if plugin.validate is not None:
        plugin.validate(dict(options))
    return plugin.factory(**options)


class temporary_plugins:
    """Context manager restoring the registry on exit (for tests/demos).

    Example::

        with temporary_plugins():
            register_scheduler("mine", MyScheduler, fields=("knob",))
            ...
        # "mine" is gone again
    """

    def __enter__(self) -> "temporary_plugins":
        self._sched = dict(_SCHEDULERS)
        self._work = dict(_WORKLOADS)
        self._kern = dict(_KERNELS)
        return self

    def __exit__(self, *exc) -> None:
        _SCHEDULERS.clear()
        _SCHEDULERS.update(self._sched)
        _WORKLOADS.clear()
        _WORKLOADS.update(self._work)
        _KERNELS.clear()
        _KERNELS.update(self._kern)


def _iter_scheduler_plugins() -> Iterator[SchedulerPlugin]:
    """Yield registered scheduler plugins (for the API snapshot tool)."""
    _ensure_builtins()
    yield from _SCHEDULERS.values()
