"""Plugin registry for static-analysis passes.

Mirrors the scheduler/workload/kernel registries in
:mod:`repro_torch.api.registry`: passes are frozen dataclass plugins in a
module-level table, registered by name, with a context manager for
scoped test registrations.  The built-in passes self-register lazily on
first lookup so importing this module stays cheap and cycle-free.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Tuple

__all__ = [
    "Rule",
    "AnalysisPass",
    "register_pass",
    "pass_names",
    "pass_plugin",
    "all_rules",
    "temporary_passes",
]


@dataclass(frozen=True)
class Rule:
    """One rule a pass can emit.

    Attributes:
        id: Stable rule id used in findings and suppression comments.
        summary: One-line description for ``--list`` output and docs.
    """

    id: str
    summary: str


@dataclass(frozen=True)
class AnalysisPass:
    """A registered static-analysis pass.

    Attributes:
        name: Registry key, e.g. ``"determinism"``.
        checker: For ``scope="file"`` a callable taking a
            :class:`repro_torch.analysis.core.SourceFile` and yielding
            findings;
            for ``scope="repo"`` a callable taking the repo root ``Path``.
        rules: The rules this pass may emit.
        description: One-line description for ``--list`` output.
        scope: ``"file"`` (runs per source file, suppressible) or
            ``"repo"`` (runs once per repository, not suppressible).
        default_globs: Repo-relative globs selecting the files a
            file-scope pass analyses when no explicit paths are given.
    """

    name: str
    checker: Callable
    rules: Tuple[Rule, ...]
    description: str
    scope: str = "file"
    default_globs: Tuple[str, ...] = field(default_factory=tuple)


_PASSES: Dict[str, AnalysisPass] = {}
_BUILTINS_LOADED = False


def register_pass(plugin: AnalysisPass, overwrite: bool = False) -> None:
    """Register an analysis pass under its name.

    Args:
        plugin: The pass to register.
        overwrite: Allow replacing an existing pass of the same name.

    Raises:
        ValueError: If the name is taken and ``overwrite`` is false, or the
            scope is not ``"file"``/``"repo"``.
    """
    if plugin.scope not in ("file", "repo"):
        raise ValueError(f"unknown pass scope: {plugin.scope!r}")
    if plugin.name in _PASSES and not overwrite:
        raise ValueError(f"analysis pass already registered: {plugin.name}")
    _PASSES[plugin.name] = plugin


def _ensure_builtins() -> None:
    """Import the built-in pass modules once (they self-register)."""
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    from . import consistency, determinism, exceptions, locks  # noqa: F401


def pass_names() -> Tuple[str, ...]:
    """Return registered pass names in registration order."""
    _ensure_builtins()
    return tuple(_PASSES)


def pass_plugin(name: str) -> AnalysisPass:
    """Look up one pass by name.

    Args:
        name: Registry key of the pass.

    Returns:
        The registered :class:`AnalysisPass`.

    Raises:
        KeyError: If no pass of that name is registered.
    """
    _ensure_builtins()
    if name not in _PASSES:
        known = ", ".join(sorted(_PASSES))
        raise KeyError(f"unknown analysis pass {name!r} (known: {known})")
    return _PASSES[name]


def all_rules() -> Tuple[Rule, ...]:
    """Return every rule declared by every registered pass."""
    _ensure_builtins()
    out = []
    for p in _PASSES.values():
        out.extend(p.rules)
    return tuple(out)


@contextmanager
def temporary_passes() -> Iterator[None]:
    """Scope pass registrations: restores the table on exit.

    Mirrors ``repro_torch.api.registry.temporary_plugins`` for tests that
    register throwaway passes.
    """
    _ensure_builtins()
    saved = dict(_PASSES)
    try:
        yield
    finally:
        _PASSES.clear()
        _PASSES.update(saved)
