"""Static-analysis subsystem: AST invariant passes for the control plane.

``repro_torch.analysis`` turns the port's correctness conventions into
checks that run in milliseconds on every commit:

* **determinism** — no ambient clocks/RNG on the parity-critical decision
  path (clocks come from the injected ``Backend``, RNG from seeded
  generators).
* **locks** — ``# guarded-by: <lock>`` attributes of threaded classes are
  only touched under ``with self.<lock>:`` (a static race detector).
* **exceptions** — no silently swallowed failures, and never a dropped
  ``LaunchShed`` / ``LaunchWaitTimeout``.
* **consistency** — spec fields <-> CLI flags <-> ``docs/api.md`` rows
  <-> registry builder signatures stay structurally in sync.

Passes are plugins (:mod:`repro_torch.analysis.registry`) sharing one
reporting core (:mod:`repro_torch.analysis.core`); the driver is
``python -m repro_torch.analysis`` and CI wraps it as
``scripts/torch_check_static.py``.  This package never imports
:mod:`repro_torch.api`, torch or jax — it is pure stdlib and safe to run
anywhere.
"""
from .core import SUPPRESSION_BUDGET, Finding, SourceFile, load_source, \
    run_passes
from .registry import AnalysisPass, Rule, all_rules, pass_names, \
    pass_plugin, register_pass, temporary_passes

__all__ = [
    "SUPPRESSION_BUDGET",
    "Finding",
    "SourceFile",
    "load_source",
    "run_passes",
    "AnalysisPass",
    "Rule",
    "register_pass",
    "pass_names",
    "pass_plugin",
    "all_rules",
    "temporary_passes",
]
