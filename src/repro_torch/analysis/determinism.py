"""Determinism pass: no ambient clocks or RNG on the decision path.

The control plane's parity guarantees (real-vs-sim lockstep, exact-once
re-issue) hold only if every decision module takes time from the injected
``Backend`` clock and randomness from an explicitly seeded generator.
This pass flags the ambient alternatives:

* ``det-wall-clock`` — calls into :mod:`time` (``time``, ``perf_counter``,
  ``monotonic``, ``process_time`` and their ``_ns`` variants).
* ``det-unseeded-rng`` — any import of stdlib :mod:`random` (global,
  unseeded state) and ``numpy.random`` calls other than
  ``default_rng(<seed>)`` with an explicit argument.
* ``det-naive-datetime`` — argless ``datetime.now()`` / ``utcnow()`` /
  ``today()``.
* ``det-set-iteration`` — iterating a syntactic set literal,
  comprehension, or ``set(...)`` call, whose order is hash-randomized
  across processes (``sorted(set(...))`` is fine).

The set-iteration check is syntactic only: a set stored in a variable and
iterated later is not tracked.  That keeps the pass dependency-free and
false-positive-poor; the convention is to sort at the point of iteration.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Set

from .core import Finding, SourceFile
from .registry import AnalysisPass, Rule, register_pass

__all__ = ["check_determinism"]

_TIME_FUNCS = {
    "time", "perf_counter", "monotonic", "process_time",
    "time_ns", "perf_counter_ns", "monotonic_ns", "process_time_ns",
}
_DT_FUNCS = {"now", "utcnow", "today"}

DECISION_GLOBS = (
    "src/repro_torch/core/exec.py",
    "src/repro_torch/core/admission.py",
    "src/repro_torch/core/traffic.py",
    "src/repro_torch/core/sim.py",
    "src/repro_torch/core/cluster.py",
)


def _is_set_expr(node: ast.AST) -> bool:
    """True for a syntactic set: literal, set comprehension, or set(...)."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "set")


class _Aliases:
    """Import aliases relevant to the determinism rules in one file."""

    def __init__(self) -> None:
        self.time_modules: Set[str] = set()
        self.time_funcs: Set[str] = set()
        self.numpy_modules: Set[str] = set()
        self.numpy_random: Set[str] = set()
        self.default_rng: Set[str] = set()
        self.datetime_modules: Set[str] = set()
        self.datetime_classes: Set[str] = set()

    def collect(self, tree: ast.Module) -> List[Finding]:
        """Walk imports; return findings for stdlib ``random`` imports."""
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.asname or alias.name
                    if alias.name == "time":
                        self.time_modules.add(name)
                    elif alias.name == "numpy":
                        self.numpy_modules.add(name)
                    elif alias.name == "numpy.random":
                        self.numpy_random.add(name)
                    elif alias.name == "datetime":
                        self.datetime_modules.add(name)
                    elif alias.name == "random":
                        findings.append(_rng_import(node))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "time":
                    for alias in node.names:
                        if alias.name in _TIME_FUNCS:
                            self.time_funcs.add(alias.asname or alias.name)
                elif node.module == "random":
                    findings.append(_rng_import(node))
                elif node.module == "numpy":
                    for alias in node.names:
                        if alias.name == "random":
                            self.numpy_random.add(alias.asname or alias.name)
                elif node.module == "numpy.random":
                    for alias in node.names:
                        if alias.name == "default_rng":
                            self.default_rng.add(alias.asname or alias.name)
                elif node.module == "datetime":
                    for alias in node.names:
                        if alias.name in ("datetime", "date"):
                            self.datetime_classes.add(
                                alias.asname or alias.name)
        return findings


def _rng_import(node: ast.AST) -> Finding:
    return Finding(
        rule="det-unseeded-rng", path="", line=node.lineno,
        message="stdlib `random` (global unseeded state) on a decision path",
        hint="use numpy.random.default_rng(seed) threaded through the spec")


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression (``np.random`` -> str)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _check_call(call: ast.Call, al: _Aliases) -> Iterator[Finding]:
    func = call.func
    if isinstance(func, ast.Name):
        if func.id in al.time_funcs:
            yield Finding(
                rule="det-wall-clock", path="", line=call.lineno,
                message=f"wall-clock call `{func.id}()` on a decision path",
                hint="read time from the injected Backend clock")
        elif func.id in al.default_rng and not (call.args or call.keywords):
            yield Finding(
                rule="det-unseeded-rng", path="", line=call.lineno,
                message="`default_rng()` without an explicit seed",
                hint="pass the spec seed: default_rng(seed)")
        return
    if not isinstance(func, ast.Attribute):
        return
    dotted = _dotted(func)
    base, _, attr = dotted.rpartition(".")
    if base in al.time_modules and attr in _TIME_FUNCS:
        yield Finding(
            rule="det-wall-clock", path="", line=call.lineno,
            message=f"wall-clock call `{dotted}()` on a decision path",
            hint="read time from the injected Backend clock")
        return
    np_random = (base in al.numpy_random
                 or (base.count(".") == 1
                     and base.split(".")[0] in al.numpy_modules
                     and base.split(".")[1] == "random"))
    if np_random:
        if attr == "default_rng":
            if not (call.args or call.keywords):
                yield Finding(
                    rule="det-unseeded-rng", path="", line=call.lineno,
                    message="`default_rng()` without an explicit seed",
                    hint="pass the spec seed: default_rng(seed)")
        else:
            yield Finding(
                rule="det-unseeded-rng", path="", line=call.lineno,
                message=(f"global numpy RNG call `{dotted}()` on a "
                         "decision path"),
                hint="use a seeded default_rng(seed) Generator instead")
        return
    if attr in _DT_FUNCS and not (call.args or call.keywords):
        root = dotted.split(".")[0]
        dt_class = (base in al.datetime_classes
                    or (root in al.datetime_modules
                        and base.endswith((".datetime", ".date"))))
        if dt_class:
            yield Finding(
                rule="det-naive-datetime", path="", line=call.lineno,
                message=f"ambient `{dotted}()` on a decision path",
                hint="derive timestamps from the Backend clock or the spec")


def _check_set_iteration(tree: ast.Module) -> Iterator[Finding]:
    def flag(node: ast.AST) -> Finding:
        return Finding(
            rule="det-set-iteration", path="", line=node.lineno,
            message="iteration over a set has hash-randomized order",
            hint="wrap in sorted(...) before iterating")

    for node in ast.walk(tree):
        if isinstance(node, ast.For) and _is_set_expr(node.iter):
            yield flag(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                if _is_set_expr(gen.iter):
                    yield flag(gen.iter)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Name)
              and node.func.id in ("list", "tuple", "enumerate")
              and node.args and _is_set_expr(node.args[0])):
            yield flag(node.args[0])


def check_determinism(src: SourceFile) -> List[Finding]:
    """Run the determinism rules over one decision-path source file.

    Args:
        src: Parsed source file.

    Returns:
        Findings (with ``path`` filled in) for every ambient clock, RNG,
        naive datetime, and unordered set iteration.
    """
    aliases = _Aliases()
    findings = aliases.collect(src.tree)
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call):
            findings.extend(_check_call(node, aliases))
    findings.extend(_check_set_iteration(src.tree))
    out = [Finding(rule=f.rule, path=src.path, line=f.line,
                   message=f.message, hint=f.hint) for f in findings]
    return sorted(out, key=lambda f: (f.line, f.rule))


register_pass(AnalysisPass(
    name="determinism",
    checker=check_determinism,
    rules=(
        Rule("det-wall-clock",
             "time.time/perf_counter/... on a decision path"),
        Rule("det-unseeded-rng",
             "stdlib random or unseeded numpy RNG on a decision path"),
        Rule("det-naive-datetime",
             "argless datetime.now/utcnow/today on a decision path"),
        Rule("det-set-iteration",
             "iteration over a syntactic set (hash-randomized order)"),
    ),
    description="no ambient clocks/RNG in parity-critical decision code",
    scope="file",
    default_globs=DECISION_GLOBS,
))
