"""Spec/CLI/registry consistency pass (repo scope).

Three structural contracts, checked purely by parsing source — no
``repro_torch`` imports, so the pass runs in milliseconds and without
torch:

* ``con-spec-cli`` — every field of every ``*Spec`` dataclass in
  ``api/spec.py`` must carry ``field(metadata=_cli(...))``, which is what
  derives its CLI flag in ``repro_torch.launch.serve``.
* ``con-spec-doc`` — every (section, field) pair reachable from
  ``CoexecSpec`` must have a schema row in ``docs/api.md``, and every
  schema row must point at a live field (no stale rows).
* ``con-plugin-fields`` — every ``register_scheduler`` /
  ``register_workload`` / ``register_kernel`` call whose factory is
  resolvable in the same module must declare only option ``fields`` the
  factory actually accepts (``granularity`` is implied for schedulers).

Factories the resolver cannot follow statically (attribute lookups,
multi-level indirection) are skipped rather than guessed at.

The spec and the registries are the port's (``src/repro_torch/``), but
the schema table is ``docs/api.md``, the one the JAX package's pass reads
too: the port's ``api/spec.py`` holds the JAX package's fields one for
one, so a single table documents both.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding
from .registry import AnalysisPass, Rule, register_pass

__all__ = ["check_consistency", "check_spec_cli_docs",
           "check_plugin_registrations"]

_ROW_RE = re.compile(r"^\|\s*`(\w+)`\s*\|\s*`(\w+)`\s*\|")
_REGISTER_FUNCS = ("register_scheduler", "register_workload",
                   "register_kernel")

SPEC_PATH = "src/repro_torch/api/spec.py"
DOC_PATH = "docs/api.md"
REGISTRY_GLOBS = ("src/repro_torch/**/*.py",)


def _call_name(node: ast.expr) -> str:
    """Trailing name of a call target (``dataclasses.field`` -> field)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_cli_field(value: Optional[ast.expr]) -> bool:
    """True when a dataclass field value is ``field(metadata=_cli(...))``."""
    if not (isinstance(value, ast.Call)
            and _call_name(value.func) == "field"):
        return False
    for kw in value.keywords:
        if (kw.arg == "metadata" and isinstance(kw.value, ast.Call)
                and _call_name(kw.value.func) == "_cli"):
            return True
    return False


def _spec_classes(tree: ast.Module) -> Dict[str, ast.ClassDef]:
    return {node.name: node for node in tree.body
            if isinstance(node, ast.ClassDef)
            and node.name.endswith("Spec")}


def _class_fields(cls: ast.ClassDef) -> List[Tuple[str, int, bool]]:
    """(field name, line, has _cli metadata) for one spec dataclass."""
    out = []
    for stmt in cls.body:
        if (isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)):
            out.append((stmt.target.id, stmt.lineno,
                        _is_cli_field(stmt.value)))
    return out


def _coexec_sections(cls: ast.ClassDef) -> Dict[str, str]:
    """Map CoexecSpec section name -> sub-spec class name."""
    sections = {}
    for stmt in cls.body:
        if (isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
                and isinstance(stmt.annotation, ast.Name)
                and stmt.annotation.id.endswith("Spec")):
            sections[stmt.target.id] = stmt.annotation.id
    return sections


def check_spec_cli_docs(spec_path: "str | Path",
                        doc_path: "str | Path") -> List[Finding]:
    """Check the spec->CLI and spec<->docs/api.md schema contracts.

    Args:
        spec_path: Path to the ``*Spec`` dataclass module.
        doc_path: Path to the API doc holding the schema table.

    Returns:
        ``con-spec-cli`` and ``con-spec-doc`` findings.
    """
    spec_path, doc_path = Path(spec_path), Path(doc_path)
    tree = ast.parse(spec_path.read_text(encoding="utf-8"),
                     filename=str(spec_path))
    classes = _spec_classes(tree)
    findings: List[Finding] = []

    for name, cls in classes.items():
        if name == "CoexecSpec":
            continue
        for fname, line, has_cli in _class_fields(cls):
            if not has_cli:
                findings.append(Finding(
                    rule="con-spec-cli", path=str(spec_path), line=line,
                    message=(f"{name}.{fname} has no "
                             "field(metadata=_cli(...)) — it surfaces no "
                             "CLI flag"),
                    hint="declare the flag with the _cli helper"))

    coexec = classes.get("CoexecSpec")
    if coexec is None:
        return findings
    expected: Dict[Tuple[str, str], int] = {}
    for section, clsname in _coexec_sections(coexec).items():
        sub = classes.get(clsname)
        if sub is None:
            continue
        for fname, line, _ in _class_fields(sub):
            expected[(section, fname)] = line

    documented: Set[Tuple[str, str]] = set()
    doc_lines = doc_path.read_text(encoding="utf-8").splitlines()
    for i, line_text in enumerate(doc_lines, start=1):
        m = _ROW_RE.match(line_text.strip())
        if m is None:
            continue
        key = (m.group(1), m.group(2))
        documented.add(key)
        if key not in expected:
            findings.append(Finding(
                rule="con-spec-doc", path=str(doc_path), line=i,
                message=(f"schema row `{key[0]}.{key[1]}` has no matching "
                         "spec field"),
                hint="delete or rename the stale row"))
    for (section, fname), line in sorted(expected.items()):
        if (section, fname) not in documented:
            findings.append(Finding(
                rule="con-spec-doc", path=str(spec_path), line=line,
                message=(f"spec field `{section}.{fname}` has no schema "
                         f"row in {doc_path.name}"),
                hint="add a `| section | field | ... |` row to the table"))
    return findings


def _factory_params(module: ast.Module, node: ast.expr,
                    drop_positional: int = 0
                    ) -> Optional[Tuple[Set[str], bool]]:
    """Resolve a factory expression to (accepted params, has **kwargs).

    Follows same-module names one assignment deep (``f = wrap(inner)``)
    and ``functools.partial(f, <args>)`` calls.  Returns ``None`` when the
    factory cannot be resolved statically.
    """
    if isinstance(node, ast.Call):
        func_name = node.func.attr if isinstance(node.func, ast.Attribute) \
            else (node.func.id if isinstance(node.func, ast.Name) else "")
        if func_name == "partial" and node.args:
            return _factory_params(module, node.args[0],
                                   drop_positional=len(node.args) - 1)
        if node.args:  # wrapper(inner): assume pass-through to inner
            return _factory_params(module, node.args[0], drop_positional)
        return None
    if not isinstance(node, ast.Name):
        return None
    for stmt in module.body:
        if isinstance(stmt, ast.ClassDef) and stmt.name == node.id:
            for sub in stmt.body:
                if (isinstance(sub, ast.FunctionDef)
                        and sub.name == "__init__"):
                    return _signature(sub.args, drop_self=True,
                                      drop_positional=drop_positional)
            return None
        if (isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                and stmt.name == node.id):
            return _signature(stmt.args, drop_self=False,
                              drop_positional=drop_positional)
        if (isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call)
                and any(isinstance(t, ast.Name) and t.id == node.id
                        for t in stmt.targets)):
            return _factory_params(module, stmt.value, drop_positional)
    return None


def _signature(args: ast.arguments, drop_self: bool,
               drop_positional: int) -> Tuple[Set[str], bool]:
    positional = [a.arg for a in (*args.posonlyargs, *args.args)]
    if drop_self and positional and positional[0] == "self":
        positional = positional[1:]
    positional = positional[drop_positional:]
    accepted = set(positional) | {a.arg for a in args.kwonlyargs}
    return accepted, args.kwarg is not None


def _tuple_of_strings(node: Optional[ast.expr]) -> Optional[List[str]]:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.append(elt.value)
            else:
                return None
        return out
    return None


def check_plugin_registrations(paths: List[Path]) -> List[Finding]:
    """Check declared plugin ``fields`` against factory signatures.

    Args:
        paths: Python files to scan for ``register_*`` calls.

    Returns:
        ``con-plugin-fields`` findings for every declared option field the
        (statically resolvable) factory does not accept.
    """
    findings: List[Finding] = []
    for path in paths:
        tree = ast.parse(path.read_text(encoding="utf-8"),
                         filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else "")
            if name not in _REGISTER_FUNCS or len(node.args) < 2:
                continue
            declared: List[str] = []
            for kw in node.keywords:
                if kw.arg == "fields":
                    declared = _tuple_of_strings(kw.value) or []
            if name == "register_scheduler":
                declared = list(dict.fromkeys((*declared, "granularity")))
            resolved = _factory_params(tree, node.args[1])
            if resolved is None:
                continue
            accepted, has_kwargs = resolved
            if has_kwargs:
                continue
            for fname in declared:
                if fname not in accepted:
                    findings.append(Finding(
                        rule="con-plugin-fields", path=str(path),
                        line=node.lineno,
                        message=(f"{name} declares option field "
                                 f"{fname!r} the factory does not accept"),
                        hint="align fields=(...) with the builder "
                             "signature"))
    return findings


def check_consistency(root: Path) -> List[Finding]:
    """Run all three consistency contracts against a repo root.

    Args:
        root: Repository root containing ``src/`` and ``docs/``.

    Returns:
        All consistency findings (empty when the contracts hold).
    """
    findings: List[Finding] = []
    spec = root / SPEC_PATH
    doc = root / DOC_PATH
    if spec.exists() and doc.exists():
        findings.extend(check_spec_cli_docs(spec, doc))
    files: List[Path] = []
    for pattern in REGISTRY_GLOBS:
        files.extend(sorted(root.glob(pattern)))
    findings.extend(check_plugin_registrations(files))
    return findings


register_pass(AnalysisPass(
    name="consistency",
    checker=check_consistency,
    rules=(
        Rule("con-spec-cli", "spec field without a derived CLI flag"),
        Rule("con-spec-doc",
             "spec field missing from docs/api.md (or stale row)"),
        Rule("con-plugin-fields",
             "registry fields mismatch the factory signature"),
    ),
    description="spec fields <-> CLI flags <-> docs <-> registry builders",
    scope="repo",
))
