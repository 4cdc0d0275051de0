"""Exception-hygiene pass: no silently swallowed failures.

Three rules, scoped to the control plane (``core/``) and API surface
(``api/``):

* ``exc-bare-except`` — a bare ``except:`` that does not re-raise.
* ``exc-broad-except`` — ``except Exception`` / ``except BaseException``
  whose body neither re-raises, nor uses the bound exception (``as e``),
  nor calls a logging method; failures must at least be observable.
* ``exc-swallowed-control`` — catching the control-flow launch outcomes
  (``LaunchShed``, ``LaunchWaitTimeout``, ``AdmissionFull``) without
  re-raising or inspecting them; these carry admission decisions and must
  never be dropped on the floor.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Sequence

from .core import Finding, SourceFile
from .registry import AnalysisPass, Rule, register_pass

__all__ = ["check_exceptions"]

_BROAD = {"Exception", "BaseException"}
_CONTROL = {"LaunchShed", "LaunchWaitTimeout", "AdmissionFull"}
_LOG_METHODS = {"exception", "warning", "warn", "error", "critical", "log",
                "debug", "info"}

EXCEPTION_GLOBS = (
    "src/repro_torch/core/*.py",
    "src/repro_torch/api/*.py",
)


def _type_names(node: "ast.AST | None") -> List[str]:
    """Flatten an except clause's type expression into bare class names."""
    if node is None:
        return []
    if isinstance(node, ast.Tuple):
        out: List[str] = []
        for elt in node.elts:
            out.extend(_type_names(elt))
        return out
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, ast.Attribute):
        return [node.attr]
    return []


def _has_raise(body: Sequence[ast.stmt]) -> bool:
    return any(isinstance(n, ast.Raise)
               for stmt in body for n in ast.walk(stmt))


def _uses_name(body: Sequence[ast.stmt], name: "str | None") -> bool:
    if name is None:
        return False
    return any(isinstance(n, ast.Name) and n.id == name
               for stmt in body for n in ast.walk(stmt))


def _has_logging(body: Sequence[ast.stmt]) -> bool:
    for stmt in body:
        for n in ast.walk(stmt):
            if not isinstance(n, ast.Call):
                continue
            func = n.func
            if isinstance(func, ast.Attribute) and func.attr in _LOG_METHODS:
                return True
            if isinstance(func, ast.Name) and func.id in _LOG_METHODS:
                return True
    return False


def _check_handler(h: ast.ExceptHandler) -> Iterator[Finding]:
    names = _type_names(h.type)
    raises = _has_raise(h.body)
    uses = _uses_name(h.body, h.name)
    logs = _has_logging(h.body)
    if h.type is None and not raises:
        yield Finding(
            rule="exc-bare-except", path="", line=h.lineno,
            message="bare `except:` without re-raise",
            hint="catch a specific exception type, or re-raise")
        return
    swallowed = sorted(_CONTROL.intersection(names))
    if swallowed and not (raises or uses):
        kinds = ", ".join(swallowed)
        yield Finding(
            rule="exc-swallowed-control", path="", line=h.lineno,
            message=f"launch-control exception(s) {kinds} swallowed",
            hint="re-raise, or record the decision the exception carries")
        return
    if _BROAD.intersection(names) and not (raises or uses or logs):
        yield Finding(
            rule="exc-broad-except", path="", line=h.lineno,
            message="broad `except` that neither re-raises, logs, nor "
                    "inspects the exception",
            hint="narrow the type, or log/re-raise the failure")


def check_exceptions(src: SourceFile) -> List[Finding]:
    """Run the exception-hygiene rules over one source file.

    Args:
        src: Parsed source file.

    Returns:
        Findings for every bare, over-broad, or control-flow-swallowing
        handler.
    """
    findings: List[Finding] = []
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ExceptHandler):
            for f in _check_handler(node):
                findings.append(Finding(
                    rule=f.rule, path=src.path, line=f.line,
                    message=f.message, hint=f.hint))
    return sorted(findings, key=lambda f: f.line)


register_pass(AnalysisPass(
    name="exceptions",
    checker=check_exceptions,
    rules=(
        Rule("exc-bare-except", "bare except without re-raise"),
        Rule("exc-broad-except",
             "except Exception with no re-raise/log/inspection"),
        Rule("exc-swallowed-control",
             "LaunchShed/LaunchWaitTimeout/AdmissionFull dropped"),
    ),
    description="no silently swallowed exceptions in core/ and api/",
    scope="file",
    default_globs=EXCEPTION_GLOBS,
))
