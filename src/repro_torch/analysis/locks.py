"""Lock-discipline pass: a static race detector for threaded classes.

Convention (documented in ``docs/analysis.md``): a mutable attribute of a
threaded class declares its lock with a trailing comment on the line that
assigns it, e.g.::

    self._threads: list = []  # guarded-by: _cv

The pass then walks every *other* method of the class and flags any read
or write of a guarded attribute that is not lexically inside
``with self._cv:`` — unless the method's ``def`` line itself carries
``# guarded-by: _cv``, which documents a caller-holds-the-lock contract.

The special lock name ``caller`` marks a class as externally serialized
(the DES and the admission controller run under the engine's condition
variable); it documents the contract without enforcing a ``with`` block.

``__init__`` / ``__new__`` are exempt: construction happens-before any
other thread can see the object.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Sequence, Set

from .core import Finding, SourceFile
from .registry import AnalysisPass, Rule, register_pass

__all__ = ["check_locks"]

_GUARD_RE = re.compile(r"#.*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")

_EXEMPT_METHODS = ("__init__", "__new__")

LOCK_GLOBS = (
    "src/repro_torch/core/engine.py",
    "src/repro_torch/core/admission.py",
    "src/repro_torch/core/exec.py",
    "src/repro_torch/core/cluster.py",
)


def _guard_comment(lines: Sequence[str], lineno: int) -> "str | None":
    """Return the lock name from a ``# guarded-by:`` comment on a line."""
    if 1 <= lineno <= len(lines):
        m = _GUARD_RE.search(lines[lineno - 1])
        if m:
            return m.group(1)
    return None


def _self_attr(node: ast.AST) -> "str | None":
    """Return ``X`` when ``node`` is exactly ``self.X``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _collect_guards(cls: ast.ClassDef,
                    lines: Sequence[str]) -> Dict[str, str]:
    """Map guarded attribute name -> lock name for one class."""
    guards: Dict[str, str] = {}
    for node in ast.walk(cls):
        lock = None
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            lock = _guard_comment(lines, node.lineno)
            targets = list(node.targets)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            lock = _guard_comment(lines, node.lineno)
            targets = [node.target]
        if not lock:
            continue
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                guards[attr] = lock
            elif isinstance(t, ast.Name):  # class-level attribute
                guards[t.id] = lock
    return guards


def _with_locks(node: ast.With) -> Set[str]:
    """Lock names acquired by a ``with self.X[, self.Y]:`` statement."""
    out: Set[str] = set()
    for item in node.items:
        attr = _self_attr(item.context_expr)
        if attr is not None:
            out.add(attr)
    return out


def _visit(node: ast.AST, held: Set[str], guards: Dict[str, str],
           path: str) -> Iterator[Finding]:
    """Yield findings for guarded self-attribute access outside its lock."""
    attr = _self_attr(node)
    if attr is not None and attr in guards:
        lock = guards[attr]
        if lock != "caller" and lock not in held:
            yield Finding(
                rule="lock-guard", path=path, line=node.lineno,
                message=(f"`self.{attr}` (guarded-by {lock}) accessed "
                         f"outside `with self.{lock}:`"),
                hint=(f"wrap in `with self.{lock}:` or annotate the "
                      f"method `# guarded-by: {lock}`"))
    if isinstance(node, ast.With):
        acquired = _with_locks(node)
        for item in node.items:
            yield from _visit(item.context_expr, held, guards, path)
        inner = held | acquired
        for child in node.body:
            yield from _visit(child, inner, guards, path)
        return
    if isinstance(node, ast.ClassDef):
        return  # nested classes declare their own discipline
    for child in ast.iter_child_nodes(node):
        yield from _visit(child, held, guards, path)


def check_locks(src: SourceFile) -> List[Finding]:
    """Check ``# guarded-by:`` discipline for every class in one file.

    Args:
        src: Parsed source file.

    Returns:
        One ``lock-guard`` finding per guarded attribute access that is
        neither under its ``with self.<lock>:`` block nor inside a method
        annotated as caller-holds.
    """
    findings: List[Finding] = []
    for cls in ast.walk(src.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        guards = _collect_guards(cls, src.lines)
        if not guards:
            continue
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            if method.name in _EXEMPT_METHODS:
                continue
            held: Set[str] = set()
            holds = _guard_comment(src.lines, method.lineno)
            if holds is not None:
                held.add(holds)
            for child in method.body:
                findings.extend(_visit(child, held, guards, src.path))
    return sorted(findings, key=lambda f: f.line)


register_pass(AnalysisPass(
    name="locks",
    checker=check_locks,
    rules=(
        Rule("lock-guard",
             "guarded-by attribute accessed outside its lock"),
    ),
    description="guarded-by attributes only touched under their lock",
    scope="file",
    default_globs=LOCK_GLOBS,
))
