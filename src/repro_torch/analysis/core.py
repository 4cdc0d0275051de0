"""Shared reporting core for the static-analysis passes.

This module owns the three pieces every pass shares:

* :class:`Finding` — one diagnostic: rule id, location, message, fix hint.
* :class:`SourceFile` — a parsed source file (text, split lines, AST) plus
  the ``# lint: disable=<rule>`` suppressions found in it.
* :func:`run_passes` — the driver loop: resolve which files each pass sees,
  invoke the checkers, apply suppressions, and enforce the suppression
  budget.

Suppression convention
----------------------
A trailing comment ``# lint: disable=rule-a,rule-b`` silences those rules
on that physical line only.  Each *used* suppression counts against a
repo-wide budget (:data:`SUPPRESSION_BUDGET`); exceeding the budget is
itself a finding (``suppression-budget``), and a suppression that silences
nothing is reported as ``unused-suppression``.  Neither meta rule can be
suppressed.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "SUPPRESSION_BUDGET",
    "Finding",
    "SourceFile",
    "load_source",
    "run_passes",
]

# Repo-wide ceiling on *used* `# lint: disable=` comments.  Deliberately
# small: suppressions are an escape hatch, not a lifestyle.
SUPPRESSION_BUDGET = 10

# Rules that the reporting core itself emits; they can never be suppressed.
_META_RULES = ("unused-suppression", "suppression-budget")

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_,\- ]+)")


@dataclass(frozen=True)
class Finding:
    """One diagnostic produced by an analysis pass.

    Attributes:
        rule: Rule id, e.g. ``"det-wall-clock"``.
        path: File the finding points at (repo-relative when possible).
        line: 1-based line number.
        message: What is wrong, in one sentence.
        hint: How to fix it, in one sentence.
    """

    rule: str
    path: str
    line: int
    message: str
    hint: str = ""

    def render(self) -> str:
        """Format as ``path:line: [rule] message (hint)`` for terminals."""
        text = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            text += f" (hint: {self.hint})"
        return text


@dataclass(frozen=True)
class SourceFile:
    """A parsed Python source file handed to file-scope checkers.

    Attributes:
        path: Path the file was read from (string, as reported in findings).
        text: Full source text.
        lines: ``text.splitlines()``.
        tree: Parsed ``ast.Module``.
        suppressions: Mapping of 1-based line number to the set of rule ids
            disabled on that line via ``# lint: disable=...``.
    """

    path: str
    text: str
    lines: Tuple[str, ...]
    tree: ast.Module
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)


def _parse_suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """Extract per-line rule suppressions from trailing lint comments."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if m is None:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        if rules:
            out[i] = rules
    return out


def load_source(path: "str | Path") -> SourceFile:
    """Read and parse one Python file into a :class:`SourceFile`.

    Args:
        path: File to load; must contain syntactically valid Python.

    Returns:
        The parsed :class:`SourceFile` with suppressions extracted.
    """
    p = Path(path)
    text = p.read_text(encoding="utf-8")
    lines = tuple(text.splitlines())
    tree = ast.parse(text, filename=str(p))
    return SourceFile(path=str(p), text=text, lines=lines, tree=tree,
                      suppressions=_parse_suppressions(lines))


def _apply_suppressions(
    findings: Iterable[Finding],
    src: SourceFile,
) -> Tuple[List[Finding], Set[Tuple[int, str]]]:
    """Split findings into (kept, used-suppression keys) for one file."""
    kept: List[Finding] = []
    used: Set[Tuple[int, str]] = set()
    for f in findings:
        disabled = src.suppressions.get(f.line, set())
        if f.rule in disabled and f.rule not in _META_RULES:
            used.add((f.line, f.rule))
        else:
            kept.append(f)
    return kept, used


def run_passes(
    passes: Sequence,
    root: "str | Path",
    paths: Optional[Sequence[str]] = None,
    budget: int = SUPPRESSION_BUDGET,
) -> List[Finding]:
    """Run analysis passes over a repo and return surviving findings.

    File-scope passes run per matching file with suppressions applied;
    repo-scope passes run once against ``root`` and are not suppressible
    (they point at cross-file contracts, not single lines of code).

    Args:
        passes: ``AnalysisPass`` plugins (see
            :mod:`repro_torch.analysis.registry`).
        root: Repository root all ``default_globs`` resolve against.
        paths: Optional explicit file list overriding every file-scope
            pass's default globs (each pass still sees only ``.py`` files).
        budget: Maximum number of used suppressions before the
            ``suppression-budget`` meta finding fires.

    Returns:
        All findings that survived suppression, ordered by pass then file.
    """
    rootp = Path(root)
    findings: List[Finding] = []
    used_total: List[Tuple[str, int, str]] = []
    seen_files: Dict[str, SourceFile] = {}

    for p in passes:
        if p.scope == "repo":
            findings.extend(p.checker(rootp))
            continue
        if paths:
            files = [Path(x) for x in paths if str(x).endswith(".py")]
        else:
            files = []
            for pattern in p.default_globs:
                files.extend(sorted(rootp.glob(pattern)))
        for fp in files:
            key = str(fp)
            src = seen_files.get(key)
            if src is None:
                src = load_source(fp)
                seen_files[key] = src
            kept, used = _apply_suppressions(p.checker(src), src)
            findings.extend(kept)
            used_total.extend((key, line, rule) for line, rule in used)

    # Meta rule 1: suppressions that silenced nothing are themselves stale.
    used_by_file: Dict[str, Set[Tuple[int, str]]] = {}
    for key, line, rule in used_total:
        used_by_file.setdefault(key, set()).add((line, rule))
    checked_rules: Set[str] = set()
    for p in passes:
        checked_rules.update(r.id for r in p.rules)
    for key, src in sorted(seen_files.items()):
        used_here = used_by_file.get(key, set())
        for line, rules in sorted(src.suppressions.items()):
            for rule in sorted(rules):
                if rule in checked_rules and (line, rule) not in used_here:
                    findings.append(Finding(
                        rule="unused-suppression", path=key, line=line,
                        message=f"suppression for '{rule}' matches nothing",
                        hint="delete the stale `# lint: disable` comment"))

    # Meta rule 2: the repo-wide budget of used suppressions.
    if len(used_total) > budget:
        key, line, _ = used_total[budget]
        findings.append(Finding(
            rule="suppression-budget", path=key, line=line,
            message=(f"{len(used_total)} suppressions in use exceeds "
                     f"the budget of {budget}"),
            hint="fix the underlying findings instead of suppressing"))
    return findings
