"""The port's static-analysis passes against the reference's.

* Each test of ``tests/test_analysis.py`` has its counterpart here, run
  against ``repro_torch.analysis``: the fixture-backed true positives
  and clean cases of every rule (the fixtures are read where they are),
  the suppression round trip, the seeded lock-guard mutation of the
  port's ``engine.py``, the registry, the listing and the port's tree
  staying clean under ``python -m repro_torch.analysis`` and
  ``scripts/torch_check_static.py``.
* Parity: on every fixture, and on every file in the port's scopes, the
  port's checkers give the reference's findings field for field (paths
  compared repo-relative); the catalog (names, scopes, descriptions,
  rules, budget) is the reference's, and each pass's globs are the
  reference's with ``src/repro/`` re-rooted at ``src/repro_torch/``.
* The kernel registry's ``impl`` axis: every built-in factory takes
  ``impl``, so ``con-plugin-fields`` finds nothing in ``kernels/ops.py``,
  and ``impl`` spelled ``auto``, empty or left out builds one object.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

import repro.analysis as ref_analysis
import repro.analysis.__main__ as ref_main
import repro.analysis.consistency as ref_consistency
import repro.analysis.determinism as ref_determinism
import repro.analysis.exceptions as ref_exceptions
import repro.analysis.locks as ref_locks
import repro_torch.analysis.__main__ as port_main
import repro_torch.analysis.consistency as port_consistency
from repro_torch.analysis import (SUPPRESSION_BUDGET, AnalysisPass, Rule,
                                  all_rules, load_source, pass_names,
                                  pass_plugin, register_pass, run_passes,
                                  temporary_passes)
from repro_torch.analysis.consistency import (check_plugin_registrations,
                                              check_spec_cli_docs)
from repro_torch.analysis.determinism import check_determinism
from repro_torch.analysis.exceptions import check_exceptions
from repro_torch.analysis.locks import check_locks
from repro_torch.api.registry import build_kernel

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = pathlib.Path(__file__).resolve().parent / "analysis_fixtures"
PASSES = ("consistency", "determinism", "exceptions", "locks")
KERNELS = ("taylor", "gaussian", "matmul", "mandelbrot", "ray", "rap")


def _rules(findings):
    return sorted({f.rule for f in findings})


def _rel(path: str) -> str:
    p = pathlib.Path(path).resolve()
    return p.relative_to(REPO).as_posix() if p.is_relative_to(REPO) \
        else str(path)


def _fields(findings):
    """Findings of either package as comparable tuples."""
    return [(f.rule, _rel(f.path), f.line, f.message, f.hint)
            for f in findings]


# ---------------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------------

def test_determinism_true_positives():
    findings = check_determinism(load_source(FIXTURES / "det_bad.py"))
    assert _rules(findings) == ["det-naive-datetime", "det-set-iteration",
                                "det-unseeded-rng", "det-wall-clock"]
    # both unseeded-RNG shapes fire: argless default_rng and np.random.*
    assert sum(f.rule == "det-unseeded-rng" for f in findings) == 2
    assert sum(f.rule == "det-set-iteration" for f in findings) == 2


def test_determinism_clean():
    assert check_determinism(load_source(FIXTURES / "det_clean.py")) == []


def test_determinism_scope_is_the_decision_path():
    globs = pass_plugin("determinism").default_globs
    for mod in ("exec", "admission", "traffic", "sim", "cluster"):
        assert f"src/repro_torch/core/{mod}.py" in globs
        assert (REPO / f"src/repro_torch/core/{mod}.py").exists()


# ---------------------------------------------------------------------------
# lock discipline
# ---------------------------------------------------------------------------

def test_locks_true_positive():
    findings = check_locks(load_source(FIXTURES / "locks_bad.py"))
    assert _rules(findings) == ["lock-guard"]
    (f,) = findings
    assert "_pending" in f.message and "_lock" in f.message


def test_locks_clean():
    assert check_locks(load_source(FIXTURES / "locks_clean.py")) == []


def test_locks_mutation_of_engine_turns_red(tmp_path):
    """Deleting one ``with self._cv:`` from the port's engine.py is caught."""
    source = (REPO / "src/repro_torch/core/engine.py").read_text()
    guarded = ("        with self._cv:\n"
               "            self._stop = True\n"
               "            self._cv.notify_all()\n"
               "            threads = list(self._threads)\n")
    unguarded = ("        self._stop = True\n"
                 "        self._cv.notify_all()\n"
                 "        threads = list(self._threads)\n")
    assert guarded in source, "engine.py shutdown lock block moved; " \
                              "update the mutation fixture"

    pristine = tmp_path / "engine_pristine.py"
    pristine.write_text(source)
    assert check_locks(load_source(pristine)) == []

    mutated = tmp_path / "engine_mutated.py"
    mutated.write_text(source.replace(guarded, unguarded))
    findings = check_locks(load_source(mutated))
    assert any(f.rule == "lock-guard" and "_stop" in f.message
               for f in findings)
    assert any(f.rule == "lock-guard" and "_threads" in f.message
               for f in findings)
    # the reference's pass reads the mutant the same way
    ref = ref_locks.check_locks(ref_analysis.load_source(mutated))
    assert _fields(ref) == _fields(findings)


# ---------------------------------------------------------------------------
# exception hygiene
# ---------------------------------------------------------------------------

def test_exceptions_true_positives():
    findings = check_exceptions(load_source(FIXTURES / "exc_bad.py"))
    assert _rules(findings) == ["exc-bare-except", "exc-broad-except",
                                "exc-swallowed-control"]


def test_exceptions_clean():
    assert check_exceptions(load_source(FIXTURES / "exc_clean.py")) == []


# ---------------------------------------------------------------------------
# spec/CLI/registry consistency
# ---------------------------------------------------------------------------

def test_consistency_spec_true_positives():
    findings = check_spec_cli_docs(FIXTURES / "spec_bad.py",
                                   FIXTURES / "spec_bad.md")
    assert sum(f.rule == "con-spec-cli" for f in findings) == 1
    docs = [f for f in findings if f.rule == "con-spec-doc"]
    messages = " | ".join(f.message for f in docs)
    assert "alpha.burst" in messages       # missing row
    assert "alpha.ghost" in messages       # stale row


def test_consistency_spec_clean():
    assert check_spec_cli_docs(FIXTURES / "spec_clean.py",
                               FIXTURES / "spec_clean.md") == []


def test_consistency_registration_true_positive():
    findings = check_plugin_registrations([FIXTURES / "reg_bad.py"])
    assert _rules(findings) == ["con-plugin-fields"]
    assert "typo_option" in findings[0].message


def test_consistency_registration_clean():
    assert check_plugin_registrations([FIXTURES / "reg_clean.py"]) == []


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

def _write_module(tmp_path, body):
    p = tmp_path / "mod.py"
    p.write_text(body)
    return p


def test_suppression_silences_a_finding(tmp_path):
    p = _write_module(tmp_path, (
        '"""Mod."""\n'
        "import time\n"
        "t = time.perf_counter()  # lint: disable=det-wall-clock\n"))
    findings = run_passes([pass_plugin("determinism")], tmp_path,
                          paths=[str(p)])
    assert findings == []


def test_unused_suppression_is_flagged(tmp_path):
    p = _write_module(tmp_path, (
        '"""Mod."""\n'
        "x = 1  # lint: disable=det-wall-clock\n"))
    findings = run_passes([pass_plugin("determinism")], tmp_path,
                          paths=[str(p)])
    assert _rules(findings) == ["unused-suppression"]


def test_unknown_rule_suppression_is_ignored(tmp_path):
    # a rule no selected pass checks is not "unused" — another pass owns it
    p = _write_module(tmp_path, (
        '"""Mod."""\n'
        "x = 1  # lint: disable=lock-guard\n"))
    findings = run_passes([pass_plugin("determinism")], tmp_path,
                          paths=[str(p)])
    assert findings == []


def test_suppression_budget_enforced(tmp_path):
    p = _write_module(tmp_path, (
        '"""Mod."""\n'
        "import time\n"
        "a = time.time()  # lint: disable=det-wall-clock\n"
        "b = time.time()  # lint: disable=det-wall-clock\n"))
    over = run_passes([pass_plugin("determinism")], tmp_path,
                      paths=[str(p)], budget=1)
    assert _rules(over) == ["suppression-budget"]
    under = run_passes([pass_plugin("determinism")], tmp_path,
                       paths=[str(p)], budget=2)
    assert under == []
    ref_over = ref_analysis.run_passes(
        [ref_analysis.pass_plugin("determinism")], tmp_path,
        paths=[str(p)], budget=1)
    assert _fields(ref_over) == _fields(over)


# ---------------------------------------------------------------------------
# registry + driver
# ---------------------------------------------------------------------------

def test_builtin_passes_registered():
    assert set(pass_names()) >= set(PASSES)
    for name in PASSES:
        assert pass_plugin(name).checker.__module__ == \
            f"repro_torch.analysis.{name}"


def test_register_pass_rejects_duplicates_and_scopes():
    dummy = AnalysisPass(name="dummy", checker=lambda src: [],
                         rules=(Rule("dummy-rule", "test"),),
                         description="test pass")
    with temporary_passes():
        register_pass(dummy)
        with pytest.raises(ValueError, match="already registered"):
            register_pass(dummy)
        register_pass(dummy, overwrite=True)
        with pytest.raises(ValueError, match="scope"):
            register_pass(AnalysisPass(
                name="weird", checker=lambda src: [], rules=(),
                description="bad scope", scope="universe"))
        assert "dummy" not in ref_analysis.pass_names()
    assert "dummy" not in pass_names()


def test_registry_listing_has_analysis_section():
    from repro_torch.api.cli import registry_listing
    listing = registry_listing()
    assert "analysis:" in listing
    for name in PASSES:
        assert name in listing
    assert "lock-guard" in listing


def _run_module(*args, cwd=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, *args],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=cwd or REPO)


def test_repo_is_clean_under_the_driver():
    proc = _run_module("-m", "repro_torch.analysis", "--root", str(REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == ("repro_torch.analysis: OK (passes: "
                                   "consistency, determinism, exceptions, "
                                   "locks)")


def test_check_static_writes_report(tmp_path):
    report = tmp_path / "report.json"
    proc = _run_module(str(REPO / "scripts" / "torch_check_static.py"),
                       "--report", str(report), cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "torch_check_static: OK" in proc.stdout
    data = json.loads(report.read_text())
    assert data["schema_version"] == 1
    assert data["count"] == 0
    assert data["passes"] == list(PASSES)


# ---------------------------------------------------------------------------
# parity with the reference: fixtures
# ---------------------------------------------------------------------------

def _file_case(port_check, ref_check, name):
    return (lambda: port_check(load_source(FIXTURES / name)),
            lambda: ref_check(ref_analysis.load_source(FIXTURES / name)))


def _reg_case(name):
    return (lambda: check_plugin_registrations([FIXTURES / name]),
            lambda: ref_consistency.check_plugin_registrations(
                [FIXTURES / name]))


def _spec_case(stem):
    return (lambda: check_spec_cli_docs(FIXTURES / f"{stem}.py",
                                        FIXTURES / f"{stem}.md"),
            lambda: ref_consistency.check_spec_cli_docs(
                FIXTURES / f"{stem}.py", FIXTURES / f"{stem}.md"))


FIXTURE_CASES = {
    "det_bad.py": _file_case(check_determinism,
                             ref_determinism.check_determinism, "det_bad.py"),
    "det_clean.py": _file_case(check_determinism,
                               ref_determinism.check_determinism,
                               "det_clean.py"),
    "locks_bad.py": _file_case(check_locks, ref_locks.check_locks,
                               "locks_bad.py"),
    "locks_clean.py": _file_case(check_locks, ref_locks.check_locks,
                                 "locks_clean.py"),
    "exc_bad.py": _file_case(check_exceptions,
                             ref_exceptions.check_exceptions, "exc_bad.py"),
    "exc_clean.py": _file_case(check_exceptions,
                               ref_exceptions.check_exceptions,
                               "exc_clean.py"),
    "reg_bad.py": _reg_case("reg_bad.py"),
    "reg_clean.py": _reg_case("reg_clean.py"),
    "spec_bad": _spec_case("spec_bad"),
    "spec_clean": _spec_case("spec_clean"),
}


def test_fixture_cases_cover_the_fixtures():
    stems = {p.stem for p in FIXTURES.iterdir()
             if p.suffix in (".py", ".md")}
    assert {c.split(".")[0] for c in FIXTURE_CASES} == stems


@pytest.mark.parametrize("case", sorted(FIXTURE_CASES))
def test_fixture_findings_equal_the_reference(case):
    port, ref = FIXTURE_CASES[case]
    got, want = port(), ref()
    assert _fields(got) == _fields(want)
    assert ("clean" in case) == (got == [])


# ---------------------------------------------------------------------------
# parity with the reference: the port's own files
# ---------------------------------------------------------------------------

_FILE_CHECKERS = {
    "determinism": (check_determinism, ref_determinism.check_determinism),
    "exceptions": (check_exceptions, ref_exceptions.check_exceptions),
    "locks": (check_locks, ref_locks.check_locks),
}
SCOPED = [(name, path.relative_to(REPO).as_posix())
          for name in sorted(_FILE_CHECKERS)
          for pattern in pass_plugin(name).default_globs
          for path in sorted(REPO.glob(pattern))]


def test_scopes_reach_the_port():
    by_pass = {n: [p for m, p in SCOPED if m == n] for n in _FILE_CHECKERS}
    assert len(by_pass["determinism"]) == 5
    assert len(by_pass["locks"]) == 4
    assert "src/repro_torch/core/engine.py" in by_pass["exceptions"]
    assert "src/repro_torch/api/cli.py" in by_pass["exceptions"]
    assert all(p.startswith("src/repro_torch/") for _, p in SCOPED)


@pytest.mark.parametrize("name,path", SCOPED,
                         ids=[f"{n}:{p}" for n, p in SCOPED])
def test_port_file_findings_equal_the_reference(name, path):
    port, ref = _FILE_CHECKERS[name]
    got = port(load_source(REPO / path))
    want = ref(ref_analysis.load_source(REPO / path))
    assert _fields(got) == _fields(want)
    assert got == []


def test_port_registrations_equal_the_reference():
    files = [p for pattern in port_consistency.REGISTRY_GLOBS
             for p in sorted(REPO.glob(pattern))]
    assert REPO / "src/repro_torch/kernels/ops.py" in files
    got = check_plugin_registrations(files)
    want = ref_consistency.check_plugin_registrations(files)
    assert _fields(got) == _fields(want) == []


def test_port_spec_equals_the_reference():
    spec = REPO / port_consistency.SPEC_PATH
    doc = REPO / port_consistency.DOC_PATH
    got = check_spec_cli_docs(spec, doc)
    want = ref_consistency.check_spec_cli_docs(spec, doc)
    assert _fields(got) == _fields(want) == []


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------

def test_catalog_names_and_budget_are_the_reference():
    assert pass_names() == ref_analysis.pass_names()
    assert SUPPRESSION_BUDGET == ref_analysis.SUPPRESSION_BUDGET == 10
    assert [(r.id, r.summary) for r in all_rules()] == \
        [(r.id, r.summary) for r in ref_analysis.all_rules()]


@pytest.mark.parametrize("name", PASSES)
def test_pass_catalog_is_the_reference(name):
    got, want = pass_plugin(name), ref_analysis.pass_plugin(name)
    assert (got.name, got.scope, got.description) == \
        (want.name, want.scope, want.description)
    assert [(r.id, r.summary) for r in got.rules] == \
        [(r.id, r.summary) for r in want.rules]
    assert got.default_globs == tuple(
        g.replace("src/repro/", "src/repro_torch/")
        for g in want.default_globs)


def test_consistency_paths_are_rerooted():
    assert port_consistency.SPEC_PATH == \
        ref_consistency.SPEC_PATH.replace("src/repro/", "src/repro_torch/")
    assert port_consistency.REGISTRY_GLOBS == tuple(
        g.replace("src/repro/", "src/repro_torch/")
        for g in ref_consistency.REGISTRY_GLOBS)
    assert port_consistency.DOC_PATH == ref_consistency.DOC_PATH


def test_list_prints_the_reference(capsys):
    assert port_main.main(["--list"]) == 0
    got = capsys.readouterr().out
    assert ref_main.main(["--list"]) == 0
    assert got == capsys.readouterr().out
    assert "lock-guard: guarded-by attribute" in got


def test_report_dict_is_the_reference():
    port_f = [check_locks(load_source(FIXTURES / "locks_bad.py"))[0]]
    ref_f = [ref_locks.check_locks(
        ref_analysis.load_source(FIXTURES / "locks_bad.py"))[0]]
    got = port_main.report_dict(port_f, list(PASSES))
    assert got == ref_main.report_dict(ref_f, list(PASSES))
    assert got["count"] == 1


def test_driver_messages_name_the_port(tmp_path, capsys):
    bad = tmp_path / "mod.py"
    bad.write_text('"""Mod."""\nimport time\nt = time.time()\n')
    assert port_main.main(["--select", "determinism", "--root",
                           str(tmp_path), str(bad)]) == 1
    err = capsys.readouterr().err
    assert err.startswith("repro_torch.analysis: 1 finding(s) from passes: "
                          "determinism")


# ---------------------------------------------------------------------------
# the kernel registry's impl axis
# ---------------------------------------------------------------------------

def test_ops_registrations_are_clean():
    ops = REPO / "src/repro_torch/kernels/ops.py"
    assert check_plugin_registrations([ops]) == []
    assert ref_consistency.check_plugin_registrations([ops]) == []


@pytest.mark.parametrize("name", KERNELS)
def test_impl_spellings_build_one_kernel(name):
    kernel = build_kernel(name)
    assert build_kernel(name, impl="auto") is kernel
    assert build_kernel(name, impl="") is kernel
    assert kernel.name == name
