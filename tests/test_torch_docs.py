"""The port's docs checks hold: its docstrings, its API snapshot and its
lint driver pass on the tree, and each fails on the fault it guards.

Mirrors ``tests/test_docs.py`` for ``src/repro_torch``: the same
stdlib-only checkers (``scripts/torch_check_docstrings.py`` and
``scripts/torch_check_api.py`` import the reference's and change only
their roots), run as subprocesses. On a copy of the port and the scripts
under ``tmp_path``, a dropped export fails the API check and a stripped
strict docstring fails the docstring check, each also through
``scripts/torch_lint.py``.
"""
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SNAPSHOT = REPO / "scripts" / "torch_api_snapshot.txt"
REF_SNAPSHOT = REPO / "scripts" / "api_snapshot.txt"


def _run(root: pathlib.Path, script: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    return subprocess.run([sys.executable, str(root / "scripts" / script)],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=root)


@pytest.mark.parametrize("script", ["torch_check_docstrings.py",
                                    "torch_check_api.py", "torch_lint.py"])
def test_check_passes_on_the_tree(script):
    proc = _run(REPO, script)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)


def test_snapshot_covers_the_ports_three_modules():
    snap = SNAPSHOT.read_text()
    for module in ("repro_torch.analysis", "repro_torch.api",
                   "repro_torch.core"):
        assert f"\n{module}." in "\n" + snap, module
    assert "repro_torch.api.CoexecSpec" in snap
    assert "repro_torch.core.CoexecutorRuntime" in snap
    assert "repro_torch.api.KERNEL_IMPL_CHOICES" in snap


@pytest.mark.parametrize("name", ["KERNEL_IMPLS", "default_impl",
                                  "flash_attention_op", "gaussian_op",
                                  "linear_attention_op", "mandelbrot_op",
                                  "matmul_op", "rap_op", "raytrace_op",
                                  "taylor_op"])
def test_snapshot_lists_impl_names_where_the_references_does(name):
    """The implementation axis's names stand in the port's snapshot
    exactly where they stand in the reference's."""
    def listed(path: pathlib.Path, package: str) -> list[str]:
        pattern = re.compile(rf"^{package}\.(\w+)\.{name}\b", re.M)
        return sorted(pattern.findall(path.read_text()))

    assert listed(SNAPSHOT, "repro_torch") == listed(REF_SNAPSHOT, "repro")


def _drop_export(root: pathlib.Path) -> None:
    init = root / "src" / "repro_torch" / "api" / "__init__.py"
    text = init.read_text()
    assert '"KERNEL_IMPL_CHOICES", ' in text
    init.write_text(text.replace('"KERNEL_IMPL_CHOICES", ', "", 1))


def _strip_strict_docstring(root: pathlib.Path) -> None:
    registry = root / "src" / "repro_torch" / "api" / "registry.py"
    text = registry.read_text()
    head, sep, tail = text.partition("def build_kernel(")
    assert sep and "Raises:" in tail
    registry.write_text(head + sep + tail.replace("Raises:", "Raised:", 1))


@pytest.mark.parametrize("fault,script,message", [
    (_drop_export, "torch_check_api.py", "public API drifted"),
    (_strip_strict_docstring, "torch_check_docstrings.py",
     "build_kernel: docstring missing required ['Raises:']"),
])
def test_check_fails_on_its_fault_in_a_copy(tmp_path, fault, script,
                                            message):
    shutil.copytree(REPO / "scripts", tmp_path / "scripts",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(REPO / "src" / "repro_torch",
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for doc in ("README.md", "docs"):
        src = REPO / doc
        (shutil.copytree if src.is_dir() else shutil.copy)(src,
                                                          tmp_path / doc)
    assert _run(tmp_path, script).returncode == 0
    fault(tmp_path)
    proc = _run(tmp_path, script)
    assert proc.returncode == 1 and message in proc.stderr, proc.stderr
    lint = _run(tmp_path, "torch_lint.py")
    assert lint.returncode == 1 and "lint: FAILED" in lint.stderr
