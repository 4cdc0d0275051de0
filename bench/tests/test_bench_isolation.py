"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (``repro_torch`` begins with ``repro``), and the
plain references import nothing of the port."""
from __future__ import annotations

import ast
import pathlib

import pytest

from conftest import ROOT

BENCH = ROOT / "bench"
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_covers_the_benchmark():
    rel = {p.relative_to(BENCH).as_posix() for p in FILES}
    assert {"run.py", "harness/runner.py", "reference/matmul.py",
            "systems/coexec.py", "metrics/items_per_s.py"} <= rel


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(BENCH).as_posix() for p in FILES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert top_level_imports(path) <= {"__future__", "contextlib", "numpy",
                                       "torch"}


def test_forbidden_modules_compares_whole_names():
    from bench.run import forbidden_modules

    assert forbidden_modules({"repro_torch": 1, "repro_torch.core": 1,
                              "jaxtyping": 1, "numpy": 1}) == []
    assert forbidden_modules({"jax": 1, "jax.numpy": 1, "repro.core": 1,
                              "flax.linen": 1, "jaxlib": 1}) == [
        "flax", "jax", "jaxlib", "repro"]


def test_cache_dirs_are_fixed_paths_inside_the_checkout():
    from bench.run import cache_dirs

    dirs = cache_dirs(ROOT)
    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
        assert pathlib.Path(dirs[key]).is_relative_to(ROOT / "build")
    assert cache_dirs(ROOT) == dirs
