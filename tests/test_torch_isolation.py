"""The port stands alone: no JAX and nothing of the reference package.

An AST scan of every module under ``src/repro_torch`` finds no import of
``jax`` or ``repro``, and a fresh interpreter that imports the port's
packages (the DES, traffic, cluster and energy tiers, the serve CLI, the
roofline, the sharding rules, the mesh, the dry run and the
static-analysis passes among them) and builds a DES profile through the
registry has neither in ``sys.modules`` afterwards. The port's scripts
and examples (``scripts/torch_*.py``, ``examples/torch_*.py``) import
neither either, and collecting the port's API snapshot through the
reference's collector loads neither. The co-execution path's share
measurement, taken from the serve launcher, loads no model and no config.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
MODULES = sorted((SRC / "repro_torch").rglob("*.py"))
SCRIPTS = sorted([*(ROOT / "scripts").glob("torch_*.py"),
                  *(ROOT / "examples").glob("torch_*.py")])
FORBIDDEN = ("jax", "repro")


def imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_scan_covers_the_package():
    names = {p.relative_to(SRC).as_posix() for p in MODULES}
    for module in ("core/dataplane.py", "core/director.py",
                   "kernels/ops.py", "kernels/ref.py", "kernels/raytrace.py",
                   "kernels/rap.py",
                   "configs/base.py", "models/model.py", "models/convert.py",
                   "models/moe.py", "models/xlstm.py",
                   "kernels/flash_attention.py",
                   "kernels/linear_attention.py", "launch/serve.py",
                   "core/energy.py", "core/sim.py", "core/traffic.py",
                   "core/cluster.py", "core/workloads.py", "api/cli.py",
                   "models/sharding.py", "launch/mesh.py",
                   "launch/dryrun.py", "roofline/flops.py",
                   "roofline/analysis.py", "analysis/core.py",
                   "analysis/consistency.py"):
        assert f"repro_torch/{module}" in names


@pytest.mark.parametrize("path", MODULES,
                         ids=[p.relative_to(SRC).as_posix() for p in MODULES])
def test_module_imports_neither_jax_nor_reference(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_import_leaves_no_jax_or_reference_in_sys_modules():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.api, repro_torch.configs, repro_torch.models, "
            "repro_torch.launch.serve, repro_torch.api.cli, "
            "repro_torch.core.sim, repro_torch.core.traffic, "
            "repro_torch.core.cluster, repro_torch.core.energy, "
            "repro_torch.roofline, repro_torch.models.sharding, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.analysis\n"
            "from repro_torch.core import paper_workload\n"
            "paper_workload('mandelbrot')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", SCRIPTS,
                         ids=[p.relative_to(ROOT).as_posix() for p in SCRIPTS])
def test_script_imports_neither_jax_nor_reference(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_api_snapshot_collection_loads_neither():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT / 'scripts')!r})\n"
            "import torch_check_api\n"
            "assert torch_check_api.base.snapshot_lines()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_share_measurement_loads_no_model():
    """``measured_dist`` as the co-execution cell takes it, from the serve
    launcher: the runtime's own function, and nothing of the LM stack
    (``repro_torch.models``, ``repro_torch.configs``) in ``sys.modules``
    afterwards."""
    code = ("import sys\n"
            "import repro_torch.core\n"
            "from repro_torch.launch.serve import measured_dist\n"
            "assert measured_dist is repro_torch.core.measured_dist\n"
            "assert measured_dist.__module__ == 'repro_torch.core.runtime'\n"
            "bad = sorted(m for m in sys.modules if m.startswith(\n"
            "    ('repro_torch.models', 'repro_torch.configs')))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
