"""The benchmark as data: ``BENCHMARK.json`` and the files its names find.

A cell names a configuration and a traffic mix; each metric names a
reader. Every piece is a file of its own, found by name under the
benchmark's folder, so a later cell, mix or metric is added as files and
an entry in ``BENCHMARK.json``, never by editing one that is there:

- a configuration: the ``file`` its ``configs`` entry gives;
- a traffic mix: ``traffic/<mix>.json``;
- a kernel's input maker, plain reference and work count:
  ``inputs/<kernel>.py``, ``reference/<kernel>.py``, ``work/<kernel>.py``,
  where ``<kernel>`` is the configuration's ``kernel``;
- the system under test: ``systems/<system>.py``, by the configuration's
  ``system``;
- a metric's reader: ``metrics/<metric>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads``, with its configuration and mix loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # metric entries this cell reports with --trace 0
    per_layer: list       # and with --trace 1
    bench_dir: pathlib.Path

    @property
    def kernel(self) -> str:
        """The program's kernel the configuration runs."""
        return self.config["kernel"]

    def module(self, kind: str) -> ModuleType:
        """The kernel's ``inputs``, ``reference`` or ``work`` module."""
        return load_module(self.bench_dir / kind / f"{self.kernel}.py")

    def system(self) -> ModuleType:
        """The system under test: ``systems/<system>.py``, whose
        ``System(cell, inputs, total, devices)`` serves the launches."""
        return load_module(self.bench_dir / "systems"
                           / f"{self.config['system']}.py")


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT,
              bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its files read.

    Raises:
        KeyError: no such cell, or its configuration is not listed.
        FileNotFoundError: a file the cell names is missing.
    """
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; choose "
                       f"from {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return build_cell(name, root / configs[entry["config"]]["file"],
                      entry["traffic"], int(entry["chips"]),
                      end_to_end=[m for m in bench["end_to_end"]
                                  if _applies(m, name)],
                      per_layer=[m for m in bench["per_layer"]
                                 if _applies(m, name)])


def build_cell(name: str, config_file: pathlib.Path, traffic: str,
               chips: int, *, end_to_end: list, per_layer: list) -> Cell:
    """A cell from its configuration's file and its mix's name."""
    with open(config_file) as f:
        config = json.load(f)
    bench_dir = pathlib.Path(config_file).parents[1]
    with open(bench_dir / "traffic" / f"{traffic}.json") as f:
        mix = json.load(f)
    return Cell(name=name, chips=chips, config=config, traffic=mix,
                end_to_end=end_to_end, per_layer=per_layer,
                bench_dir=bench_dir)


def load_module(path: pathlib.Path) -> ModuleType:
    """Import one file by path (a name may hold dots, so not by import).

    Raises:
        FileNotFoundError: no such file.
    """
    path = pathlib.Path(path)
    if not path.is_file():
        raise FileNotFoundError(path)
    mod_name = "bench_file_" + "_".join(
        path.relative_to(path.parents[1]).with_suffix("").parts
    ).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(cell: Cell, metric: str) -> ModuleType:
    """The reader of one metric: ``metrics/<metric>.py``."""
    return load_module(cell.bench_dir / "metrics" / f"{metric}.py")


def peaks(kind: str, bench_dir: pathlib.Path = BENCH_DIR) -> Optional[dict]:
    """The peak rates of a device by its name, or ``None`` if not listed."""
    with open(bench_dir / "peaks.json") as f:
        return json.load(f).get(kind)
