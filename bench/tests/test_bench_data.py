"""The benchmark loads as data: every cell, configuration, mix and
metric of BENCHMARK.json is a file found by name, and a file added with
an entry is found the same way."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench(root=ROOT):
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def test_benchmark_keys_and_names(root=ROOT):
    b = bench(root)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
             + [w["traffic"] for w in b["workloads"]])
    assert all(NAME.match(n) for n in names), names
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
    lines = ([c["source"] for c in b["configs"]]
             + [x["why"] for x in b["configs"] + b["workloads"]]
             + [m["layer"] for m in b["per_layer"]] + b["command"])
    assert all(0 < len(s) <= 200 and "\n" not in s and "\t" not in s
               for s in lines)
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e


def test_every_cell_loads_with_its_files(root=ROOT):
    from bench.harness import spec

    b = bench(root)
    used = set()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"], root)
        used.add(w["config"])
        assert cell.chips in (1, 4)
        for kind in ("inputs", "reference", "work"):
            assert cell.module(kind) is not None
        assert hasattr(cell.system(), "System")
        # a test run's size changes only numbers the configuration has
        assert set(cell.config["test_size"]) <= set(cell.config)
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(spec.reader(cell, m["name"]), "read")
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(cell.config["check"]) and all(
            v is not None for v in cell.config["check"].values())
        # a CPU run compares every number the card does, never looser
        small = cell.config["test_size"].get("check", cell.config["check"])
        assert set(small) == set(cell.config["check"])
        assert all(small[k] <= cell.config["check"][k] for k in small)
    assert used == {c["name"] for c in b["configs"]}
    # four cards only for a quarter of the cells, rounded down, or one
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(len(b["workloads"]) // 4, 1)


def test_config_files_lie_under_paths_and_list_their_cuts(root=ROOT):
    b = bench(root)
    for c in b["configs"]:
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        with open(root / c["file"]) as f:
            data = json.load(f)
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["assumed"]


@pytest.mark.parametrize("kind", ["traffic", "metric", "config", "system"])
def test_an_added_file_is_found_by_name(tmp_path, kind):
    """A later PR adds a mix, a metric or a configuration as files and an
    entry in BENCHMARK.json, and edits no file that is there."""
    from bench.harness import spec

    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    cell = dict(b["workloads"][0])
    if kind == "traffic":
        traffic = tmp_path / "bench" / "traffic"
        with open(traffic / f"{cell['traffic']}.json") as f:
            mix = json.load(f)
        mix["clients"] = 3
        (tmp_path / "bench" / "traffic" / "later-mix.c3.json").write_text(
            json.dumps(mix))
        cell.update(name="matmul-t1.later", traffic="later-mix.c3")
    elif kind == "metric":
        (tmp_path / "bench" / "metrics" / "later.metric_ms.py").write_text(
            "def read(run):\n    return 42.0\n")
        b["per_layer"].append({"name": "later.metric_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "whole launch",
                               "moves": "items_per_s",
                               "workloads": ["matmul-t1.later"]})
        cell.update(name="matmul-t1.later")
    else:
        with open(ROOT / "bench" / "configs" / "matmul-t1.json") as f:
            config = json.load(f)
        config["name"] = "matmul-later"
        if kind == "system":
            (tmp_path / "bench" / "systems" / "later.py").write_text(
                "class System:\n    pass\n")
            config["system"] = "later"
        (tmp_path / "bench" / "configs" / "matmul-later.json").write_text(
            json.dumps(config))
        b["configs"].append({"name": "matmul-later", "source": "x",
                             "file": "bench/configs/matmul-later.json",
                             "reduced": [], "why": "x"})
        cell.update(name="matmul-t1.later", config="matmul-later")
    b["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    loaded = spec.load_cell("matmul-t1.later", tmp_path)
    assert loaded.bench_dir == tmp_path / "bench"
    if kind == "traffic":
        assert loaded.traffic["clients"] == 3
    elif kind == "metric":
        names = [m["name"] for m in loaded.per_layer]
        assert "later.metric_ms" in names
        assert spec.reader(loaded, "later.metric_ms").read(None) == 42.0
    else:
        assert loaded.config["name"] == "matmul-later"
        assert (loaded.system().System.__module__.endswith("later")
                == (kind == "system"))


def test_unknown_cell_is_refused():
    from bench.harness import spec

    with pytest.raises(KeyError):
        spec.load_cell("no-such.cell", ROOT)
