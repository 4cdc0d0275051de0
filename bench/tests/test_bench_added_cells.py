"""A configuration and its cells go in as new files and appended entries,
whatever system serves them.

A copy of ``BENCHMARK.json`` and ``bench/`` takes the files under
``planted/`` and the entries of ``planted/entries.json``, appended: a
second co-execution cell (a new mix), which also appends its name to the
``workloads`` of the metrics it shares with the first (``workloads_of``),
and a planted configuration whose
system (``systems/batched_model.py``) is not the co-execution runtime and
serves a plain-PyTorch two-layer model in batches, with weights that
every client shares. No file of the copy is edited, and no entry of
``BENCHMARK.json`` beyond names appended to a metric's ``workloads``. Both new cells then
pass every check the benchmark's own cells pass on the CPU.
"""
from __future__ import annotations

import json
import pathlib
import shutil

import pytest

import test_bench_control as control_tests
import test_bench_data as data_tests
import test_bench_harness as harness_tests
import test_bench_yardsticks as yardstick_tests
from conftest import ROOT, benchmark, cell_names, small_cell

PLANTED = pathlib.Path(__file__).resolve().parent / "planted"
ENTRIES = json.loads((PLANTED / "entries.json").read_text())
NEW_CELLS = [w["name"] for w in ENTRIES["workloads"]]
LISTS = ("configs", "workloads", "end_to_end", "per_layer")


def _files(folder: pathlib.Path) -> list:
    return sorted(p for p in folder.rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts)


def grow(root: pathlib.Path) -> pathlib.Path:
    """A copy of the benchmark at ``root`` with the planted files added,
    the planted entries appended to ``BENCHMARK.json``'s lists and the
    cells of ``workloads_of`` appended to those metrics' ``workloads``."""
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src in _files(PLANTED):
        if src.name == "entries.json":
            continue
        dst = root / "bench" / src.relative_to(PLANTED)
        assert not dst.exists(), f"{dst} is there already: not a new file"
        shutil.copy(src, dst)
    b = benchmark(root)
    for key in LISTS:
        b[key] = b[key] + ENTRIES.get(key, [])
    for m in b["per_layer"]:
        m["workloads"] = m["workloads"] + ENTRIES["workloads_of"].get(
            m["name"], [])
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=2))
    return root


@pytest.fixture(scope="module")
def grown(tmp_path_factory) -> pathlib.Path:
    return grow(tmp_path_factory.mktemp("grown"))


def test_the_copy_only_gained_files_and_appended_entries(grown):
    before, after = benchmark(ROOT), benchmark(grown)
    assert set(after) == set(before)
    for key, value in before.items():
        if key in LISTS:
            assert len(after[key]) >= len(value), key
            for old, new in zip(value, after[key]):
                # a metric's cells may grow at the end of its list
                grew = old.get("workloads")
                if grew is not None:
                    assert new["workloads"][:len(grew)] == grew, old
                    new = {**new, "workloads": grew}
                assert new == old, old
        else:
            assert after[key] == value, key
    for path in _files(ROOT / "bench"):
        assert (grown / path.relative_to(ROOT)).read_bytes() == \
            path.read_bytes(), path
    assert cell_names(grown) == cell_names(ROOT) + NEW_CELLS
    # the second co-execution cell reads the first cell's metrics too
    shared = small_cell("matmul-t1.pair-usm-c3", grown).per_layer
    assert {m["name"] for m in shared} >= set(ENTRIES["workloads_of"])


def test_the_planted_system_is_not_the_coexecution_runtime(grown):
    cell = small_cell("tiny-mlp.batch-c2", grown)
    system = cell.system().System
    assert cell.config["system"] != "coexec"
    assert not hasattr(system, "build_kernel")
    # its inputs live on the device as the model's tensors, with one set
    # of weights every client shares
    sets = cell.module("inputs").make(cell.config, 2, 5, "cpu")
    assert sets[0]["weights"] is sets[1]["weights"]


@pytest.mark.parametrize("check", [
    data_tests.test_benchmark_keys_and_names,
    data_tests.test_every_cell_loads_with_its_files,
    data_tests.test_config_files_lie_under_paths_and_list_their_cuts,
], ids=lambda f: f.__name__)
def test_the_grown_benchmark_loads_as_data(grown, check):
    check(root=grown)


@pytest.mark.parametrize("name", NEW_CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_new_cell_runs_correct_with_its_metrics(grown, name, trace):
    harness_tests.test_a_run_is_correct_and_reports_its_metrics(
        name, trace, root=grown)


@pytest.mark.parametrize("name", NEW_CELLS)
def test_a_new_cell_compares_every_kept_output(grown, name):
    harness_tests.test_every_kept_output_is_compared(name, root=grown)


@pytest.mark.parametrize("name", NEW_CELLS)
def test_a_new_cells_control_is_not_correct(grown, name):
    control_tests.test_the_control_is_not_correct(name, root=grown)


@pytest.mark.parametrize("name", NEW_CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_new_cells_broken_timed_path_is_not_correct(grown, name, fault):
    control_tests.test_a_broken_timed_path_is_not_correct(name, fault,
                                                          root=grown)


@pytest.mark.parametrize("name", NEW_CELLS)
def test_a_new_cells_f32_reference_is_correct(grown, name):
    control_tests.test_the_f32_reference_in_the_programs_place_is_correct(
        name, root=grown)


@pytest.mark.parametrize("name", NEW_CELLS)
def test_a_new_cells_seed_makes_its_inputs(grown, name):
    yardstick_tests.test_the_same_seed_makes_the_same_inputs(name,
                                                             root=grown)


def test_a_launch_share_reads_the_work_modules_counts(grown):
    """``roofline.launch_bound_s``/``launch_share`` on the planted cell:
    the whole launch's counts, or one kernel's part of them, at the
    roofline, over the named kernels' device seconds; ``launch_mfu`` is
    the whole launches' bound over the window."""
    from bench.harness import loop, roofline, runner, spec
    from bench.harness.trace import DeviceTrace

    cell = small_cell("tiny-mlp.batch-c2", grown)
    inputs = cell.module("inputs").make(cell.config, 2, 3, "cpu")
    total = cell.module("inputs").total(cell.config)
    recs = [loop.LaunchRecord(c, 0.1 * i, 0.1 * i, 0.1 * i + 0.05)
            for i, c in enumerate([0, 1, 1])]
    peaks = {"bf16_dense_flops_per_s": 1e9, "hbm_bytes_per_s": 1e8}
    trace = DeviceTrace(events=[("gemm_hidden", "kernel", 0.0, 0.02),
                                ("gemm_logits", "kernel", 0.1, 0.13)],
                        t_start=0.0, t_end=1.0)
    run = runner.RunRecord(
        cell=cell, setup_s=1.0,
        window=loop.Window(t_start=0.0, t_end=1.0, records=recs, kept={}),
        units=[("cuda:0", "cuda")], inputs=inputs, total=total,
        device="cpu", peaks=peaks, trace=trace)
    counter = cell.module("work").Counter(inputs[0])

    def bound(ops, nbytes):
        return max(ops / 1e9, nbytes / 1e8)

    assert roofline.launch_bound_s(run) == pytest.approx(
        3 * bound(*counter.count(0, total)))
    hidden = 3 * bound(*counter.count_part("hidden", 0, total))
    assert roofline.launch_bound_s(run, "hidden") == pytest.approx(hidden)
    assert roofline.launch_share(run, "gemm_hidden", "hidden") == \
        pytest.approx(100.0 * hidden / 0.02)
    assert roofline.launch_share(run, "no_such_kernel") is None
    mfu = spec.reader(cell, "launch_mfu")
    assert mfu.read(run) == pytest.approx(
        100.0 * 3 * bound(*counter.count(0, total)) / run.window.seconds)
    run.peaks = None
    assert mfu.read(run) is None
    assert roofline.launch_bound_s(run) is None
    assert roofline.launch_share(run, "gemm_hidden", "hidden") is None
