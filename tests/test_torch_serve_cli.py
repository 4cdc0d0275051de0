"""The port's serve CLI against the reference's: specs, listings, rows.

* Every argv of ``tests/test_api_cli.py``'s serve cases folds into a spec
  whose JSON equals the reference's, and spec → argv → spec is the
  identity with the argv itself equal to the reference's. That holds for
  each ``--kernel-impl`` the reference serves (``pallas``, ``xla``,
  ``ref``), whose spec builds that variant of its kernel; an impl
  neither package has is refused by both parsers.
* ``default_serve_spec`` differs from the reference's in one section,
  ``units``, and there in three fields: ``kinds`` (the devices [cuda:0,
  cpu] decide them here; the reference names two faked CPU units),
  ``speed_hints`` and ``dist`` (none here: the real path measures the
  shares on the devices; the reference's (0.4, 0.6) and 0.4 were set for
  two faked CPU units).
* ``registry_listing`` equals the reference's string for string, its
  ``analysis:`` section (the port's own static-analysis passes) included.
* The DES rows (``coexec_sim_rows``, ``coexec_multi_rows``,
  ``traffic_rows``, ``cluster_rows``) equal the reference's row for row,
  and ``main`` prints what the reference prints for ``--coexec sim`` and
  ``--spec-json``; those times are virtual seconds of the paper testbed.
* The real path ``coexec_real_rows`` on two ``cpu`` units serves every
  request, each output within its kernel's tolerance of the plain
  version, under shares measured on the units; ``--coexec real`` without
  CUDA is a usage error, never a quiet CPU-only run.
"""
import argparse
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.api as ref_api
import repro.core.sim as ref_sim_module
import repro.launch.serve as ref_serve
import repro_torch.api as api
import repro_torch.launch.serve as serve
from repro_torch.core import counits_from_devices
from repro_torch.kernels import (demo_spheres, gaussian_blur_halo_plain,
                                 mandelbrot_plain, matmul_plain, rap_plain,
                                 raytrace_plain, taylor_sin_plain)

PLAN = "benchmarks/failure_plans/example_plan.json"
SERVE_STYLE_ARGV = [
    [],
    ["--policy", "work_stealing", "--n", "16384"],
    ["--admission", "wfq", "--fuse", "--tenants", "16"],
    ["--policy", "dynamic", "--scheduler-opt", "num_packages=32",
     "--granularity", "64"],
    ["--workload", "mandelbrot", "--size-scale", "0.5",
     "--memory", "buffers"],
    ["--kernel", "rap", "--memory", "buffers", "--n", "2048"],
    ["--units", "2", "--unit-kinds", "cpu,gpu", "--speed-hints", "0.4,0.6",
     "--dist", "0.35"],
    ["--max-inflight", "8", "--fuse-threshold", "2048", "--fuse-limit",
     "16", "--fuse-wait-s", "0.0", "--quantum", "512"],
    ["--requests", "4", "--concurrent", "2"],
]
REFERENCE_ONLY_IMPLS = [
    ["--kernel-impl", "pallas", "--kernel", "taylor"],
    ["--kernel-impl", "ref", "--workload", "gaussian"],
    ["--kernel-impl", "xla", "--kernel", "rap"],
]
TOL = {"taylor": (1e-5, 1e-6), "gaussian": (1e-5, 1e-6),
       "matmul": (1e-5, 1e-6 * 32), "mandelbrot": (0.0, 0.0),
       "ray": (0.0, 1e-4), "rap": (1e-5, 1e-6 * 48)}


@pytest.fixture(autouse=True)
def reference_prefix_cache_holds_its_workloads(monkeypatch):
    """Run the reference's DES with a cost-prefix cache that holds each
    workload, as the port's does. The reference keys the cache by id()
    alone (ROADMAP queue 3): a fused batch's workload freed after its
    launch lets a later one reuse the id and read a stale prefix, which
    fails or skews a fused replay now and then. The arithmetic is the
    reference's own ``_item_costs``."""
    def prefix_for(self, wl, u):
        key = (id(wl), u.name)
        if key not in self._prefix:
            self._prefix[key] = (wl, ref_sim_module._item_costs(wl, u))
        return self._prefix[key][1]

    monkeypatch.setattr(ref_sim_module.SimBackend, "_prefix_for",
                        prefix_for)


def spec_pair(argv, base=None, ref_base=None):
    """(port spec, reference spec) parsed from the same argv."""
    got = api.spec_from_args(serve.build_parser().parse_args(argv),
                             base=base)
    want = ref_api.spec_from_args(ref_serve.build_parser().parse_args(argv),
                                  base=ref_base)
    return got, want


@pytest.mark.parametrize("argv", SERVE_STYLE_ARGV)
def test_cli_round_trip_equals_reference(argv):
    spec, ref_spec = spec_pair(argv)
    assert spec.to_json() == ref_spec.to_json()
    argv2 = api.args_from_spec(spec)
    assert argv2 == ref_api.args_from_spec(ref_spec)
    assert api.spec_from_args(serve.build_parser().parse_args(argv2)) == spec
    spec.validate()


# the default units' fields that differ: (flag, port, reference)
UNIT_DIFFS = {"kinds": ("--unit-kinds", [], ["cpu", "cpu"]),
              "speed_hints": ("--speed-hints", [], [0.4, 0.6]),
              "dist": ("--dist", [], [0.4])}


def pop_unit_diffs(got: dict, want: dict, argv=()) -> None:
    """Drop (after checking) the default units' fields argv leaves."""
    for field, (flag, port, ref) in UNIT_DIFFS.items():
        if flag not in argv:
            assert got["units"].pop(field) == port, field
            assert want["units"].pop(field) == ref, field


@pytest.mark.parametrize("argv", SERVE_STYLE_ARGV)
def test_cli_round_trip_over_the_serve_base_equals_reference(argv):
    spec, ref_spec = spec_pair(argv, serve.default_serve_spec(),
                               ref_serve.default_serve_spec())
    got, want = spec.to_dict(), ref_spec.to_dict()
    pop_unit_diffs(got, want, argv)
    assert got == want
    argv2 = api.args_from_spec(spec, base=serve.default_serve_spec())
    assert api.spec_from_args(serve.build_parser().parse_args(argv2),
                              base=serve.default_serve_spec()) == spec


@pytest.mark.parametrize("argv", REFERENCE_ONLY_IMPLS)
def test_reference_only_kernel_impls_are_rejected(argv, capsys):
    """The reference's implementation variants, once refused by the port,
    are served by it: each argv folds into the reference's spec, which
    validates in both packages and builds that variant of its kernel.
    Only an impl neither package serves is still rejected, by both."""
    impl = argv[1]
    spec, ref_spec = spec_pair(argv)
    ref_spec.validate()
    spec.validate()
    assert spec.to_dict() == ref_spec.to_dict()
    assert spec.workload.kernel_impl == impl
    assert api.args_from_spec(spec) == ref_api.args_from_spec(ref_spec)
    loaded = api.CoexecSpec.from_json(ref_spec.to_json())
    loaded.validate()
    assert loaded == spec
    assert loaded.build_kernel() is api.build_kernel(
        spec.workload.resolve_kernel(), impl=impl)
    bad = ["--kernel-impl", "opencl", *argv[2:]]
    for parser in (serve.build_parser(), ref_serve.build_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(bad)
        assert "invalid choice: 'opencl'" in capsys.readouterr().err


def test_default_serve_spec_differs_only_in_units():
    got = serve.default_serve_spec().to_dict()
    want = ref_serve.default_serve_spec().to_dict()
    assert got.keys() == want.keys()
    for section in got:
        if section != "units":
            assert got[section] == want[section], section
    diff = {k for k in got["units"] if got["units"][k] != want["units"][k]}
    assert diff == set(UNIT_DIFFS)
    pop_unit_diffs(got, want)
    assert got["units"] == want["units"]
    assert got["units"]["count"] == 2


def test_registry_listing_is_the_reference():
    got = api.registry_listing()
    want = ref_api.registry_listing()
    assert got == want
    assert got.splitlines()[0] == "schedulers:"
    assert "workloads:" in got and "kernels:" in got
    tail = got.split("\nanalysis:\n")[1].splitlines()
    assert [line.split()[0] for line in tail] == [
        "consistency", "determinism", "exceptions", "locks"]


def rows_json(rows) -> str:
    # NaN-safe exact comparison: equal floats print equal text
    return json.dumps(rows, sort_keys=True)


@pytest.mark.parametrize("argv", [
    [], ["--workload", "rap", "--memory", "buffers", "--granularity", "4"],
    ["--workload", "taylor", "--policy", "dynamic", "--scheduler-opt",
     "num_packages=32", "--pipeline-depth", "2"],
])
def test_coexec_sim_rows_equal_reference(argv):
    spec, ref_spec = spec_pair(argv, serve.default_serve_spec(),
                               ref_serve.default_serve_spec())
    got = serve.coexec_sim_rows(spec)
    assert rows_json(got) == rows_json(ref_serve.coexec_sim_rows(ref_spec))
    assert got


def test_coexec_multi_rows_equal_reference():
    spec, ref_spec = spec_pair(["--workload", "mandelbrot"],
                               serve.default_serve_spec(),
                               ref_serve.default_serve_spec())
    kw = dict(tenants=(1, 4), per_tenant_items=256, num_packages=8,
              admissions=("fifo", "wfq"), fuse_modes=(False, True),
              preempt_modes=(False, True),
              policies=("dynamic", "hguided"))
    got = serve.coexec_multi_rows(spec, **kw)
    assert rows_json(got) == rows_json(
        ref_serve.coexec_multi_rows(ref_spec, **kw))
    assert any(r["fused_batches"] for r in got)


def test_traffic_rows_equal_reference():
    argv = ["--workload", "taylor", "--tenants", "4", "--n", "4096",
            "--slo-ms", "50", "--arrival", "poisson", "--arrivals", "40",
            "--traffic-seed", "2"]
    spec, ref_spec = spec_pair(argv, serve.default_serve_spec(),
                               ref_serve.default_serve_spec())
    kw = dict(loads=(0.8, 1.6), arrival_kinds=("poisson", "burst"),
              admissions=({"policy": "wfq", "preempt": True},
                          {"policy": "edf", "preempt": True, "shed": True}))
    got = serve.traffic_rows(spec, **kw)
    assert len(got) == 8
    assert rows_json(got) == rows_json(ref_serve.traffic_rows(ref_spec, **kw))
    assert rows_json(serve.traffic_tenant_rows(spec)) == \
        rows_json(ref_serve.traffic_tenant_rows(ref_spec))


def test_cluster_rows_equal_reference():
    argv = ["--cluster", "--cluster-min-units", "2", "--cluster-max-units",
            "4", "--cluster-failure-plan", PLAN, "--n", "16384",
            "--arrivals", "96"]
    spec, ref_spec = spec_pair(argv, serve.default_serve_spec(),
                               ref_serve.default_serve_spec())
    got = serve.cluster_rows(spec)
    assert rows_json(got) == rows_json(ref_serve.cluster_rows(ref_spec))
    (row,) = got
    assert row["lost"] == 0 and row["duplicated"] == 0
    assert row["reissued"] > 0 and row["kills"] == 2


def run_main(module, argv, monkeypatch, capsys):
    if module is serve:
        serve.main(argv)
    else:
        monkeypatch.setattr(sys, "argv", ["serve", *argv])
        ref_serve.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--coexec", "sim", "--policy", "all", "--workload", "mandelbrot"],
    ["--coexec", "sim", "--admission", "wfq", "--fuse", "--tenants", "16"],
    ["--coexec", "sim", "--arrival", "poisson", "--load", "1.2",
     "--admission", "edf", "--shed", "--arrivals", "128"],
    ["--coexec", "sim", "--cluster", "--cluster-min-units", "2",
     "--cluster-max-units", "4", "--cluster-failure-plan", PLAN, "--n",
     "16384", "--arrivals", "96"],
    ["--spec-json", "--unit-kinds", "cpu,cpu", "--speed-hints", "0.4,0.6",
     "--dist", "0.4"],
])
def test_main_prints_what_the_reference_prints(argv, monkeypatch, capsys):
    got = run_main(serve, argv, monkeypatch, capsys)
    want = run_main(ref_serve, argv, monkeypatch, capsys)
    assert got == want and got


def test_spec_json_differs_only_in_units(monkeypatch, capsys):
    got = json.loads(run_main(serve, ["--spec-json"], monkeypatch, capsys))
    want = json.loads(run_main(ref_serve, ["--spec-json"], monkeypatch,
                               capsys))
    pop_unit_diffs(got, want)
    assert got == want


def test_list_prints_the_listing(capsys):
    assert serve.main(["--list"]) is None
    assert capsys.readouterr().out.strip() == api.registry_listing()


def plain(name, inputs):
    """The kernel's plain version on the whole host input."""
    t = [torch.from_numpy(np.asarray(a)) for a in inputs]
    if name == "taylor":
        return taylor_sin_plain(t[0])
    if name == "gaussian":
        return gaussian_blur_halo_plain(F.pad(t[0], (0, 0, 2, 2)))
    if name == "matmul":
        return matmul_plain(*t)
    if name == "mandelbrot":
        return mandelbrot_plain(*t)
    if name == "ray":           # the scene is a broadcast default
        return raytrace_plain(*t[:3], torch.from_numpy(demo_spheres()))
    return rap_plain(*t)


@pytest.mark.parametrize("memory", ["usm", "buffers"])
@pytest.mark.parametrize("name", ["taylor", "gaussian", "matmul",
                                  "mandelbrot", "ray", "rap"])
def test_real_rows_serve_every_request_on_cpu_units(name, memory):
    spec = serve.default_serve_spec()
    # packages of 16 items or more: the plain versions cost a fixed
    # number of torch calls per package, whatever its size
    spec = spec.replace(
        workload=spec.workload.replace(kernel=name, items=300, requests=3,
                                       concurrent=2),
        scheduler=spec.scheduler.replace(granularity=16),
        memory=spec.memory.replace(model=memory))
    seen = []

    def check(policy, i, inputs, out):
        rtol, atol = TOL[name]
        want = plain(name, inputs).numpy()
        if name == "ray":           # a silhouette ray may flip (0.1 %)
            assert (np.abs(out - want) > atol).mean() <= 1e-3
        else:
            np.testing.assert_allclose(out, want, rtol=rtol, atol=atol)
        seen.append((policy, i))

    units = counits_from_devices(["cpu", "cpu"], speed_hints=(0.4, 0.6))
    rows = serve.coexec_real_rows(spec, units=units, on_result=check)
    policies = api.scheduler_names()
    assert [r["policy"] for r in rows] == list(policies)
    assert sorted(seen) == sorted((p, i) for p in policies for i in range(3))
    for row in rows:
        assert row["kernel"] == name and row["memory"] == memory
        assert row["requests"] == 3 and row["packages"] >= 3
        assert 0.0 <= row["device_idle_frac"] <= 1.0
        idle = row["unit_idle_frac"]
        assert list(idle) == ["cpu", "cpu#1"]
        assert all(0.0 <= v <= 1.0 for v in idle.values())
        assert len(row["dist"]) == 2 and min(row["dist"]) > 0
        assert sum(row["dist"]) == pytest.approx(1.0)
        assert row["dist"] == rows[0]["dist"]      # measured once a call
        assert row["host_overhead_frac"] >= 0.0
        assert row["p50_ms"] <= row["p99_ms"]
        assert (row["h2d_copies"] > 0) == (memory == "buffers")


def test_real_rows_keep_a_given_dist():
    """Shares are measured only when the spec gives none."""
    spec = serve.default_serve_spec()
    spec = spec.replace(
        workload=spec.workload.replace(kernel="taylor", items=64, requests=1,
                                       concurrent=1),
        units=spec.units.replace(dist=(0.4,)))
    units = counits_from_devices(["cpu", "cpu"])
    (row,) = serve.coexec_real_rows(spec, policies=("static",), units=units)
    assert row["dist"] == pytest.approx([0.4, 0.6])
    assert row["requests"] == 1


def test_coexec_real_without_cuda_is_a_usage_error(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--coexec", "real", "--n", "64", "--requests", "1"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "CUDA is not available" in err
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.coexec_real_rows(serve.default_serve_spec())


def test_lm_branch_takes_its_request_count_from_the_spec():
    args = serve.build_parser().parse_args(["--requests", "2"])
    assert isinstance(args, argparse.Namespace)
    spec = api.spec_from_args(args, base=serve.default_serve_spec())
    assert spec.workload.requests == 2
    assert args.arch == "qwen3-0.6b" and args.device == "cuda:0"
    assert args.arch == ref_serve.build_parser().parse_args([]).arch


def test_lm_branch_serves_an_encoder_decoder_through_prefill(monkeypatch,
                                                             capsys):
    """whisper-medium: each batch runs the encoder over zero frames through
    ``Model.prefill`` before decoding, as the reference's CLI does."""
    from repro_torch import models

    calls = []
    build = models.build_model

    def spy(cfg):
        model = build(cfg)
        prefill = model.prefill

        def counted(params, batch, cache):
            calls.append(tuple(batch["frames"].shape))
            assert not batch["frames"].any()
            return prefill(params, batch, cache)

        return dataclasses.replace(model, prefill=counted)

    monkeypatch.setattr(models, "build_model", spy)
    serve.main(["--arch", "whisper-medium", "--device", "cpu", "--requests",
                "3", "--batch", "2", "--prompt-len", "4", "--max-tokens",
                "2"])
    assert "3 requests, 18 tokens" in capsys.readouterr().out
    assert calls == [(2, 16, 64)] * 2
