#!/usr/bin/env python3
"""Read the control: the plain reference in the program's place, in the
nearest precision below the configuration's, through a whole run.

    python3 bench/control.py --workload <cell> --seeds 21,22,23 \
        [--seconds 3] [--precision tf32]

For each seed, one run of the cell as ``bench/run.py`` makes it (the
same inputs, clients, window, kept sample and check), with each launch's
output computed by the reference module in the lower precision (default:
the module's ``CONTROL``). Its ``correct`` has to come out false; the
numbers it reads set the upper ends of the check's limits. One JSON line
a seed. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--precision", default=None)
    p.add_argument("--devices", default=None,
                   help="comma-separated units' devices (default the mix's)")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness import runner, spec
    from bench.harness.control_system import ControlSystem

    cell = spec.load_cell(args.workload, ROOT)
    precision = args.precision or cell.module("reference").CONTROL
    devices = args.devices.split(",") if args.devices else None
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        res = runner.run(
            cell, seed, args.seconds, False, setup_t0=t, devices=devices,
            make_system=lambda c, i, n, d: ControlSystem(c, i, d, precision))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "precision": precision, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "compared": res["_diagnostics"]["compared"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
