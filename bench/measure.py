#!/usr/bin/env python3
"""Run one cell several times, each run its own process, and summarise.

    python3 bench/measure.py --workload <cell> --seeds 11,12,13 \
        --seconds 10 [--trace 0|1] [--out results.jsonl]

Each run is ``bench/run.py`` with one seed, in turn. Each result line is
appended to ``--out`` with its seed, exit code and standard error's last
lines; then each metric's median and spread (the distance between the
first and third quartiles over the median, ``statistics.quantiles(n=4)``)
are printed, with every check's largest reading. This is how the bounds
in ``BENCHMARK.json`` were measured.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench.harness.stats import spread  # noqa: E402


def summarise(rows: list) -> dict:
    """Per metric: runs, median, spread, min, max; per check: max."""
    values: dict = {}
    checks: dict = {}
    for row in rows:
        res = row.get("result") or {}
        for name, m in res.get("metrics", {}).items():
            values.setdefault(name, []).append(m["value"])
        for name, c in res.get("checks", {}).items():
            if c["value"] is not None:
                checks[name] = max(checks.get(name, 0.0), c["value"])
    out = {}
    for name, vs in values.items():
        entry = {"runs": len(vs), "median": statistics.median(vs),
                 "min": min(vs), "max": max(vs)}
        if len(vs) >= 2:
            entry["spread"] = spread(vs)
        out[name] = entry
    return {"metrics": out, "checks_max": checks,
            "correct": sum(bool((r.get("result") or {}).get("correct"))
                           for r in rows),
            "runs": len(rows)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, one run each")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", default=None, help="JSONL file to append to")
    args = p.parse_args(argv)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
             args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        last = proc.stdout.strip().splitlines()[-1:] if proc.stdout else []
        try:
            result = json.loads(last[0]) if last else None
        except json.JSONDecodeError:
            result = None
        row = {"workload": args.workload, "seed": seed, "trace": args.trace,
               "seconds": args.seconds, "rc": proc.returncode,
               "wall_s": time.perf_counter() - t, "result": result,
               "stderr_tail": proc.stderr[-3000:]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    print("summary " + json.dumps(summarise(rows)), flush=True)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
