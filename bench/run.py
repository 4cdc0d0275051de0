#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with a CUDA card. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the check compared,
beside its limit; the same numbers are the last lines of standard error.

Exit codes: 0 with a result; 2 without a CUDA card, or with fewer cards
than the cell asks for; 3 when ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed; 4 when the port is not
beside the benchmark (``src/repro_torch``). None of these prints a result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules) -> list:
    """The forbidden top-level names among ``modules``' keys, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in modules}
                  & set(FORBIDDEN))


def cache_dirs(root: pathlib.Path) -> dict:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernel library builds into ``build/kernels/``)."""
    build = root / "build"
    return {"TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "TRITON_CACHE_DIR": str(build / "triton"),
            "CUDA_CACHE_PATH": str(build / "cuda_cache"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="cell name")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.update(cache_dirs(ROOT))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness import check, spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is false; the benchmark "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"bench: no src/repro_torch under {ROOT}: the port is not "
              f"beside the benchmark", file=sys.stderr)
        return 4
    from bench.harness.runner import run

    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 setup_t0=T0)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"bench: loaded in the run's process: {found}",
              file=sys.stderr)
        return 3
    print(f"bench diagnostics {json.dumps(result.pop('_diagnostics'))}",
          file=sys.stderr)
    for line in check.lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
