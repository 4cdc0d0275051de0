"""On the card: the program's spans and the device trace share one clock.

Under ``harness.trace.Tracer`` each ``sgemm_kernel`` the CUDA unit runs
lies inside its package's ``compute`` span (``LaunchStats.timeline()``)
widened by 1 ms, for at least 95 % of the packages. Skipped without a
CUDA card.

    python -m pytest -q -m cuda bench/tests/test_bench_spans_card.py
"""
from __future__ import annotations

import time

import pytest

from conftest import small_cell

SLACK_S = 1e-3


@pytest.mark.cuda
def test_each_sgemm_lies_inside_its_packages_compute_span(cuda_card):
    import torch

    from bench.harness.trace import Tracer

    cell = small_cell("matmul-t1.pair-usm")
    cell.config.update(M=2048, N=2048, K=2048)
    inputs = cell.module("inputs").make(cell.config, 1, 2**31 + 11, "cuda")
    total = cell.module("inputs").total(cell.config)
    system = cell.system().System(cell, inputs, total,
                                  cell.traffic["units"])
    system.start()
    try:
        system.submit(0).result(timeout=120)        # warm
        torch.cuda.synchronize()
        handles = []
        with Tracer() as tracer:
            t0 = time.perf_counter()
            for _ in range(4):
                handles.append(system.submit(0))
                handles[-1].result(timeout=120)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        kinds = list(system.unit_kinds().values())
    finally:
        system.close()
    trace = tracer.trace(t0, t1)
    kernels = sorted((s, e) for name, _, s, e in trace.events
                     if "sgemm_kernel" in name)
    computes = sorted((s.start, s.end) for h in handles
                      for s in h.stats.timeline()
                      if s.name == "compute" and kinds[s.unit] == "cuda")
    # one kernel a package, the unit's packages one after another
    assert len(kernels) == len(computes) > 0
    inside = [s - SLACK_S <= ks and ke <= e + SLACK_S
              for (ks, ke), (s, e) in zip(kernels, computes)]
    assert sum(inside) >= 0.95 * len(inside), list(zip(kernels, computes))
