"""Serve many co-execution requests concurrently on one persistent engine
of the PyTorch port.

Demonstrates the engine lifecycle (start / submit / shutdown) and the
serving-shaped API: independent callers fire `launch_async` against the
same CoexecutorRuntime and their packages interleave on the shared
Coexecution Units (the card and the host CPU) — no per-launch thread
spawn, per-launch isolated stats. The whole setup is one declarative
`CoexecSpec` built fluently; swap the policy from the command line
without touching the engine code.

    PYTHONPATH=src python examples/torch_concurrent_requests.py [--requests 12]
    PYTHONPATH=src python examples/torch_concurrent_requests.py --device cpu
"""
import argparse
import threading
import time

import numpy as np

from repro_torch.api import CoexecSpec
from repro_torch.core import CoexecutorRuntime, counits_from_devices


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--n", type=int, default=1 << 15)
    ap.add_argument("--policy", default="work_stealing")
    ap.add_argument("--device", default="cuda:0",
                    help="the unit beside the host CPU (cpu for a machine "
                         "without a CUDA card)")
    args = ap.parse_args(argv)

    spec = (CoexecSpec.builder()
            .policy(args.policy)
            .units(count=2, speed_hints=(0.6, 0.4))
            .dist(0.6)
            .workload("taylor", items=args.n, requests=args.requests)
            .build())
    kernel = spec.build_kernel()        # resolved via the kernel registry
    units = counits_from_devices([args.device, "cpu"],
                                 speed_hints=spec.units.speed_hints)
    rng = np.random.default_rng(0)
    xs = [rng.uniform(-2, 2, args.n).astype(np.float32)
          for _ in range(args.requests)]

    with CoexecutorRuntime.from_spec(spec, units=units) as rt:
        rt.launch(args.n, kernel, [xs[0]])          # warm-up launch

        # many independent "callers" submit without blocking each other
        results = [None] * args.requests

        def caller(i: int) -> None:
            handle = rt.launch_async(args.n, kernel, [xs[i]])
            results[i] = (handle.result(), handle.stats)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(args.requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0

        for i, (out, stats) in enumerate(results):
            np.testing.assert_allclose(out, np.sin(xs[i]),
                                       rtol=1e-3, atol=1e-4)
            print(f"request {i:2d}: {stats.num_packages:3d} packages, "
                  f"{stats.total_s * 1e3:6.1f} ms wall")
        print(f"\n{args.requests} concurrent requests on "
              f"{len(rt.engine.units)} units in {dt:.3f}s "
              f"({args.requests / dt:.1f} req/s), policy={rt.policy}")
        print("engine board:", rt.engine.board.snapshot())


if __name__ == "__main__":
    main()
