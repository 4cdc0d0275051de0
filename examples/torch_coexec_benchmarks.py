"""Co-execute the paper's benchmarks (real kernels, real threads) and
reproduce the scheduler comparison on a CUDA card and the host CPU, with
the PyTorch port.

Every kernel is resolved through the plugin registry
(`repro_torch.api.build_kernel`) and declares its own data semantics —
split arrays, broadcast operands, stencil halos — so the one loop below
drives all of them with no per-kernel glue; `--memory buffers` switches
the engine's data plane and the printed staging-copy counters show the
cost.

    PYTHONPATH=src python examples/torch_coexec_benchmarks.py [--n 16384]
    PYTHONPATH=src python examples/torch_coexec_benchmarks.py --device cpu
"""
import argparse
import time

from repro_torch.api import CoexecSpec, build_kernel, kernel_demo_inputs
from repro_torch.core import CoexecutorRuntime, counits_from_devices


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 14)
    ap.add_argument("--memory", choices=("usm", "buffers"), default="usm")
    ap.add_argument("--device", default="cuda:0",
                    help="the unit beside the host CPU (cpu for a machine "
                         "without a CUDA card)")
    args = ap.parse_args(argv)

    base = (CoexecSpec.builder()
            .units(count=2, speed_hints=(0.5, 0.5))
            .dist(0.5)
            .memory(args.memory)
            .build())
    # shared across policies (each unit warms a kernel once)
    units = counits_from_devices([args.device, "cpu"],
                                 speed_hints=base.units.speed_hints)
    for name in ("taylor", "mandelbrot", "ray", "rap"):
        kernel = build_kernel(name)
        ins = kernel_demo_inputs(name, args.n)
        print(f"== {name} ({args.n} items, {args.memory})")
        for policy in ("static", "dyn16", "hguided", "work_stealing"):
            spec = base.replace(
                scheduler=base.scheduler.replace(policy=policy))
            with CoexecutorRuntime.from_spec(spec, units=units) as rt:
                t0 = time.perf_counter()
                rt.launch(args.n, kernel, ins)
                dt = time.perf_counter() - t0
                st = rt.last_stats
            print(f"   {policy:8s}: {dt * 1e3:7.1f} ms, "
                  f"{st.num_packages:3d} packages, "
                  f"copies h2d={st.data.h2d_copies} "
                  f"d2h={st.data.d2h_copies}")


if __name__ == "__main__":
    main()
