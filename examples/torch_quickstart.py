"""Quickstart on the PyTorch port: the paper's Listing 1 — SAXPY
co-executed on the card and the host CPU with the HGuided balancer,
configured declaratively through `repro_torch.api.CoexecSpec` (the spec
serializes to JSON, so the whole setup is a reproducible artifact).

    PYTHONPATH=src python examples/torch_quickstart.py            # cuda:0 + cpu
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.api import CoexecSpec
from repro_torch.core import CoexecutorRuntime, counits_from_devices


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0",
                    help="the unit beside the host CPU (cpu for a machine "
                         "without a CUDA card)")
    args = ap.parse_args(argv)
    n = 1 << 20
    data = np.arange(n, dtype=np.float32)
    datav = 3.0

    # Listing 1, declaratively: policy <hg>, CounitSet, dist(0.35), usm
    spec = (CoexecSpec.builder()
            .policy("hguided")                             # <hg>
            .dist(0.35)                                    # dist(0.35)
            .memory("usm")
            .build())
    # CounitSet: the card and the host CPU
    units = counits_from_devices([args.device, "cpu"])
    runtime = CoexecutorRuntime.from_spec(spec, units=units)

    def kernel(offset, chunk):                             # the lambda
        return chunk * datav

    out = runtime.launch(n, kernel, [data], granularity=128)
    np.testing.assert_allclose(out, data * datav)
    assert CoexecSpec.from_json(spec.to_json()) == spec    # lossless

    st = runtime.last_stats
    print(f"co-executed {n} work-items in {st.total_s * 1e3:.1f} ms "
          f"across {len(st.unit_busy_s)} unit(s), "
          f"{st.num_packages} packages")
    for name, busy in st.unit_busy_s.items():
        print(f"  {name}: busy {busy * 1e3:.1f} ms")
    runtime.shutdown()


if __name__ == "__main__":
    main()
