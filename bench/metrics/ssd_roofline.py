"""ssd_roofline (kernels): the Mamba layers' prefill scans (the work
module's ``ssd`` part) at the roofline over the device seconds of the
linear-attention kernel's tensor-core path (``linear_tc_kernel``), in
percent."""
from bench.harness.roofline import launch_share


def read(run):
    return launch_share(run, "linear_tc_kernel", "ssd")
