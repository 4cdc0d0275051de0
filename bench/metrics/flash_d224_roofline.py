"""flash_d224_roofline (kernels): the hybrid applications' prefill
attention (the work module's ``flash_attention`` part) at the roofline
over the device seconds of the flash kernel's head-dim-224 instantiation
(``flash_tc_kernel<224>``), in percent."""
from bench.harness.roofline import launch_share


def read(run):
    return launch_share(run, "flash_tc_kernel<224>", "flash_attention")
