"""matmul_roofline (kernels): the SGEMM's share of its roofline, 2 M N K
operations of the CUDA unit's rows at 67 TFLOP/s over ``sgemm_kernel``'s
device seconds."""
from bench.harness.roofline import kernel_share


def read(run):
    return kernel_share(run, "sgemm_kernel")
