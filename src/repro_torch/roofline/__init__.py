"""Cost accounting: analytic FLOPs and bytes per cell (``flops``) and the
three-term roofline on the H100's figures (``analysis``)."""
from .analysis import (HBM_BW, LINK_BW, PEAK_FLOPS, Roofline, TraceCounter,
                       collective_bytes)
from .flops import cell_bytes, cell_flops, forward_flops_per_token

__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "Roofline", "TraceCounter",
           "cell_bytes", "cell_flops", "collective_bytes",
           "forward_flops_per_token"]
