"""The SSD kernels' share of their roofline: #1 `ssd_fused_fwd`, #3a `ssd_fused_bwd`, #3b `ssd_conv_bwd` (`csrc/ssd_fused_{fwd,bwd}.cu`)."""

from benchmark.metrics._lib import ssd_roofline


def read(view):
    return ssd_roofline(view)
