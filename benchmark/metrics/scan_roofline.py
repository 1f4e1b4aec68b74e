"""The selective-scan kernels' share of their roofline: #9 `bidir_scan_fwd` and #8 `selective_scan_bwd` (`csrc/selective_scan_{fwd,bwd}.cu`)."""

from benchmark.metrics._lib import scan_roofline


def read(view):
    return scan_roofline(view)
