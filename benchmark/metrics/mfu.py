"""Model FLOPs of the stretch (`flops.py`) over its length, against 989 TFLOP/s bf16."""

from benchmark.metrics._lib import mfu


def read(view):
    return mfu(view)
