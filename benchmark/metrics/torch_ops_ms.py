"""Device time of the kernels that are not the program's own (cuBLAS, PyTorch's elementwise and reduction kernels, copies), per unit of work."""

from benchmark.metrics._lib import torch_ops_ms


def read(view):
    return torch_ops_ms(view)
