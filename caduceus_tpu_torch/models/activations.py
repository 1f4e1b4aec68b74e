"""Activation registry: an owned copy of `caduceus_tpu/models/activations.py`
(`get_activation`), on torch tensors. ``"gelu"`` is the tanh approximation,
the default of `jax.nn.gelu`."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


def squared_relu(x):
    return torch.square(F.relu(x))


def laplace(x, mu: float = math.sqrt(0.5), sigma: float = math.sqrt(0.25)):
    return 0.5 * (1.0 + torch.erf((x - mu) / (sigma * math.sqrt(2.0))))


def glu(x, dim: int = -1):
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


def _identity(x):
    return x


_ACTIVATIONS = {
    None: _identity,
    "id": _identity,
    "identity": _identity,
    "linear": _identity,
    "none": _identity,
    "tanh": torch.tanh,
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "sqrelu": squared_relu,
    "laplace": laplace,
    "glu": glu,
}


def get_activation(name: Optional[str]) -> Callable:
    key = name.lower() if isinstance(name, str) else name
    if key not in _ACTIVATIONS:
        raise NotImplementedError(f"activation '{name}' not implemented")
    return _ACTIVATIONS[key]
