"""Input encoders: the reference's encoder registry.

Port of `caduceus_tpu/models/encoders.py` (`:26-101`) and its factory
`make_encoder` (`:103`). An encoder's output feeds
`CaduceusBackbone(inputs_embeds=...)` in place of the backbone's own
token embedding (non-RCPS models only). Under context parallelism every
rank runs the encoder on the whole ids and the backbone keeps the rank's
columns of its output, so an encoder parameter's gradient on a rank comes
from that rank's columns only; the trainer's all-reduce of the gradients
over the ranks gives it its whole gradient. Parameter names are the flax ones:
``embedding`` (n_tokens, d_model) and ``proj.{weight,bias}`` (flax
``proj/{kernel,bias}``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from caduceus_tpu_torch.models.caduceus import _Embedding


def _lecun_dense(d_in: int, d_out: int, bias: bool,
                 generator: Optional[torch.Generator]) -> nn.Linear:
    """An `nn.Linear` with flax's Dense init: a truncated normal of
    variance 1/fan_in for the weight, zero bias."""
    lin = nn.Linear(d_in, d_out, bias=bias)
    std = math.sqrt(1.0 / d_in) / 0.87962566103423978
    with torch.no_grad():
        w = torch.empty(d_out, d_in).normal_(0.0, 1.0, generator=generator)
        lin.weight.copy_(w.clamp_(-2.0, 2.0) * std)
        if bias:
            lin.bias.zero_()
    return lin


class IdentityEncoder(nn.Module):
    """``id`` / ``stop``."""

    def forward(self, x):
        return x


class EmbeddingEncoder(nn.Module):
    """(B, L) int ids → (B, L, d_model) through a table of its own."""

    def __init__(self, n_tokens: int, d_model: int, init_std: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n_tokens, d_model).normal_(
            0.0, init_std, generator=generator))

    def forward(self, x):
        # the backbone's lookup, whose weight gradient adds in a fixed order
        return _Embedding.apply(x.long(), self.embedding)


class LinearEncoder(nn.Module):
    """(B, L, d_input) float features → (B, L, d_model)."""

    def __init__(self, d_input: int, d_model: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = _lecun_dense(d_input, d_model, use_bias, generator)

    def forward(self, x):
        return self.proj(x.float())


class OneHotEncoder(nn.Module):
    """Token ids → one-hot floats."""

    def __init__(self, n_tokens: int):
        super().__init__()
        self.n_tokens = n_tokens

    def forward(self, x):
        return F.one_hot(x.long(), self.n_tokens).float()


class SequentialEncoder(nn.Module):
    """Encoders applied in order."""

    def __init__(self, encoders: Sequence[nn.Module]):
        super().__init__()
        self.encoders = nn.ModuleList(encoders)

    def forward(self, x):
        for enc in self.encoders:
            x = enc(x)
        return x


class OneHotLinearEncoder(nn.Module):
    """One-hot ids → a linear projection to d_model."""

    def __init__(self, n_tokens: int, d_model: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_tokens = n_tokens
        self.proj = _lecun_dense(n_tokens, d_model, True, generator)

    def forward(self, x):
        return self.proj(F.one_hot(x.long(), self.n_tokens).float())


def make_encoder(kind: Optional[str], d_model: Optional[int] = None,
                 n_tokens: Optional[int] = None,
                 d_input: Optional[int] = None,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """The encoder of registry key ``kind`` (id / stop / identity,
    embedding, linear, onehot; onehot with ``d_model`` projects)."""
    if kind in ("id", "stop", "identity", None):
        return IdentityEncoder()
    if kind == "embedding":
        assert n_tokens is not None and d_model is not None
        return EmbeddingEncoder(n_tokens, d_model, generator=generator)
    if kind == "linear":
        assert d_input is not None and d_model is not None
        return LinearEncoder(d_input, d_model, generator=generator)
    if kind == "onehot":
        assert n_tokens is not None
        if d_model is None:
            return OneHotEncoder(n_tokens)
        return OneHotLinearEncoder(n_tokens, d_model, generator=generator)
    raise KeyError(f"unknown encoder: {kind!r}")


get_encoder = make_encoder
