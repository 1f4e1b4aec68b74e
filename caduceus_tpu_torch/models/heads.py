"""Sequence decoders (task heads).

Port of `caduceus_tpu/models/heads.py`:

- `restrict_sequence` (`:23`): the reference's restrict modes — last,
  first, sum, pool / mean / ragged (the length-aware mean), max — with
  optional per-example ``lengths`` for left- or right-padded batches
  (`lengths` masks count from the right under left padding);
- `SequenceDecoder` (`:63`): an `nn.Linear` over the restricted sequence,
  torch's default init over fan-in; a (B, L, d, 2) input (conjoined
  strands) scores both strands with the shared head and averages them.

The decoder pools in fp32: the JAX head's fp32 Dense promotes a bf16 input
before it multiplies, and the port takes the mean at that precision too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn


def restrict_sequence(x: torch.Tensor, mode: str = "pool",
                      lengths: Optional[torch.Tensor] = None,
                      padding_side: str = "right") -> torch.Tensor:
    """Reduce (B, L, d) over L by the reference's ``mode``."""
    B, L, d = x.shape
    mask = None
    if lengths is not None:
        pos = torch.arange(L, device=x.device)[None, :, None]
        n = lengths.to(x.device)[:, None, None]
        mask = pos >= (L - n) if padding_side == "left" else pos < n

    if mode == "last":
        if lengths is None or padding_side == "left":
            return x[:, -1]
        idx = (lengths.to(x.device).long() - 1).clamp(0, L - 1)
        return x[torch.arange(B, device=x.device), idx]
    if mode == "first":
        if lengths is None or padding_side == "right":
            return x[:, 0]
        idx = (L - lengths.to(x.device).long()).clamp(0, L - 1)
        return x[torch.arange(B, device=x.device), idx]
    if mode == "sum":
        return (x * mask).sum(dim=1) if mask is not None else x.sum(dim=1)
    if mode in ("pool", "mean", "ragged"):
        if mask is not None:
            denom = lengths.to(x.device).clamp(min=1)[:, None].to(x.dtype)
            return (x * mask).sum(dim=1) / denom
        return x.mean(dim=1)
    if mode == "max":
        return x.max(dim=1).values
    raise NotImplementedError(f"restrict mode {mode!r}")


class SequenceDecoder(nn.Module):
    """Linear head over a restricted sequence, with conjoin strand
    averaging (shared weights). Its parameters are
    ``output_transform.{weight,bias}`` (flax ``output_transform/{kernel,
    bias}``)."""

    def __init__(self, d_input: int, d_output: int, mode: str = "pool",
                 use_lengths: bool = False, padding_side: str = "right",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mode = mode
        self.use_lengths = use_lengths
        self.padding_side = padding_side
        self.output_transform = nn.Linear(d_input, d_output)
        # torch's nn.Linear default, U(±1/sqrt(fan_in)), from ``generator``
        bound = 1.0 / math.sqrt(d_input)
        with torch.no_grad():
            for p in self.output_transform.parameters():
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.float()
        if x.dim() == 4:  # (B, L, d, 2) conjoined strands
            # both channels share the padding side: the data layer takes the
            # reverse complement of the raw sequence before it pads
            pooled_f = restrict_sequence(x[..., 0], self.mode, lengths,
                                         self.padding_side)
            pooled_r = restrict_sequence(x[..., 1], self.mode, lengths,
                                         self.padding_side)
            return (self.output_transform(pooled_f)
                    + self.output_transform(pooled_r)) / 2
        return self.output_transform(
            restrict_sequence(x, self.mode, lengths, self.padding_side))
