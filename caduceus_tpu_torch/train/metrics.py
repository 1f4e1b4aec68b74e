"""Losses and metrics of the training and eval steps.

Port of `caduceus_tpu/train/metrics.py`: `cross_entropy_loss` (`:24`) and
`accuracy` (`:56`), masked cross-entropy in fp32 with ignore_index (the
reference's PAD = 4), optional per-position `loss_weights` and the
streaming ``loss_sum`` / ``count`` sums; `last_k_ppl` (`:73`) and
`per_token_ppl` (`:83`), the reference HG38Task eval metrics; and the
host-side accumulators `Perplexity` (`:129`) and `NumTokens` (`:172`). The
classification metrics of the registry come with fine-tuning.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def cross_entropy_loss(
    logits: torch.Tensor,                 # (..., V)
    targets: torch.Tensor,                # (...,) int
    ignore_index: int = 4,
    loss_weights: Optional[torch.Tensor] = None,
):
    """Returns (mean_loss, {"loss_sum", "count"}), all fp32 / int tensors.

    ``loss_weights`` reproduces the reference's weighted cross-entropy:
    weights normalized to sum 1 over the batch, ignored positions zeroed."""
    logits = logits.float()
    V = logits.shape[-1]
    l2 = logits.reshape(-1, V)
    tgt = targets.reshape(-1).long()
    mask = tgt != ignore_index
    safe = torch.where(mask, tgt, torch.zeros_like(tgt))
    logz = torch.logsumexp(l2, dim=-1)
    ll = logz - l2.gather(1, safe[:, None])[:, 0]
    count = mask.sum()
    if loss_weights is not None:
        w = loss_weights.reshape(-1).float() * mask
        w = w / torch.clamp(w.sum(), min=1e-8)
        loss = (ll * w).sum()
        return loss, {"loss_sum": loss * count, "count": count}
    loss_sum = (ll * mask).sum()
    mean = loss_sum / torch.clamp(count, min=1)
    return mean, {"loss_sum": loss_sum, "count": count}


def accuracy(logits: torch.Tensor, targets: torch.Tensor,
             ignore_index: Optional[int] = None) -> torch.Tensor:
    pred = logits.argmax(dim=-1).reshape(-1)
    tgt = targets.reshape(-1).long()
    if ignore_index is None:
        return (pred == tgt).float().mean()
    mask = tgt != ignore_index
    return ((pred == tgt) & mask).sum() / torch.clamp(mask.sum(), min=1)


def last_k_ppl(logits: torch.Tensor, targets: torch.Tensor, k: int = 512,
               ignore_index: int = 4):
    """Perplexity over the last k positions of each sequence
    (`src/tasks/metrics.py:90-119`); returns (ppl, {"loss_sum", "count"})."""
    loss, aux = cross_entropy_loss(logits[..., -k:, :], targets[..., -k:],
                                   ignore_index=ignore_index)
    return torch.exp(loss), aux


def per_token_ppl(logits: torch.Tensor, targets: torch.Tensor,
                  ignore_index: int = 4):
    """Per-position NLL, zero where ignored, and the mask (the host sums
    them across batches into the per-token ppl curve,
    `src/tasks/tasks.py:282-332`)."""
    logits = logits.float()
    tgt = targets.long()
    logz = torch.logsumexp(logits, dim=-1)
    safe = torch.where(tgt == ignore_index, torch.zeros_like(tgt), tgt)
    ll = logz - logits.gather(-1, safe[..., None])[..., 0]
    mask = tgt != ignore_index
    return ll * mask, mask


@dataclass
class Perplexity:
    """Streaming perplexity, exp of the count-weighted mean NLL
    (`src/tasks/torchmetrics.py:24-73`), fed with the steps' ``loss_sum``
    and ``count``."""

    loss_sum: float = 0.0
    count: float = 0.0

    def update(self, loss_sum, count) -> None:
        self.loss_sum += float(loss_sum)
        self.count += float(count)

    def compute(self) -> float:
        if self.count == 0:
            return float("nan")
        return float(np.exp(self.loss_sum / self.count))

    def reset(self) -> None:
        self.loss_sum = 0.0
        self.count = 0.0


@dataclass
class NumTokens:
    """Total non-ignored tokens seen (`src/tasks/torchmetrics.py:75-115`)."""

    count: float = 0.0

    def update(self, count) -> None:
        self.count += float(count)

    def compute(self) -> float:
        return self.count
