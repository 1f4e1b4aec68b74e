"""Loss and accuracy of the MLM training step.

Port of `caduceus_tpu/train/metrics.py` `cross_entropy_loss` (`:24`) and
`accuracy` (`:56`): masked cross-entropy in fp32 with ignore_index (the
reference's PAD = 4), optional per-position `loss_weights`, and the
streaming ``loss_sum`` / ``count`` sums. The streaming Perplexity and the
host-side metric registry come with the `Trainer`.
"""

from __future__ import annotations

from typing import Optional

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
