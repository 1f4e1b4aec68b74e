"""Losses and metrics of the training and eval steps.

Port of `caduceus_tpu/train/metrics.py`: `cross_entropy_loss` (`:24`) and
`accuracy` (`:56`), masked cross-entropy in fp32 with ignore_index (the
reference's PAD = 4), optional per-position `loss_weights` and the
streaming ``loss_sum`` / ``count`` sums; `accuracy_at_k` (`:65`);
`last_k_ppl` (`:73`) and `per_token_ppl` (`:83`), the reference HG38Task
eval metrics; `per_class_accuracy` (`:96`); and the host-side accumulators
`Perplexity` (`:129`) and `NumTokens` (`:172`); the classification metrics
`mcc`, `f1` and `roc_auc` (`:109-126`), which the JAX package takes from
scikit-learn, written here in numpy from their definitions (the
fine-tuning and VEP paths must not need scikit-learn, which the card's
machine does not have; tests/test_torch_finetune.py holds them against
scikit-learn); and the registry `output_metric_fns` (`:156-168`) with the
JAX keys over these.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

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


def accuracy_at_k(logits: torch.Tensor, targets: torch.Tensor,
                  k: int = 5) -> torch.Tensor:
    """The share of positions whose target is among the k largest
    logits."""
    V = logits.shape[-1]
    topk = logits.reshape(-1, V).topk(k, dim=-1).indices
    tgt = targets.reshape(-1).long()
    return (topk == tgt[:, None]).any(dim=-1).float().mean()


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


def per_class_accuracy(preds: np.ndarray, targets: np.ndarray,
                       num_classes: int) -> Dict[str, float]:
    """Accuracy within each class of ``targets`` (NaN for a class with no
    member), over all the predictions at once (`src/tasks/metrics.py:13-44`
    CorrectAggregatedMetric)."""
    preds = np.asarray(preds).ravel()
    targets = np.asarray(targets).ravel()
    out = {}
    for c in range(num_classes):
        m = targets == c
        out[f"acc_class_{c}"] = (float((preds[m] == c).mean()) if m.any()
                                 else float("nan"))
    return out


def _labels_and_index(*arrays):
    """The sorted union of the labels in ``arrays`` and each array as
    indices into it."""
    labels = np.unique(np.concatenate([np.asarray(a).ravel()
                                       for a in arrays]))
    return labels, [np.searchsorted(labels, np.asarray(a).ravel())
                    for a in arrays]


def _confusion(targets, preds):
    """(labels, C) with C[i, j] the count of target i predicted as j."""
    labels, (t, p) = _labels_and_index(targets, preds)
    c = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(c, (t, p), 1)
    return labels, c


def mcc(preds: np.ndarray, targets: np.ndarray) -> float:
    """Matthews correlation of the multiclass confusion matrix (Gorodkin's
    R_K; the binary phi coefficient for two classes); 0 where a margin is
    constant."""
    _, c = _confusion(targets, preds)
    c = c.astype(np.float64)
    t_sum, p_sum = c.sum(axis=1), c.sum(axis=0)
    n, correct = c.sum(), np.trace(c)
    cov_tp = correct * n - t_sum @ p_sum
    cov_pp = n * n - p_sum @ p_sum
    cov_tt = n * n - t_sum @ t_sum
    if cov_pp * cov_tt == 0:
        return 0.0
    return float(cov_tp / np.sqrt(cov_tt * cov_pp))


def f1(preds: np.ndarray, targets: np.ndarray,
       average: str = "binary") -> float:
    """F1 = 2·tp / (2·tp + fp + fn): of label 1 (``"binary"``), the mean
    over the labels present in either array (``"macro"``), or of the
    counts summed over those labels (``"micro"``); 0 where a label has no
    true or predicted member."""
    labels, c = _confusion(targets, preds)
    tp = np.diag(c).astype(np.float64)
    denom = c.sum(axis=0) + c.sum(axis=1)  # 2·tp + fp + fn
    per = np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)
    if average == "binary":
        if not set(labels.tolist()) <= {0, 1}:
            raise ValueError(f"binary f1 needs labels in {{0, 1}}, got "
                             f"{labels.tolist()}")
        hit = np.nonzero(labels == 1)[0]
        return float(per[hit[0]]) if len(hit) else 0.0
    if average == "macro":
        return float(per.mean())
    if average == "micro":
        return float(2 * tp.sum() / max(denom.sum(), 1))
    raise ValueError(f"average={average!r}")


def roc_auc(scores: np.ndarray, targets: np.ndarray) -> float:
    """Area under the ROC curve of binary ``targets`` as the Mann-Whitney
    statistic: the share of (positive, negative) pairs ranked in order,
    tied scores counted as half."""
    scores = np.asarray(scores, np.float64).ravel()
    targets = np.asarray(targets).ravel()
    classes = np.unique(targets)
    if len(classes) != 2:
        raise ValueError(f"ROC AUC needs two classes in targets, got "
                         f"{classes.tolist()}")
    pos = targets == classes[1]
    order = np.argsort(scores, kind="mergesort")
    s = scores[order]
    # average 1-based ranks over runs of tied scores
    starts = np.r_[0, np.nonzero(np.diff(s))[0] + 1]
    ends = np.r_[starts[1:], len(s)]
    ranks = np.empty(len(s))
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


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


def _acc_ii(logits, targets):
    return accuracy(logits, targets, ignore_index=4)


# the functional metric registry, with the JAX keys
# (`src/tasks/metrics.py:316-355`)
output_metric_fns = {
    "accuracy": accuracy,
    "accuracy_ignore_index": _acc_ii,
    "accuracy@5": lambda l, t: accuracy_at_k(l, t, 5),
    "accuracy@10": lambda l, t: accuracy_at_k(l, t, 10),
    "last_k_ppl": last_k_ppl,
    "mcc": mcc,
    "f1_binary": lambda p, t: f1(p, t, "binary"),
    "f1_macro": lambda p, t: f1(p, t, "macro"),
    "f1_micro": lambda p, t: f1(p, t, "micro"),
    "roc_auc": roc_auc,
    "per_class_accuracy": per_class_accuracy,
}
