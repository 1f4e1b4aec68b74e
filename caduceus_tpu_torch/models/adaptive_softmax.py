"""Adaptive embedding and projected adaptive log-softmax (Transformer-XL).

Port of `caduceus_tpu/models/adaptive_softmax.py` (`AdaptiveEmbedding`
`:30`, `ProjectedAdaptiveLogSoftmax` `:67`), the reference's
`src/models/nn/adaptive_softmax.py` as its `AdaptiveLMTask` uses it; no
genomics config does. Cluster c covers ids [cutoff_c, cutoff_{c+1}) with
embedding width d_embed / div_val**c and, where that differs from d_proj,
a projection. As in the JAX module, every cluster computes on the whole
flattened batch under a mask (no data-dependent shapes) and the full
log-probability matrix is assembled before the targets are gathered.

The parameters carry the flax names (``emb_0``, ``proj_1``, ``out_0``,
``bias_0``, ``out_proj_1``, ``cluster_weight``, ``cluster_bias``,
``cluster_proj``) in the flax layouts, so `params.py from_jax_params(flat,
None, model=module)` loads a JAX module's parameters unchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn


def _spans(n_token: int, cutoffs: Sequence[int]
           ) -> Tuple[Tuple[int, int], ...]:
    ends = [0] + list(cutoffs) + [n_token]
    return tuple((ends[i], ends[i + 1]) for i in range(len(ends) - 1))


def _normal(shape, std: float, g: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).normal_(0.0, std, generator=g))


class AdaptiveEmbedding(nn.Module):
    """Per-cluster embedding tables of width d_embed / div_val**i,
    projected to d_proj and scaled by sqrt(d_proj)."""

    def __init__(self, n_token: int, d_embed: int, d_proj: int,
                 cutoffs: Sequence[int] = (), div_val: int = 1,
                 init_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.d_proj = d_proj
        self.spans = _spans(n_token, cutoffs)
        self.widths = [d_embed // div_val ** i
                       for i in range(len(self.spans))]
        for i, ((l, r), w) in enumerate(zip(self.spans, self.widths)):
            setattr(self, f"emb_{i}",
                    _normal((r - l, w), init_scale * w ** -0.5, g))
            if w != d_proj:
                setattr(self, f"proj_{i}",
                        _normal((w, d_proj), init_scale * 0.01, g))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(*ids.shape, self.d_proj, device=ids.device)
        for i, ((l, r), w) in enumerate(zip(self.spans, self.widths)):
            emb = getattr(self, f"emb_{i}")[(ids - l).clamp(0, r - l - 1)]
            if w != self.d_proj:
                emb = emb @ getattr(self, f"proj_{i}")
            mask = ((ids >= l) & (ids < r))[..., None]
            out = out + torch.where(mask, emb, 0.0)
        return out * self.d_proj ** 0.5


class ProjectedAdaptiveLogSoftmax(nn.Module):
    """Head cluster = the shortlist and one logit per tail cluster; a tail
    token's log-probability is its in-cluster log-probability plus its
    cluster's head log-probability. ``forward(hidden, target)`` gives the
    per-element negative log-likelihood (the reference's contract),
    `log_prob` the full (..., n_token) log-probabilities."""

    def __init__(self, n_token: int, d_embed: int, d_proj: int,
                 cutoffs: Sequence[int] = (), div_val: int = 1,
                 init_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.n_token, self.d_embed, self.d_proj = n_token, d_embed, d_proj
        self.spans = _spans(n_token, cutoffs)
        self.widths = [d_embed // div_val ** i
                       for i in range(len(self.spans))]
        for i, ((l, r), w) in enumerate(zip(self.spans, self.widths)):
            setattr(self, f"out_{i}",
                    _normal((r - l, w), init_scale * w ** -0.5, g))
            setattr(self, f"bias_{i}", nn.Parameter(torch.zeros(r - l)))
            if w != d_proj:
                setattr(self, f"out_proj_{i}",
                        _normal((d_proj, w), init_scale * 0.01, g))
        n_clusters = len(self.spans) - 1
        if n_clusters:
            self.cluster_weight = _normal((n_clusters, d_embed),
                                          init_scale * d_embed ** -0.5, g)
            self.cluster_bias = nn.Parameter(torch.zeros(n_clusters))
            if d_embed != d_proj:
                self.cluster_proj = _normal((d_proj, d_embed),
                                            init_scale * 0.01, g)

    def _cluster_logit(self, h: torch.Tensor, i: int) -> torch.Tensor:
        if self.widths[i] != self.d_proj:
            h = h @ getattr(self, f"out_proj_{i}")
        return h @ getattr(self, f"out_{i}").t() + getattr(self, f"bias_{i}")

    def log_prob(self, hidden: torch.Tensor) -> torch.Tensor:
        """(..., d_proj) -> (..., n_token) log-probabilities."""
        lead = hidden.shape[:-1]
        h = hidden.reshape(-1, self.d_proj).float()
        head = self._cluster_logit(h, 0)
        shortlist = self.spans[0][1]
        if len(self.spans) > 1:
            hw = h @ self.cluster_proj if self.d_embed != self.d_proj else h
            head = torch.cat([head, hw @ self.cluster_weight.t()
                              + self.cluster_bias], dim=-1)
        head_lp = torch.log_softmax(head, dim=-1)
        parts = [head_lp[:, :shortlist]]
        for i in range(1, len(self.spans)):
            tail_lp = torch.log_softmax(self._cluster_logit(h, i), dim=-1)
            parts.append(tail_lp + head_lp[:, shortlist + i - 1, None])
        return torch.cat(parts, dim=-1).reshape(*lead, self.n_token)

    def forward(self, hidden: torch.Tensor, target: torch.Tensor
                ) -> torch.Tensor:
        lp = self.log_prob(hidden)
        return -torch.gather(lp, -1, target[..., None].long())[..., 0]
