"""Model FLOPs of Caduceus-PS, counted from the layer equations.

Per token and strand, per layer: the in / out projections, and per
direction the depthwise conv, the input-dependent projections (Mamba-1)
and the recurrence itself: Mamba-1 six operations per (channel, state)
(decay times state, the B input term, the C read-out), Mamba-2 five per
(head channel, state) and head (no per-channel decay). Both directions,
both strands and the LM head or the classifier's pooled head. Elementwise
work (norms, gates, softplus) is left out. A training step is three
forward passes' worth (forward, and twice that for the backward);
recomputing the forward under remat is not counted, as it is not model
work.
"""

from __future__ import annotations

import math


def _dims(cfg: dict):
    s = cfg["ssm_cfg"]
    d = cfg["d_model"]
    di = s.get("expand", 2) * d
    return s, d, di, s["d_state"], s.get("d_conv", 4)


def layer_flops_per_token(cfg: dict) -> float:
    """Forward FLOPs of one layer for one token of one strand."""
    s, d, di, N, K = _dims(cfg)
    if s["version"] == 1:
        dt_rank = s.get("dt_rank", "auto")
        R = math.ceil(d / 16) if dt_rank == "auto" else int(dt_rank)
        proj = 2 * d * 2 * di + 2 * di * d
        direction = (2 * K * di + 2 * di * (R + 2 * N) + 2 * R * di
                     + 6 * di * N + 2 * di)
    else:
        NG, H = s["ngroups"], di // s["headdim"]
        wc = di + 2 * NG * N
        proj = 2 * d * (di + wc + H) + 2 * di * d
        direction = 2 * K * wc + 5 * di * N + 2 * di
    return proj + 2 * direction


def forward_flops(cfg: dict, rows: int, L: int, head: str) -> float:
    """Forward FLOPs of ``rows`` sequences of ``L`` tokens, both strands;
    ``head`` is "mlm" (the tied LM head on every position), "classifier"
    (one pooled row per sequence and strand, 2 labels) or "none"."""
    V = cfg.get("padded_vocab_size", 16)
    tokens = rows * L
    total = 2 * tokens * cfg["n_layer"] * layer_flops_per_token(cfg)
    if head == "mlm":
        total += 2 * tokens * 2 * cfg["d_model"] * V
    elif head == "classifier":
        total += 2 * rows * 2 * cfg["d_model"] * 2
    return total


def train_flops(cfg: dict, rows: int, L: int, head: str) -> float:
    return 3 * forward_flops(cfg, rows, L, head)
