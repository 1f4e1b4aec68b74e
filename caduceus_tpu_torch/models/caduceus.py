"""Caduceus: bidirectional, RC-equivariant Mamba-2 backbone + MLM head.

Port of `caduceus_tpu/models/caduceus.py` with **canonical-strand
batching** for RCPS: both strands are carried in their own canonical
orientation on a leading axis folded into the batch (G = 2B), so every
layer is the plain shared-weight BiMamba2 applied to a 2B batch. Flips
appear only at the boundaries:

- embedding: strand 1 embeds rc(input_ids);
- LM head: ``logits = h0 @ Wᵀ + flip_L(h1) @ W[comp]ᵀ``;
- reference-convention hidden states ``(B, L, 2d)`` for `Caduceus`.

The fused RCPS block frame is realized by ``fused_frame``: "conj"
(default — every other block runs F-conjugated through static weight
flips, zero data movement, one final `swap_rc` iff n_layer is odd) or
"data" (`swap_rc` of x and residual at every block). Both compute the
same function. Only the Mamba-2 mixer (``ssm_cfg.version == 2``) is
ported. ``cfg.remat`` checkpoints spans of ``cfg.remat_span`` blocks when
grad is enabled (training); inference runs under
``torch.inference_mode()`` and keeps nothing for a backward.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from caduceus_tpu_torch import resolve_device
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models.mamba2 import BiMamba2
from caduceus_tpu_torch.ops.norms import add_norm, layer_norm, rms_norm


def reverse_complement_ids(input_ids: torch.Tensor,
                           complement: torch.Tensor) -> torch.Tensor:
    """rc on token ids: flip length, then complement."""
    return complement[input_ids.flip(-1)]


def rc_hidden(x: torch.Tensor) -> torch.Tensor:
    """Flip the length (-2) and channel (-1) dims."""
    return x.flip(-2, -1)


def swap_rc(t: torch.Tensor) -> torch.Tensor:
    """The fused-frame involution in canonical-strand coordinates:
    exchange strand rows, reverse (L, d)."""
    half = t.shape[0] // 2
    return torch.cat([t[half:], t[:half]], dim=0).flip(-2, -1)


def collapse_strand_mean(h: torch.Tensor) -> torch.Tensor:
    """Reference-convention (…, L, 2d) RCPS hidden states → (…, L, d)
    strand mean (the VEP / serving convention)."""
    d = h.shape[-1] // 2
    return (h[..., :d] + h[..., d:].flip(-2, -1)) / 2


def canonical_to_reference(hidden: torch.Tensor) -> torch.Tensor:
    """(2, B, L, d) canonical → (B, L, 2d) ``[h_fwd, flip_LC(h_rc)]``."""
    return torch.cat([hidden[0], rc_hidden(hidden[1])], dim=-1)


def _complement(c: CaduceusConfig) -> torch.Tensor:
    cm = c.padded_complement_map()
    if cm is None:
        raise ValueError("RCPS requires a complement_map")
    return torch.tensor([cm[i] for i in range(c.padded_vocab_size)],
                        dtype=torch.long)


class CaduceusBlock(nn.Module):
    """Prenorm residual block: (add → norm) → BiMamba2; returns
    (mixer_out, residual). ``frame`` is "none", "conj" or "data" (see the
    module docstring)."""

    def __init__(self, cfg: CaduceusConfig, frame: str,
                 generator: torch.Generator):
        super().__init__()
        if frame not in ("none", "conj", "data"):
            raise ValueError(f"frame={frame!r}")
        self.cfg = cfg
        self.frame = frame
        self.norm_w = nn.Parameter(torch.ones(cfg.d_model))
        self.norm_b = (None if cfg.rms_norm
                       else nn.Parameter(torch.zeros(cfg.d_model)))
        self.mixer = BiMamba2(cfg, frame == "conj", generator)

    def forward(self, x, residual=None):
        c = self.cfg
        weight, bias = self.norm_w, self.norm_b
        if self.frame == "conj":
            weight = weight.flip(0)
            bias = None if bias is None else bias.flip(0)
        if self.frame == "data":
            x = swap_rc(x)
            residual = None if residual is None else swap_rc(residual)
        normed, residual = add_norm(
            x, weight, bias, residual=residual, eps=c.norm_epsilon,
            use_rms=c.rms_norm, residual_in_fp32=c.residual_in_fp32,
            prenorm=True)
        return self.mixer(normed), residual


def _run_blocks(blocks, h, residual):
    for block in blocks:
        h, residual = block(h, residual)
    return h, residual


class CaduceusBackbone(nn.Module):
    """Embeddings + n_layer blocks + final norm.

    Input (B, L) int ids. Output canonical hidden states — (B, L, d), or
    (2, B, L, d) for RCPS (index 1 = the RC strand in its own canonical
    orientation) — and the embedding table (for the tied LM head)."""

    def __init__(self, cfg: CaduceusConfig, generator: torch.Generator,
                 fused_frame: str = "conj"):
        super().__init__()
        if cfg.ssm_cfg.version != 2:
            raise NotImplementedError(
                "the port runs the Mamba-2 mixer (ssm_cfg.version=2) only")
        if fused_frame not in ("conj", "data"):
            raise ValueError(f"fused_frame={fused_frame!r}")
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty(
            cfg.padded_vocab_size, cfg.d_model,
            dtype=getattr(torch, cfg.param_dtype)).normal_(
                0.0, cfg.initializer_range, generator=generator))
        self.fused = cfg.rcps and cfg.fused_add_norm
        if not self.fused:
            frames = ["none"] * cfg.n_layer
        elif fused_frame == "data":
            frames = ["data"] * cfg.n_layer
        else:
            frames = ["conj" if i % 2 == 0 else "none"
                      for i in range(cfg.n_layer)]
        self.final_swap = (self.fused and fused_frame == "conj"
                           and cfg.n_layer % 2 == 1)
        self.layers = nn.ModuleList(
            CaduceusBlock(cfg, f, generator) for f in frames)
        self.norm_f_w = nn.Parameter(torch.ones(cfg.d_model))
        self.norm_f_b = (None if cfg.rms_norm
                         else nn.Parameter(torch.zeros(cfg.d_model)))
        if cfg.rcps:
            self.register_buffer("complement", _complement(cfg),
                                 persistent=False)

    def forward(self, input_ids: torch.Tensor):
        c = self.cfg
        dtype = getattr(torch, c.dtype)
        if c.rcps:
            ids = torch.stack(
                [input_ids, reverse_complement_ids(input_ids,
                                                   self.complement)])
        else:
            ids = input_ids[None]
        S, B, L = ids.shape
        h = F.embedding(ids.reshape(S * B, L), self.embedding.to(dtype))
        residual = None
        if c.remat and torch.is_grad_enabled():
            # gradient checkpointing per span of remat_span blocks
            # (`caduceus_tpu/models/caduceus.py:204-232`): only the span
            # boundaries' (h, residual) are kept; the span's forward runs
            # again in the backward
            span = max(1, c.remat_span)
            for i in range(0, len(self.layers), span):
                h, residual = checkpoint(_run_blocks, self.layers[i:i + span],
                                         h, residual, use_reentrant=False)
        else:
            for block in self.layers:
                h, residual = block(h, residual)
        final = h if residual is None else residual + h.to(residual.dtype)
        if self.final_swap:
            # the conjugated frame leaves the physical state at F^n(y_n):
            # odd n_layer owes one involution
            final = swap_rc(final)
        if c.residual_in_fp32:
            final = final.float()
        if c.rms_norm:
            h = rms_norm(final, self.norm_f_w, eps=c.norm_epsilon)
        else:
            h = layer_norm(final, self.norm_f_w, self.norm_f_b,
                           eps=c.norm_epsilon)
        h = h.to(dtype)
        h = h.reshape(S, B, L, c.d_model) if c.rcps else h.reshape(
            B, L, c.d_model)
        return h, self.embedding


class Caduceus(nn.Module):
    """Backbone model: reference-convention hidden states, (B, L, 2d) when
    rcps else (B, L, d)."""

    def __init__(self, cfg: CaduceusConfig, device="cuda",
                 generator: torch.Generator = None, fused_frame: str = "conj"):
        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator()
        self.cfg = cfg
        self.backbone = CaduceusBackbone(cfg, g, fused_frame)
        self.to(dev)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        h, _ = self.backbone(input_ids)
        return canonical_to_reference(h) if self.cfg.rcps else h


class CaduceusForMaskedLM(nn.Module):
    """MLM model; logits are always fp32. ``tie_word_embeddings`` shares
    the embedding table with the LM head. For RCPS the head is
    ``h0 @ Wᵀ + flip_L(h1) @ W[comp]ᵀ`` over the padded vocab."""

    def __init__(self, cfg: CaduceusConfig, device="cuda",
                 generator: torch.Generator = None,
                 tie_word_embeddings: bool = True,
                 fused_frame: str = "conj"):
        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator()
        self.cfg = cfg
        self.backbone = CaduceusBackbone(cfg, g, fused_frame)
        self.lm_head = None if tie_word_embeddings else nn.Parameter(
            torch.empty(cfg.padded_vocab_size, cfg.d_model,
                        dtype=getattr(torch, cfg.param_dtype)).normal_(
                0.0, cfg.initializer_range, generator=g))
        self.to(dev)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        h, embed = self.backbone(input_ids)
        W = (embed if self.lm_head is None else self.lm_head).to(h.dtype)
        if self.cfg.rcps:
            comp = self.backbone.complement
            logits = h[0] @ W.t() + h[1].flip(-2) @ W[comp].t()
        else:
            logits = h @ W.t()
        return logits.float()
