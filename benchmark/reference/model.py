"""Caduceus-PS (RCPS, bidirectional, tied "add") in plain PyTorch, fp32,
written for this benchmark from the model's equations. It takes a dict of
weights under the port's parameter names (the benchmark makes them from
the seed and hands the same dict to both sides) and imports nothing of
the program.

The two strands are carried as a batch of 2B rows: strand 1 embeds
rc(ids). Every block first applies the RCPS involution to both the hidden
state and the residual (swap the strand rows, reverse length and
channels), then adds, normalises (RMSNorm) and mixes. The mixer is the
Mamba-1 (`scan.py`) or Mamba-2 (`ssd.py`) block run left to right and, on
the reversed sequence, right to left with the second direction's own
conv / scan parameters and the shared in / out projections; the two
outputs are added. The MLM head is ``h0 Eᵀ + flip_L(h1) E[comp]ᵀ`` with
the embedding E tied.

``lowp=True`` rounds every operand of a matmul, of the conv and of the
scan to float8 e4m3 with a per-tensor scale first: the control that a
comparison has to fail.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.scan import selective_scan
from benchmark.reference.ssd import ssd

FP8_MAX = 448.0


def set_fp32_math() -> None:
    """Full fp32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, back in fp32; the
    gradient passes through as if unrounded (autograd does not carry one
    through a float8 cast)."""
    t = t.float()
    scale = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
    rounded = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (rounded - t.detach())


class Model:
    """The reference model of one configuration (``cfg``: the model
    section of a benchmark configuration file)."""

    def __init__(self, cfg: dict, weights: dict, lowp: bool = False):
        s = cfg["ssm_cfg"]
        if not (cfg["rcps"] and cfg["bidirectional"]
                and cfg["bidirectional_strategy"] == "add"
                and cfg["bidirectional_weight_tie"] and cfg["rms_norm"]
                and cfg.get("fused_add_norm", True)):
            raise ValueError("the reference covers RCPS, bidirectional, tied "
                             "'add' blocks with RMSNorm (fused frame)")
        self.cfg, self.w, self.lowp = cfg, weights, lowp
        self.version = s["version"]
        self.d = cfg["d_model"]
        self.di = s.get("expand", 2) * self.d
        self.N = s["d_state"]
        self.eps = cfg.get("norm_epsilon", 1e-5)
        if self.version == 2:
            self.P, self.NG = s["headdim"], s["ngroups"]
            self.H = self.di // self.P
        else:
            dt_rank = s.get("dt_rank", "auto")
            self.R = (math.ceil(self.d / 16) if dt_rank == "auto"
                      else int(dt_rank))
        V = self.w["backbone.embedding"].shape[0]
        cm = {int(k): int(v) for k, v in cfg["complement_map"].items()}
        self.comp = torch.tensor([cm.get(i, i) for i in range(V)],
                                 device=self.w["backbone.embedding"].device)

    # -- pieces ------------------------------------------------------------
    def q(self, t: torch.Tensor) -> torch.Tensor:
        return fp8_round(t) if self.lowp else t.float()

    def linear(self, x, w):
        return self.q(x) @ self.q(w).t()

    def conv_silu(self, x, w, b):
        """Depthwise causal conv, tap K-1 on the current row, then SiLU."""
        K = w.shape[0]
        xt = F.pad(self.q(x).transpose(1, 2), (K - 1, 0))
        y = F.conv1d(xt, self.q(w).t()[:, None, :], b.float(),
                     groups=x.shape[-1])
        return F.silu(y.transpose(1, 2))

    def rms(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * w.float()

    @staticmethod
    def swap_rc(t):
        half = t.shape[0] // 2
        return torch.cat([t[half:], t[:half]]).flip(1, 2)

    # -- mixers --------------------------------------------------------------
    def _v1_direction(self, p, xi):
        N, R = self.N, self.R
        u = self.conv_silu(xi, self.w[p + "conv_w"], self.w[p + "conv_b"])
        dbc = self.linear(u, self.w[p + "x_proj_w"].t())
        dt, B, C = dbc.split([R, N, N], dim=-1)
        delta = F.softplus(self.linear(dt, self.w[p + "dt_proj_w"].t())
                           + self.w[p + "dt_proj_b"].float())
        A = -torch.exp(self.w[p + "A_log"].float())
        y = selective_scan(self.q(u), delta, A, self.q(B), self.q(C))
        return y + u * self.w[p + "D"].float()

    def _v2_direction(self, p, xBC, dt_raw):
        H, P, NG, N = self.H, self.P, self.NG, self.N
        G, L, _ = xBC.shape
        xc = self.conv_silu(xBC, self.w[p + "conv_w"], self.w[p + "conv_b"])
        x = xc[..., :H * P].reshape(G, L, H, P)
        B = xc[..., H * P:H * P + NG * N].reshape(G, L, NG, N)
        C = xc[..., H * P + NG * N:].reshape(G, L, NG, N)
        dt = F.softplus(dt_raw + self.w[p + "dt_bias"].float())
        A = -torch.exp(self.w[p + "A_log"].float())
        y = ssd(self.q(x), dt, A, self.q(B), self.q(C))
        y = y + x * self.w[p + "D"].float()[:, None]
        return y.reshape(G, L, H * P)

    def mixer(self, i, x):
        m = f"backbone.layers.{i}.mixer."
        proj = self.linear(x, self.w[m + "in_proj.weight"])
        flip = lambda t: t.flip(1)  # noqa: E731
        if self.version == 1:
            xi, z = proj.split([self.di, self.di], dim=-1)
            y = (self._v1_direction(m + "fwd.", xi)
                 + flip(self._v1_direction(m + "rev.", flip(xi))))
            y = y * F.silu(z)
        else:
            wc = self.di + 2 * self.NG * self.N
            z, xBC, dt = proj.split([self.di, wc, self.H], dim=-1)
            y = (self._v2_direction(m + "fwd.", xBC, dt)
                 + flip(self._v2_direction(m + "rev.", flip(xBC), flip(dt))))
            g = (y * F.silu(z)).reshape(*y.shape[:-1], self.NG, -1)
            g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + self.eps)
            y = g.reshape(y.shape) * self.w[m + "norm_w"].float()
        return self.linear(y, self.w[m + "out_proj.weight"])

    def block(self, i, h, residual):
        h = self.swap_rc(h)
        residual = h if residual is None else self.swap_rc(residual) + h
        normed = self.rms(residual, self.w[f"backbone.layers.{i}.norm_w"])
        return self.mixer(i, normed), residual

    # -- models ----------------------------------------------------------------
    def backbone(self, ids: torch.Tensor, remat: bool = False):
        """(2, B, L, d) fp32 hidden states of both strands (strand 1 in its
        own orientation)."""
        E = self.w["backbone.embedding"].float()
        both = torch.cat([ids, self.comp[ids.flip(-1)]])
        h = self.q(E)[both]
        residual = None
        for i in range(self.cfg["n_layer"]):
            if remat:
                h, residual = checkpoint(self.block, i, h, residual,
                                         use_reentrant=False)
            else:
                h, residual = self.block(i, h, residual)
        h = self.rms(residual + h, self.w["backbone.norm_f_w"])
        return h.view(2, ids.shape[0], *h.shape[1:])

    def mlm_logits(self, ids, remat: bool = False):
        h = self.backbone(ids, remat)
        E = self.w["backbone.embedding"].float()
        return self.linear(h[0], E) + self.linear(h[1].flip(-2), E[self.comp])

    def classifier_logits(self, ids, remat: bool = False):
        """Mean pooling of each strand, the shared linear head, averaged."""
        h = self.backbone(ids, remat)
        W = self.w["decoder.output_transform.weight"]
        b = self.w["decoder.output_transform.bias"].float()
        return (self.linear(h[0].mean(1), W) + self.linear(h[1].mean(1), W)
                ) / 2 + b

    def strand_mean_hidden(self, ids):
        """The (B, L, d) strand mean VEP pools: the reference-convention
        (B, L, 2d) states ``[h0, flip_LC(h1)]`` with their second half
        flipped back along L and d, averaged with the first."""
        h = self.backbone(ids)
        ref = torch.cat([h[0], h[1].flip(-2, -1)], dim=-1)
        d = self.d
        return (ref[..., :d] + ref[..., d:].flip(-2, -1)) / 2


def mlm_loss(logits, targets, ignore_index: int = 4):
    """Mean cross-entropy over the positions whose target is not ignored."""
    V = logits.shape[-1]
    tgt = targets.reshape(-1).long()
    keep = tgt != ignore_index
    nll = F.cross_entropy(logits.reshape(-1, V)[keep], tgt[keep],
                          reduction="sum")
    return nll / keep.sum().clamp(min=1)
