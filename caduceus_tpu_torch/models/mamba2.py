"""Mamba-2 mixer and BiMamba2.

Port of `caduceus_tpu/models/mamba2.py` (mamba-ssm 2.x ``Mamba2``
semantics, norm_before_gate=False):

    in_proj:  d_model -> [z (d_inner), xBC (d_inner + 2·NG·N), dt (H)]
    xBC:      depthwise causal conv (d_conv) + SiLU, split into x, B, C
    ssd:      per-head scan, dt = softplus(dt + dt_bias), A = -exp(A_log)
    norm:     gated RMSNorm  y = rmsnorm_groups(y · silu(z)) · w
    out_proj: d_inner -> d_model

Each direction's conv + split + scan runs the route that
``ssm_cfg.use_kernel`` selects, as the JAX mixer's `_resolved_kernel`
does (`caduceus_tpu/models/mamba2.py:141-225`):

- "auto", "xla", "pallas_batched", "pallas_batched_interpret": one call of
  `ops/ssd_batched.py ssd_batched_fused`, the conv inside the
  `ssd_fused_fwd` kernel (in fp32);
- "pallas", "pallas_interpret": the conv + SiLU as a PyTorch op in the
  storage dtype (`ops/conv.py`), then `ops/ssd_head.py ssd_head` on column
  views of its output: the per-head kernels (TPU kernels #5 / #6).

On the CPU every route runs its plain version. `BiMamba2` covers the four
(weight-tie × combine) configurations plus ``bidirectional=False``.
Parameter names follow the flax modules so `params.py` maps them 1:1.

Not ported yet: the context/tensor-parallel `_sharded_ssd` branch.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models.mamba import (
    FrameDense,
    _param_dtype,
    _residual_rescale,
    dt_proj_bias_init,
    torch_linear_init,
)
from caduceus_tpu_torch.ops.conv import causal_conv1d
from caduceus_tpu_torch.ops.ssd_batched import ssd_batched_fused
from caduceus_tpu_torch.ops.ssd_head import resolve_ssd_kernel


def rms_norm_gated(y, z, weight, ngroups: int, eps: float):
    """Mamba-2 RMSNormGated (norm_before_gate=False): rmsnorm(y·silu(z))·w,
    RMS statistics per channel group of size d_inner // ngroups."""
    yf = y.float() * F.silu(z.float())
    g = yf.reshape(*yf.shape[:-1], ngroups, yf.shape[-1] // ngroups)
    g = g * torch.rsqrt(g.square().mean(dim=-1, keepdim=True) + eps)
    return (g.reshape(yf.shape) * weight.float()).to(y.dtype)


class _DirectionParamsV2(nn.Module):
    """Per-direction Mamba-2 parameters: conv over xBC, dt_bias, A_log, D."""

    def __init__(self, cfg: CaduceusConfig, generator: torch.Generator):
        super().__init__()
        c, s = cfg, cfg.ssm_cfg
        self.cfg = cfg
        H = c.nheads
        d_conv_dim = c.d_inner + 2 * s.ngroups * s.d_state
        pdt = _param_dtype(c)
        self.conv_w = nn.Parameter(torch_linear_init(
            torch.empty(s.d_conv, d_conv_dim, dtype=pdt), s.d_conv, generator))
        self.conv_b = (nn.Parameter(torch_linear_init(
            torch.empty(d_conv_dim, dtype=pdt), s.d_conv, generator))
            if s.conv_bias else None)
        self.dt_bias = nn.Parameter(dt_proj_bias_init(
            torch.empty(H, dtype=pdt), s.dt_min, s.dt_max, s.dt_init_floor,
            generator))
        a_min, a_max = s.a_init_range
        a = torch.empty(H).uniform_(a_min, a_max, generator=generator)
        # A_log / D stay fp32 whatever param_dtype is (the scan reads fp32)
        self.A_log = nn.Parameter(torch.log(a))
        self.D = nn.Parameter(torch.ones(H))

    def forward(self, xBC_raw: torch.Tensor, dt_raw: torch.Tensor,
                reverse: bool) -> torch.Tensor:
        """conv -> split -> SSD for one direction. ``xBC_raw``: (..., L,
        d_inner + 2·NG·N) pre-conv; ``dt_raw``: (..., L, H). Returns the
        ungated scan output (..., L, d_inner)."""
        c, s = self.cfg, self.cfg.ssm_cfg
        H, P, NG, N = c.nheads, s.headdim, s.ngroups, s.d_state
        lead = xBC_raw.shape[:-2]
        L = xBC_raw.shape[-2]
        x3 = xBC_raw.reshape(-1, L, xBC_raw.shape[-1])
        G = x3.shape[0]
        dt3 = dt_raw.reshape(G, L, H)
        k = s.use_kernel
        if k.startswith("pallas") and not k.startswith("pallas_batched"):
            # the conv as a global op in the storage dtype (JAX: an XLA op
            # outside the Pallas kernels), then the SSD on column views of
            # its output
            ssd_fn, _ = resolve_ssd_kernel(k)
            xc = causal_conv1d(
                x3, self.conv_w.to(x3.dtype),
                None if self.conv_b is None else self.conv_b.to(x3.dtype),
                activation="silu", reverse=reverse)
            y = ssd_fn(
                xc[..., :H * P].reshape(G, L, H, P), dt3,
                -torch.exp(self.A_log),
                xc[..., H * P:H * P + NG * N].reshape(G, L, NG, N),
                xc[..., H * P + NG * N:].reshape(G, L, NG, N), D=self.D,
                dt_bias=self.dt_bias, dt_softplus=True, reverse=reverse)
            return y.reshape(*lead, L, c.d_inner)
        # "auto", "pallas_batched*" and "xla": the fused-conv kernels. "xla"
        # (the JAX package's chunked XLA form) has no counterpart on the
        # card without a kernel, so it takes the same route, with the conv
        # weights rounded to the compute dtype as that form casts them
        # (`caduceus_tpu/models/mamba2.py` `__call__`, the XLA branch); the
        # kernels read them as fp32. "auto" and "pallas_batched*" keep them
        # fp32, as `ssd_pallas_batched_fused` takes them.
        conv_w, conv_b = self.conv_w, self.conv_b
        if k == "xla":
            conv_w = conv_w.to(x3.dtype).float()
            conv_b = None if conv_b is None else conv_b.to(x3.dtype).float()
        y = ssd_batched_fused(
            x3, dt3, -torch.exp(self.A_log), conv_w, conv_b=conv_b,
            D=self.D, dt_bias=self.dt_bias, dims=(H, P, NG, N),
            dt_softplus=True, reverse=reverse)
        return y.reshape(*lead, L, c.d_inner)


def _split_zxbcdt(c: CaduceusConfig, zxbcdt: torch.Tensor):
    d_xbc = c.d_inner + 2 * c.ssm_cfg.ngroups * c.ssm_cfg.d_state
    return torch.split(zxbcdt, [c.d_inner, d_xbc, c.nheads], dim=-1)


def _d_in_proj(c: CaduceusConfig) -> int:
    return 2 * c.d_inner + 2 * c.ssm_cfg.ngroups * c.ssm_cfg.d_state + c.nheads


class Mamba2Mixer(nn.Module):
    """Unidirectional Mamba-2 mixer (mamba-ssm 2.x ``Mamba2`` semantics)."""

    def __init__(self, cfg: CaduceusConfig, frame_conjugate: bool,
                 generator: torch.Generator):
        super().__init__()
        c = self.cfg = cfg
        self.conj = frame_conjugate
        pdt = _param_dtype(c)
        self.in_proj = FrameDense(c.d_model, _d_in_proj(c), c.ssm_cfg.bias,
                                  generator, param_dtype=pdt,
                                  flip_in=frame_conjugate)
        self.out_proj = FrameDense(c.d_inner, c.d_model, c.ssm_cfg.bias,
                                   generator, _residual_rescale(c), pdt,
                                   flip_out=frame_conjugate)
        self.norm_w = nn.Parameter(torch.ones(c.d_inner, dtype=pdt))
        self.fwd = _DirectionParamsV2(c, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        dtype = getattr(torch, c.dtype)
        z, xBC_raw, dt_raw = _split_zxbcdt(c, self.in_proj(x, dtype))
        y = self.fwd(xBC_raw, dt_raw, reverse=self.conj)
        y = rms_norm_gated(y, z, self.norm_w, c.ssm_cfg.ngroups,
                           c.norm_epsilon)
        return self.out_proj(y, dtype)


class BiMamba2(nn.Module):
    """Bidirectional Mamba-2 with structural weight sharing.

    Under the conjugated frame the d_model-facing kernel rows/columns are
    flipped and the two scans swap direction (``rev_f = conj``,
    ``rev_r = not conj``)."""

    def __init__(self, cfg: CaduceusConfig, frame_conjugate: bool,
                 generator: torch.Generator):
        super().__init__()
        c = self.cfg = cfg
        self.conj = frame_conjugate
        if not c.bidirectional:
            self.mamba_fwd = Mamba2Mixer(c, frame_conjugate, generator)
            return
        pdt = _param_dtype(c)
        rescale = _residual_rescale(c)
        bias = c.ssm_cfg.bias

        def dense_in():
            return FrameDense(c.d_model, _d_in_proj(c), bias, generator,
                              param_dtype=pdt, flip_in=frame_conjugate)

        def dense_out():
            return FrameDense(c.d_inner, c.d_model, bias, generator, rescale,
                              pdt, flip_out=frame_conjugate)

        self.in_proj = dense_in()
        self.out_proj = dense_out()
        self.norm_w = nn.Parameter(torch.ones(c.d_inner, dtype=pdt))
        self.fwd = _DirectionParamsV2(c, generator)
        self.rev = _DirectionParamsV2(c, generator)
        if not c.bidirectional_weight_tie:
            self.in_proj_rev = dense_in()
            self.out_proj_rev = dense_out()
            self.norm_w_rev = nn.Parameter(torch.ones(c.d_inner, dtype=pdt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        if not c.bidirectional:
            return self.mamba_fwd(x)
        dtype = getattr(torch, c.dtype)
        ng, eps = c.ssm_cfg.ngroups, c.norm_epsilon
        rev_f, rev_r = self.conj, not self.conj

        if c.bidirectional_weight_tie:
            z, xBC_raw, dt_raw = _split_zxbcdt(c, self.in_proj(x, dtype))
            y_f = self.fwd(xBC_raw, dt_raw, reverse=rev_f)
            y_r = self.rev(xBC_raw, dt_raw, reverse=rev_r)
            if c.bidirectional_strategy == "add":
                # combine pre-gate: one gated norm, one out_proj
                return self.out_proj(
                    rms_norm_gated(y_f + y_r, z, self.norm_w, ng, eps), dtype)
            return (self.out_proj(rms_norm_gated(y_f, z, self.norm_w, ng, eps),
                                  dtype)
                    * self.out_proj(rms_norm_gated(y_r, z, self.norm_w, ng,
                                                   eps), dtype))

        z_f, xBC_f, dt_f = _split_zxbcdt(c, self.in_proj(x, dtype))
        z_r, xBC_r, dt_r = _split_zxbcdt(c, self.in_proj_rev(x, dtype))
        y_f = self.fwd(xBC_f, dt_f, reverse=rev_f)
        y_r = self.rev(xBC_r, dt_r, reverse=rev_r)
        o_f = self.out_proj(rms_norm_gated(y_f, z_f, self.norm_w, ng, eps),
                            dtype)
        o_r = self.out_proj_rev(
            rms_norm_gated(y_r, z_r, self.norm_w_rev, ng, eps), dtype)
        if c.bidirectional_strategy == "add":
            return o_f + o_r
        return o_f * o_r
