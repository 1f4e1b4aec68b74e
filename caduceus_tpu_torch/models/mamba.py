"""Mamba mixer and BiMamba (the Mamba-1 / v1 model), `FrameDense` and the
Mamba parameter initializers.

Port of `caduceus_tpu/models/mamba.py` (mamba-ssm 1.2.0 ``Mamba``
semantics):

    in_proj:   d_model -> [x (d_inner), z (d_inner)]
    per direction (`_DirectionParams`): depthwise causal conv (d_conv) +
               SiLU, x_proj -> [dt (dt_rank), B (N), C (N)], dt_proj ->
               delta_raw (d_inner), selective scan with A = -exp(A_log),
               D, delta = softplus(delta_raw + dt_proj_b)
    gate:      y * silu(z)
    out_proj:  d_inner -> d_model

The conv and the two projections are plain PyTorch (`ops/conv.py`,
`torch.matmul`), as they are XLA ops outside any Pallas kernel in JAX. The
scan is `ops/scan.py`: `bidir_selective_scan` for the two directions of a
`BiMamba` layer (one launch of the `bidir_scan_fwd` CUDA kernel, TPU
kernel #9) and `selective_scan_chained` for `MambaMixer` (`selective_scan_fwd`,
#7); their backward is `selective_scan_bwd` (#8). On the CPU the same
calls run the plain versions. `BiMamba` covers the four (weight-tie x
combine) configurations plus ``bidirectional=False``. Parameter names and
layouts follow the flax modules so `params.py` maps them 1:1.

Also `FrameDense`, the torch-default initializers and the GPT-2 residual
rescale, which the Mamba-2 mixer (`models/mamba2.py`) shares. Not ported
yet: the context/tensor-parallel branches (`_cp_scan`, `tp_axis`).

Every initializer draws from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.ops.conv import causal_conv1d
from caduceus_tpu_torch.ops.scan import (
    bidir_selective_scan,
    selective_scan_chained,
)


def torch_linear_init(t: torch.Tensor, fan_in: int, generator: torch.Generator,
                      scale: float = 1.0) -> torch.Tensor:
    """torch nn.Linear default: U(±scale/sqrt(fan_in)), in place."""
    bound = scale / math.sqrt(fan_in)
    return t.uniform_(-bound, bound, generator=generator)


def dt_proj_bias_init(t: torch.Tensor, dt_min: float, dt_max: float,
                      dt_init_floor: float,
                      generator: torch.Generator) -> torch.Tensor:
    """mamba-ssm dt bias init: softplus^-1 of a log-uniform dt, in place."""
    u = torch.rand(t.shape, generator=generator)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min))
                   + math.log(dt_min)).clamp(min=dt_init_floor)
    with torch.no_grad():
        return t.copy_(dt + torch.log(-torch.expm1(-dt)))


def dt_proj_kernel_init(t: torch.Tensor, dt_rank: int, dt_init: str,
                        dt_scale: float,
                        generator: torch.Generator) -> torch.Tensor:
    """mamba-ssm dt_proj weight init, in place: U(±std) or the constant
    std, std = dt_rank^-0.5 · dt_scale."""
    std = dt_rank ** -0.5 * dt_scale
    if dt_init == "constant":
        return t.fill_(std)
    if dt_init == "random":
        return t.uniform_(-std, std, generator=generator)
    raise NotImplementedError(dt_init)


def a_log_init(d_inner: int, d_state: int) -> torch.Tensor:
    """S4D-real init: A = -(1..N) per channel, stored as log; fp32."""
    a = torch.arange(1, d_state + 1, dtype=torch.float32)
    return torch.log(a).repeat(d_inner, 1)


def _residual_rescale(c: CaduceusConfig) -> float:
    """GPT-2 prenorm-residual rescale of the out_proj init."""
    if not c.rescale_prenorm_residual:
        return 1.0
    return 1.0 / math.sqrt(c.n_residuals_per_layer * c.n_layer)


class FrameDense(nn.Module):
    """``y = x @ Wᵀ + b`` with optional static flips of the weight's input
    columns / output rows (and the bias, with the output): the
    parameter-side form of the conjugated RCPS block frame (see
    `models/caduceus.py CaduceusBlock`). ``weight`` is (out, in) as in
    `nn.Linear` — the transpose of the flax kernel (`params.py`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 generator: torch.Generator, init_scale: float = 1.0,
                 param_dtype: torch.dtype = torch.float32,
                 flip_in: bool = False, flip_out: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch_linear_init(
            torch.empty(out_features, in_features, dtype=param_dtype),
            in_features, generator, init_scale))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=param_dtype))
                     if bias else None)
        self.flip_in = flip_in
        self.flip_out = flip_out

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = x.dtype if dtype is None else dtype
        w = self.weight
        if self.flip_in:
            w = w.flip(1)
        if self.flip_out:
            w = w.flip(0)
        y = x.to(dtype) @ w.to(dtype).t()
        if self.bias is not None:
            b = self.bias.flip(0) if self.flip_out else self.bias
            y = y + b.to(dtype)
        return y


def _param_dtype(c: CaduceusConfig) -> torch.dtype:
    return getattr(torch, c.param_dtype)


class _DirectionParams(nn.Module):
    """Per-direction inner-SSM parameters (conv + dt/B/C projections + A,
    D), in the flax layouts: conv_w (K, d_inner), x_proj_w (d_inner,
    dt_rank + 2N), dt_proj_w (dt_rank, d_inner), A_log (d_inner, N). A_log
    and D are fp32 whatever param_dtype is."""

    def __init__(self, cfg: CaduceusConfig, generator: torch.Generator):
        super().__init__()
        c, s = cfg, cfg.ssm_cfg
        self.cfg = cfg
        di, R, N = c.d_inner, c.dt_rank, s.d_state
        pdt = _param_dtype(c)
        self.conv_w = nn.Parameter(torch_linear_init(
            torch.empty(s.d_conv, di, dtype=pdt), s.d_conv, generator))
        self.conv_b = (nn.Parameter(torch_linear_init(
            torch.empty(di, dtype=pdt), s.d_conv, generator))
            if s.conv_bias else None)
        self.x_proj_w = nn.Parameter(torch_linear_init(
            torch.empty(di, R + 2 * N, dtype=pdt), di, generator))
        self.dt_proj_w = nn.Parameter(dt_proj_kernel_init(
            torch.empty(R, di, dtype=pdt), R, s.dt_init, s.dt_scale,
            generator))
        self.dt_proj_b = nn.Parameter(dt_proj_bias_init(
            torch.empty(di, dtype=pdt), s.dt_min, s.dt_max, s.dt_init_floor,
            generator))
        self.A_log = nn.Parameter(a_log_init(di, N))
        self.D = nn.Parameter(torch.ones(di))

    def projections(self, x: torch.Tensor, reverse: bool):
        """Conv + input-dependent projections of ``x`` (..., L, d_inner):
        (u, delta_raw, B, C) as (G, L, ·); B and C are column slices of the
        x_proj output."""
        c = self.cfg
        L, di = x.shape[-2:]
        x3 = x.reshape(-1, L, di)
        dtype = x.dtype
        u = causal_conv1d(
            x3, self.conv_w.to(dtype),
            None if self.conv_b is None else self.conv_b.to(dtype),
            activation="silu", reverse=reverse)
        dbc = u @ self.x_proj_w.to(dtype)
        R, N = c.dt_rank, c.ssm_cfg.d_state
        dt, B, C = dbc.split([R, N, N], dim=-1)
        delta_raw = dt @ self.dt_proj_w.to(dtype)
        return u, delta_raw, B, C

    def A(self) -> torch.Tensor:
        return -torch.exp(self.A_log.float())

    def forward(self, x: torch.Tensor, reverse: bool) -> torch.Tensor:
        """`ssm_branch`: the ungated scan output (..., L, d_inner) of one
        direction."""
        u, delta_raw, B, C = self.projections(x, reverse)
        y, _ = selective_scan_chained(
            u, delta_raw, self.A(), B, C, D=self.D, delta_bias=self.dt_proj_b,
            delta_softplus=True, reverse=reverse)
        return y.reshape(x.shape)


def _dense_in(c: CaduceusConfig, conj: bool, generator) -> FrameDense:
    return FrameDense(c.d_model, 2 * c.d_inner, c.ssm_cfg.bias, generator,
                      param_dtype=_param_dtype(c), flip_in=conj)


def _dense_out(c: CaduceusConfig, conj: bool, generator) -> FrameDense:
    return FrameDense(c.d_inner, c.d_model, c.ssm_cfg.bias, generator,
                      _residual_rescale(c), _param_dtype(c), flip_out=conj)


class MambaMixer(nn.Module):
    """Unidirectional Mamba mixer (reference `Mamba`, mamba-ssm 1.2.0):
    in_proj -> [conv -> SiLU -> selective scan] -> gate -> out_proj. Under
    the conjugated frame the scan runs right to left."""

    def __init__(self, cfg: CaduceusConfig, frame_conjugate: bool,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.conj = frame_conjugate
        self.in_proj = _dense_in(cfg, frame_conjugate, generator)
        self.out_proj = _dense_out(cfg, frame_conjugate, generator)
        self.fwd = _DirectionParams(cfg, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = getattr(torch, self.cfg.dtype)
        xi, z = self.in_proj(x, dtype).chunk(2, dim=-1)
        y = self.fwd(xi, reverse=self.conj)
        return self.out_proj(y * F.silu(z), dtype)


class BiMamba(nn.Module):
    """Bidirectional Mamba (reference `BiMambaWrapper`) with structural
    weight sharing: (tie, add) one in_proj, gate and out_proj; (tie,
    ew_multiply) the shared out_proj per direction; untied separate
    projections; ``bidirectional=False`` a plain `MambaMixer`.

    Both directions go through one `bidir_selective_scan` call, which scans
    its first set left to right and its second right to left. Under the
    conjugated frame the fwd parameter set traverses right to left
    (``rev_f = conj``), so the two sets swap slots and the outputs swap
    back (`caduceus_tpu/models/mamba.py:502-518`, `:536`)."""

    def __init__(self, cfg: CaduceusConfig, frame_conjugate: bool,
                 generator: torch.Generator):
        super().__init__()
        c = self.cfg = cfg
        self.conj = frame_conjugate
        if not c.bidirectional:
            self.mamba_fwd = MambaMixer(c, frame_conjugate, generator)
            return
        self.in_proj = _dense_in(c, frame_conjugate, generator)
        self.out_proj = _dense_out(c, frame_conjugate, generator)
        self.fwd = _DirectionParams(c, generator)
        self.rev = _DirectionParams(c, generator)
        if not c.bidirectional_weight_tie:
            self.in_proj_rev = _dense_in(c, frame_conjugate, generator)
            self.out_proj_rev = _dense_out(c, frame_conjugate, generator)

    def _run_both(self, xi_f: torch.Tensor, xi_r: torch.Tensor):
        rev_f = self.conj           # traversal of the fwd parameter set
        f = self.fwd.projections(xi_f, reverse=rev_f)
        r = self.rev.projections(xi_r, reverse=not rev_f)
        pf = (self.fwd.A(), self.fwd.D, self.fwd.dt_proj_b)
        pr = (self.rev.A(), self.rev.D, self.rev.dt_proj_b)
        # slot 1 is scanned left to right, slot 2 right to left
        (s1, p1), (s2, p2) = ((r, pr), (f, pf)) if rev_f else ((f, pf),
                                                                (r, pr))
        y1, y2 = bidir_selective_scan(*s1, *s2, p1[0], p2[0], p1[1], p2[1],
                                      p1[2], p2[2], delta_softplus=True)
        y_f, y_r = (y2, y1) if rev_f else (y1, y2)
        return y_f.reshape(xi_f.shape), y_r.reshape(xi_r.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        if not c.bidirectional:
            return self.mamba_fwd(x)
        dtype = getattr(torch, c.dtype)
        if c.bidirectional_weight_tie:
            xi, z = self.in_proj(x, dtype).chunk(2, dim=-1)
            y_f, y_r = self._run_both(xi, xi)
            gate = F.silu(z)
            if c.bidirectional_strategy == "add":
                return self.out_proj((y_f + y_r) * gate, dtype)
            return (self.out_proj(y_f * gate, dtype)
                    * self.out_proj(y_r * gate, dtype))
        xi_f, z_f = self.in_proj(x, dtype).chunk(2, dim=-1)
        xi_r, z_r = self.in_proj_rev(x, dtype).chunk(2, dim=-1)
        y_f, y_r = self._run_both(xi_f, xi_r)
        o_f = self.out_proj(y_f * F.silu(z_f), dtype)
        o_r = self.out_proj_rev(y_r * F.silu(z_r), dtype)
        if c.bidirectional_strategy == "add":
            return o_f + o_r
        return o_f * o_r
