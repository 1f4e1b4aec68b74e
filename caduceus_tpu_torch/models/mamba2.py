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

With ``context_parallel_axis`` set (and a mesh registered,
`parallel/mesh.py`) each direction runs the context-parallel branch of
the JAX mixer's `_sharded_ssd` (`caduceus_tpu/models/mamba2.py:227-310`)
on this rank's sequence shard: the fused route,
`parallel/seq_scan.py sequence_parallel_ssd_fused` (the CP entry of the
fused kernels, its 8 halo rows exchanged), when the kernel route is the
fused one and the shard length suits it (`fused_cp_ok`, the JAX rule);
otherwise the conv with its K-1 halo rows as a PyTorch op and
`sequence_parallel_ssd` on its output.

With ``tensor_parallel_axis`` set (the parameters cut by
`parallel/sharding.py shard_module_`) each rank runs H / M heads, the
tensor-parallel branch of `_sharded_ssd` (`caduceus_tpu/models/mamba2.py
:312-361`): ``in_proj`` column-parallel (this rank's z, x lanes and dt
heads behind `comm.copy_to_axis`; the B / C lanes, which every rank holds
whole when ngroups is 1 or the axis a multiple of it, from the input
itself and entering the head-sharded part through `copy_to_axis`, as do
their conv taps: their gradients there are partial), the conv + SiLU as a
PyTorch op on the rank's [x | B | C] lanes, the SSD on its heads through
the route `resolve_ssd_kernel` names (the unfused head-batched kernels #2
/ #4 for "auto", "xla" and "pallas_batched*", the per-head #5 / #6 for
"pallas*"; a rank whose heads lie in one of several groups slices that
group's B / C), the gated RMSNorm with its sum of squares all-reduced
where a group spans ranks, and ``out_proj`` row-parallel. Tensor and
context parallelism compose over two axes (``context_parallel_axis =
"seq"``): the fused route then runs the CP entry on the rank's lanes at
dims (H / M, P, NG_loc, N) (`fused_tp_ok`, the JAX rule), else the
unfused composed route.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models.mamba import (
    FrameDense,
    _dense_apply,
    _enter,
    _param_dtype,
    _residual_rescale,
    dt_proj_bias_init,
    torch_linear_init,
)
from caduceus_tpu_torch.ops.conv import causal_conv1d
from caduceus_tpu_torch.ops.ssd_batched import fused_cp_ok, ssd_batched_fused
from caduceus_tpu_torch.ops.ssd_head import resolve_ssd_kernel
from caduceus_tpu_torch.parallel.comm import (
    conv_halo,
    copy_to_axis,
    reduce_from_axis,
)
from caduceus_tpu_torch.parallel.mesh import cp_axis, tp_axis
from caduceus_tpu_torch.parallel.seq_scan import (
    sequence_parallel_ssd,
    sequence_parallel_ssd_fused,
)


def rms_norm_gated(y, z, weight, ngroups: int, eps: float, tp=None):
    """Mamba-2 RMSNormGated (norm_before_gate=False): rmsnorm(y·silu(z))·w,
    RMS statistics per channel group of size d_inner // ngroups. Under
    tensor parallelism (``tp``) y, z and w are this rank's channels: a
    group that spans ranks takes its sum of squares over them."""
    yf = y.float() * F.silu(z.float())
    n = yf.shape[-1]
    if tp is not None and tp.size > 1 and ngroups % tp.size:
        # this rank's channels lie in one group, which spans size / ngroups
        # ranks: every rank's partial sum at its group, summed over the
        # axis (and the gradient too)
        gs = n * tp.size // ngroups
        part = yf.square().sum(-1, keepdim=True)
        slot = torch.zeros(ngroups, dtype=part.dtype, device=part.device)
        slot[tp.rank * ngroups // tp.size] = 1.0
        total = copy_to_axis(reduce_from_axis(part * slot, tp), tp)
        ss = (total * slot).sum(-1, keepdim=True)
        yf = yf * torch.rsqrt(ss / gs + eps)
        return (yf * weight.float()).to(y.dtype)
    if tp is not None:
        ngroups //= tp.size         # whole groups on every rank
    g = yf.reshape(*yf.shape[:-1], ngroups, n // ngroups)
    g = g * torch.rsqrt(g.square().mean(dim=-1, keepdim=True) + eps)
    return (g.reshape(yf.shape) * weight.float()).to(y.dtype)


def tp_dims(c: CaduceusConfig, tp):
    """(H, NG, cut): this rank's heads and B / C groups under tensor
    parallelism over ``tp``, and whether the groups are cut (else every
    rank holds all of them); the whole model's without ``tp``."""
    s = c.ssm_cfg
    H, NG = c.nheads, s.ngroups
    if tp is None or tp.size == 1:
        return H, NG, False
    M = tp.size
    if H % M:
        raise ValueError(f"nheads {H} not divisible by the model axis {M}")
    if NG > 1 and NG % M == 0:
        return H // M, NG // M, True
    if NG > 1 and M % NG:
        raise ValueError(f"ngroups {NG} and the model axis {M} must divide "
                         "one another (group-aligned head shards)")
    return H // M, NG, False


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
        ungated scan output (..., L, d_inner); under tensor parallelism
        this rank's lanes, heads and channels."""
        c, s = self.cfg, self.cfg.ssm_cfg
        H, P, NG, N = c.nheads, s.headdim, s.ngroups, s.d_state
        lead = xBC_raw.shape[:-2]
        L = xBC_raw.shape[-2]
        x3 = xBC_raw.reshape(-1, L, xBC_raw.shape[-1])
        G = x3.shape[0]
        dt3 = dt_raw.reshape(G, L, dt_raw.shape[-1])
        k = s.use_kernel
        axis, tp = cp_axis(c), tp_axis(c)
        if axis is not None or tp is not None:
            y = self._sharded_ssd(x3, dt3, reverse, axis, tp)
            return y.reshape(*lead, L, -1)
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
        conv_w, conv_b = self._fused_conv_weights(x3.dtype)
        y = ssd_batched_fused(
            x3, dt3, -torch.exp(self.A_log), conv_w, conv_b=conv_b,
            D=self.D, dt_bias=self.dt_bias, dims=(H, P, NG, N),
            dt_softplus=True, reverse=reverse)
        return y.reshape(*lead, L, c.d_inner)

    def _fused_conv_weights(self, dtype):
        """The conv weights the fused kernels read (fp32): rounded to the
        compute dtype for "xla", as its chunked XLA form casts them."""
        conv_w, conv_b = self.conv_w, self.conv_b
        if self.cfg.ssm_cfg.use_kernel == "xla":
            conv_w = conv_w.to(dtype).float()
            conv_b = None if conv_b is None else conv_b.to(dtype).float()
        return conv_w, conv_b

    def _sharded_ssd(self, x3, dt3, reverse: bool, axis, tp):
        """The JAX `_sharded_ssd` on this rank's part (G, L_loc, ·): (G,
        L_loc, H_loc, P). ``axis``: the context-parallel axis (None: the
        whole sequence), ``tp``: the tensor-parallel one (None: every head;
        else ``x3`` holds this rank's lanes, `tp_dims`). The fused route
        when the kernel route is the fused one ("auto", "xla",
        "pallas_batched*", as on one device), the sequence is sharded, the
        shard length suits the CP entry (`fused_cp_ok` of the config's
        chunk and segment: no tail padding) and the B / C groups are whole
        or cut with the heads (`fused_tp_ok`); else the conv (with its K-1
        halo rows under CP) as a PyTorch op, in the storage dtype with its
        weights cast to it (the JAX branch's cast), then the SSD through
        the route's unfused kernels: `sequence_parallel_ssd` under CP, the
        route's function on this rank's heads under TP alone."""
        c, s = self.cfg, self.cfg.ssm_cfg
        H, NG, cut = tp_dims(c, tp)
        P, N = s.headdim, s.d_state
        G, L = x3.shape[:2]
        k = s.use_kernel
        per_head = k.startswith("pallas") and not k.startswith(
            "pallas_batched")
        A = -torch.exp(self.A_log)
        shared = tp is not None and tp.size > 1 and not cut
        fused_tp_ok = not shared or s.ngroups == 1
        if (axis is not None and not per_head and fused_tp_ok
                and fused_cp_ok(L, s.ssd_chunk_size, s.ssd_seg_chunks)):
            conv_w, conv_b = self._fused_conv_weights(x3.dtype)
            conv_w, conv_b = self._shared_taps(conv_w, conv_b, H * P, tp,
                                               shared)
            return sequence_parallel_ssd_fused(
                x3, dt3, A, conv_w, conv_b=conv_b, D=self.D,
                dt_bias=self.dt_bias, dims=(H, P, NG, N), dt_softplus=True,
                reverse=reverse, axis=axis, seg_chunks=s.ssd_seg_chunks,
                cp_chunk_size=s.ssd_chunk_size)
        if axis is not None and shared and s.ngroups > 1:
            raise ValueError(
                f"ngroups {s.ngroups} under context and tensor parallelism "
                "must be a multiple of the model axis (B / C cut with the "
                "heads), as in the JAX package")
        conv_w, conv_b = self._shared_taps(
            self.conv_w.to(x3.dtype),
            None if self.conv_b is None else self.conv_b.to(x3.dtype),
            H * P, tp, shared)
        K = self.conv_w.shape[0]
        halo = (conv_halo(x3, K - 1, axis, reverse)
                if axis is not None and K > 1 else None)
        xc = causal_conv1d(x3, conv_w, conv_b, activation="silu",
                           reverse=reverse, halo=halo)
        B = xc[..., H * P:H * P + NG * N].reshape(G, L, NG, N)
        C = xc[..., H * P + NG * N:].reshape(G, L, NG, N)
        if shared and NG > 1:
            # this rank's heads lie in one group (`slice_group`)
            g = tp.rank * NG // tp.size
            B, C = B[:, :, g:g + 1], C[:, :, g:g + 1]
        x = xc[..., :H * P].reshape(G, L, H, P)
        if axis is not None:
            return sequence_parallel_ssd(
                x, dt3, A, B, C, D=self.D, dt_bias=self.dt_bias,
                dt_softplus=True, reverse=reverse, axis=axis,
                local_impl="pallas" if per_head else "pallas_batched")
        ssd_fn, _ = resolve_ssd_kernel(
            "pallas" if per_head else "pallas_batched")
        return ssd_fn(x, dt3, A, B, C, D=self.D, dt_bias=self.dt_bias,
                      dt_softplus=True, reverse=reverse)

    @staticmethod
    def _shared_taps(conv_w, conv_b, xw: int, tp, shared: bool):
        """The conv weights a head-sharded rank uses: its x lanes' taps,
        and the B / C lanes' taps (and bias) that every rank holds whole
        entering through `copy_to_axis`, which sums their partial
        gradients over the model axis."""
        if not shared:
            return conv_w, conv_b
        conv_w = torch.cat([conv_w[:, :xw], copy_to_axis(conv_w[:, xw:], tp)],
                           dim=1)
        if conv_b is not None:
            conv_b = torch.cat([conv_b[:xw], copy_to_axis(conv_b[xw:], tp)])
        return conv_w, conv_b


def _split_zxbcdt(c: CaduceusConfig, zxbcdt: torch.Tensor):
    d_xbc = c.d_inner + 2 * c.ssm_cfg.ngroups * c.ssm_cfg.d_state
    return torch.split(zxbcdt, [c.d_inner, d_xbc, c.nheads], dim=-1)


def _in_proj(c: CaduceusConfig, dense: FrameDense, x: torch.Tensor, dtype,
             tp):
    """(z, xBC_raw, dt_raw) of the input projection. Under tensor
    parallelism (``tp``) this rank's: its z and x lanes and dt heads from
    a column-parallel product of ``copy_to_axis(x)``; the B / C lanes, when
    every rank holds them whole, from ``x`` itself, entering the
    head-sharded conv and SSD through `copy_to_axis` (so that the input's
    gradient counts them once and their weights' gradients are whole)."""
    if tp is None:
        return _split_zxbcdt(c, dense(x, dtype))
    H, NG, cut = tp_dims(c, tp)
    di = H * c.ssm_cfg.headdim
    bc = NG * c.ssm_cfg.d_state
    if cut or tp.size == 1:
        return torch.split(dense(_enter(x, tp), dtype),
                           [di, di + 2 * bc, H], dim=-1)
    w, b = dense._framed()
    own = [slice(0, 2 * di), slice(2 * di + 2 * bc, None)]
    w_own = torch.cat([w[r] for r in own])
    y = _enter(x, tp).to(dtype) @ w_own.to(dtype).t()
    w_bc = w[2 * di:2 * di + 2 * bc]
    y_bc = x.to(dtype) @ w_bc.to(dtype).t()
    if b is not None:
        y = y + torch.cat([b[r] for r in own]).to(dtype)
        y_bc = y_bc + b[2 * di:2 * di + 2 * bc].to(dtype)
    z, xs, dt = torch.split(y, [di, di, H], dim=-1)
    return z, torch.cat([xs, copy_to_axis(y_bc, tp)], dim=-1), dt


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
        tp = tp_axis(c)
        z, xBC_raw, dt_raw = _in_proj(c, self.in_proj, x, dtype, tp)
        y = self.fwd(xBC_raw, dt_raw, reverse=self.conj)
        y = rms_norm_gated(y, z, self.norm_w, c.ssm_cfg.ngroups,
                           c.norm_epsilon, tp)
        return _dense_apply(self.out_proj, y, dtype, tp)


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
        tp = tp_axis(c)

        def gated_out(dense, y, z, w):
            return _dense_apply(dense, rms_norm_gated(y, z, w, ng, eps, tp),
                                dtype, tp)

        if c.bidirectional_weight_tie:
            z, xBC_raw, dt_raw = _in_proj(c, self.in_proj, x, dtype, tp)
            y_f = self.fwd(xBC_raw, dt_raw, reverse=rev_f)
            y_r = self.rev(xBC_raw, dt_raw, reverse=rev_r)
            if c.bidirectional_strategy == "add":
                # combine pre-gate: one gated norm, one out_proj
                return gated_out(self.out_proj, y_f + y_r, z, self.norm_w)
            return (gated_out(self.out_proj, y_f, z, self.norm_w)
                    * gated_out(self.out_proj, y_r, z, self.norm_w))

        z_f, xBC_f, dt_f = _in_proj(c, self.in_proj, x, dtype, tp)
        z_r, xBC_r, dt_r = _in_proj(c, self.in_proj_rev, x, dtype, tp)
        y_f = self.fwd(xBC_f, dt_f, reverse=rev_f)
        y_r = self.rev(xBC_r, dt_r, reverse=rev_r)
        o_f = gated_out(self.out_proj, y_f, z_f, self.norm_w)
        o_r = gated_out(self.out_proj_rev, y_r, z_r, self.norm_w_rev)
        if c.bidirectional_strategy == "add":
            return o_f + o_r
        return o_f * o_r
