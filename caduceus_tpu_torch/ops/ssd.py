"""State-space dual (SSD / Mamba-2) scan — plain PyTorch versions.

Port of `caduceus_tpu/ops/ssd.py`. For every batch row g, head h (group
h // (H // NG)), head channel p and state n:

    a[t,h]      = dt[t,h] * A[h]                          (A < 0, dt >= 0)
    S[t,h,n,p]  = exp(a[t,h]) * S[t-1] + dt[t,h] * B[t,g,n] * x[t,h,p]
    y[t,h,p]    = sum_n C[t,g,n] * S[t,h,n,p] + D[h] * x[t,h,p]

with ``dt = softplus(dt_raw + dt_bias)`` resolved inside (optional).

- `ssd_ref` is the sequential oracle (post-conv x, B, C).
- `ssd_chunked_fused` is the chunked dual form with the depthwise conv +
  SiLU + x/B/C split inside: the plain version of the `ssd_fused_fwd` CUDA
  kernel (`ops/ssd_batched.py`), used on the CPU and by the tests. It
  follows the kernel's precision policy: cumsum and decays in fp32, matmul
  operands rounded to the storage dtype with fp32 accumulation (emulated
  as fp32 products of rounded operands), fp32 state.
- `ssd_chunked` is the same chunk body on post-conv x, B, C: the plain
  version of the unfused `ssd_fwd` CUDA kernel (the prefill's SSD).
- `ssd_step` is the one-token recurrence of the decode step.
- `ssd_chunked_fused_bwd` is its adjoint from the saved chunk carries, the
  plain version of the `ssd_fused_bwd` kernels: `ssd_adjoint_xc` (the SSD
  part) then `conv_silu_bwd` (SiLU and conv adjoints), one per kernel.
- `ssd_chunked_bwd` is the adjoint of `ssd_chunked` on post-conv x, B, C,
  the plain version of the unfused `ssd_bwd` kernel; it shares the chunk
  body `_adjoint` with `ssd_adjoint_xc`.

Per chunk of T rows, in array order (``reverse`` only transposes the masks
and walks the chunks right to left — nothing is flipped in memory):

    cum      = inclusive in-scan-order cumsum of a          (T, H)
    CB       = C @ Bᵀ                                        (T, T)
    Lm       = exp(mask(cum_t - cum_s))                      (T, T)
    y        = (CB ⊙ Lm) @ (dt·x) + exp(cum) ⊙ (C @ h_in) + D·x
    h_out    = exp(Σa)·h_in + Bᵀ @ (exp(Σa - cum) ⊙ dt·x)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# chunks batched per step of the plain version's sequential loop (bounds
# its (G, seg, T, T, H) temporaries)
_SEG_CHUNKS = 8


def _resolve_dt(dt, dt_bias, dt_softplus):
    dt = dt.float()
    if dt_bias is not None:
        dt = dt + dt_bias.float()
    if dt_softplus:
        dt = F.softplus(dt)
    return dt


def ssd_ref(
    x: torch.Tensor,                        # (G, L, H, P)
    dt: torch.Tensor,                       # (G, L, H) raw
    A: torch.Tensor,                        # (H,) negative
    B_mat: torch.Tensor,                    # (G, L, NG, N)
    C: torch.Tensor,                        # (G, L, NG, N)
    D: Optional[torch.Tensor] = None,       # (H,)
    dt_bias: Optional[torch.Tensor] = None,  # (H,)
    dt_softplus: bool = False,
    reverse: bool = False,
    h_init: Optional[torch.Tensor] = None,  # (G, H, N, P) fp32
    return_final_state: bool = False,
):
    """Sequential reference implementation (numerics oracle)."""
    G, L, H, P = x.shape
    NG, N = B_mat.shape[-2:]
    rep = H // NG
    dtf = _resolve_dt(dt, dt_bias, dt_softplus)
    xf, Af, Bf, Cf = x.float(), A.float(), B_mat.float(), C.float()
    h = (torch.zeros(G, NG, rep, N, P, device=x.device) if h_init is None
         else h_init.float().reshape(G, NG, rep, N, P).clone())
    ys = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        da = torch.exp(dtf[:, t] * Af).reshape(G, NG, rep, 1, 1)
        dx = (dtf[:, t, :, None] * xf[:, t]).reshape(G, NG, rep, 1, P)
        h = da * h + Bf[:, t, :, None, :, None] * dx
        ys[t] = torch.einsum("bgrnp,bgn->bgrp", h, Cf[:, t]).reshape(G, H, P)
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + xf * D.float()[:, None]
    y = y.to(x.dtype)
    if return_final_state:
        return y, h.reshape(G, H, N, P)
    return y


def carry_dtype(dtype: torch.dtype) -> torch.dtype:
    """Dtype of the saved chunk-entry states: bf16 for bf16 inputs, fp32
    otherwise (the rule of the JAX package's `_carry_dtype`)."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _keep_mask(T: int, reverse: bool, dev) -> torch.Tensor:
    """keep[t, s]: row t receives from row s (s <= t; s >= t if reverse)."""
    keep = torch.ones(T, T, dtype=torch.bool, device=dev)
    return keep.triu() if reverse else keep.tril()


def _conv_silu_rows(xBC, w, b, r0, r1, reverse):
    """fp32 silu(depthwise conv) for rows [r0, r1) of the pre-conv xBC,
    reading the K-1 neighbour rows (before r0, or after r1 when
    ``reverse``) from xBC, zeros past the sequence edges."""
    return F.silu(_conv_pre_rows(xBC, w, b, r0, r1, reverse))


def _conv_pre_rows(xBC, w, b, r0, r1, reverse):
    """The fp32 pre-activation of `_conv_silu_rows`."""
    G, L, Wc = xBC.shape
    K = w.shape[0]
    n = r1 - r0
    if reverse:
        hi = min(L, r1 + K - 1)
        ext = F.pad(xBC[:, r0:hi].float(), (0, 0, 0, n + K - 1 - (hi - r0)))
    else:
        lo = max(0, r0 - (K - 1))
        ext = F.pad(xBC[:, lo:r1].float(), (0, 0, K - 1 - (r0 - lo), 0))
    acc = None
    for k in range(K):
        i = K - 1 - k if reverse else k
        term = ext[:, i:i + n] * w[k]
        acc = term if acc is None else acc + term
    if b is not None:
        acc = acc + b
    return acc


def _q(t: torch.Tensor, dtype) -> torch.Tensor:
    """Round to the storage dtype, compute on in fp32 (exact products)."""
    return t.to(dtype).float()


def _chunked(load, dt, A, D, dt_bias, dims, dt_softplus, reverse, T, h_init,
             return_final_state, return_carries, mm):
    """The chunk body shared by `ssd_chunked_fused` and `ssd_chunked`.

    ``load(s0, r1)`` gives the fp32 x (G, r1 - s0, H·P) and the B, C (G,
    r1 - s0, NG·N) of rows [s0, r1), B and C rounded to ``mm``, the storage
    dtype of the matmul operands and of y. Rows past L in the last chunk
    are identity steps (dt = 0, x = B = C = 0), the semantics of the JAX
    package's `_pad_ssd`."""
    H, P, NG, N = dims
    G, L = dt.shape[:2]
    rep = H // NG
    dev = dt.device
    Af = A.float()
    nc = -(-L // T)
    Lp = nc * T
    h = (torch.zeros(G, H, N, P, device=dev) if h_init is None
         else h_init.float().clone())
    y = torch.empty(G, L, H, P, dtype=mm, device=dev)
    carries = (torch.empty(G, nc, H, N, P, dtype=carry_dtype(mm), device=dev)
               if return_carries else None)
    keep = _keep_mask(T, reverse, dev)

    seg = T * _SEG_CHUNKS
    starts = list(range(0, Lp, seg))
    for s0 in (reversed(starts) if reverse else starts):
        s1 = min(s0 + seg, Lp)
        r1 = min(s1, L)
        nci = (s1 - s0) // T
        pad = s1 - r1
        xs, Bq, Cq = (F.pad(t, (0, 0, 0, pad)) for t in load(s0, r1))
        dtf = F.pad(_resolve_dt(dt[:, s0:r1], dt_bias, dt_softplus),
                    (0, 0, 0, pad))
        xs = xs.reshape(G, nci, T, H, P)
        Bq = Bq.reshape(G, nci, T, NG, N)
        Cq = Cq.reshape(G, nci, T, NG, N)
        dtf = dtf.reshape(G, nci, T, H)

        a = dtf * Af
        if reverse:
            cum = a.flip(2).cumsum(2).flip(2)
        else:
            cum = a.cumsum(2)
        total = a.sum(2)                                      # (G, nci, H)
        segm = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (G,c,T,T,H)
        Lm = torch.exp(torch.where(keep[:, :, None], segm,
                                   torch.full_like(segm, -float("inf"))))
        CB = torch.einsum("gctkn,gcskn->gctsk", Cq, Bq)       # (G,c,T,T,NG)
        M = _q(CB[..., None] * Lm.reshape(G, nci, T, T, NG, rep), mm)
        dx = dtf[..., None] * xs                              # fp32
        y_diag = torch.einsum("gctskr,gcskrp->gctkrp", M,
                              _q(dx, mm).reshape(G, nci, T, NG, rep, P))
        wdx = _q(torch.exp(total[:, :, None] - cum)[..., None] * dx, mm)
        S_chunk = torch.einsum("gcskn,gcskrp->gckrnp", Bq,
                               wdx.reshape(G, nci, T, NG, rep, P))
        e_end = torch.exp(total).reshape(G, nci, NG, rep, 1, 1)

        h_c = h.reshape(G, NG, rep, N, P)
        entries = [None] * nci
        for c in (range(nci - 1, -1, -1) if reverse else range(nci)):
            entries[c] = h_c
            h_c = e_end[:, c] * h_c + S_chunk[:, c]
        h = h_c.reshape(G, H, N, P)
        entries = torch.stack(entries, 1)
        if carries is not None:
            carries[:, s0 // T:s1 // T] = entries.reshape(
                G, nci, H, N, P).to(carries.dtype)
        y_in = torch.einsum("gctkn,gckrnp->gctkrp", Cq, _q(entries, mm))
        ecum = torch.exp(cum).reshape(G, nci, T, NG, rep, 1)
        ys = (y_diag + ecum * y_in).reshape(G, s1 - s0, H, P)
        if D is not None:
            ys = ys + xs.reshape(G, s1 - s0, H, P) * D.float()[:, None]
        y[:, s0:r1] = ys[:, :r1 - s0].to(mm)
    if return_carries:
        return y, h, carries
    if return_final_state:
        return y, h
    return y


def ssd_chunked_fused(
    xBC: torch.Tensor,                      # (G, L, H·P + 2·NG·N) pre-conv
    dt: torch.Tensor,                       # (G, L, H) raw
    A: torch.Tensor,                        # (H,)
    conv_w: torch.Tensor,                   # (K, Wc)
    conv_b: Optional[torch.Tensor] = None,  # (Wc,)
    D: Optional[torch.Tensor] = None,
    dt_bias: Optional[torch.Tensor] = None,
    dims: Tuple[int, int, int, int] = None,  # (H, P, NG, N)
    dt_softplus: bool = False,
    reverse: bool = False,
    chunk_size: int = 64,
    h_init: Optional[torch.Tensor] = None,  # (G, H, N, P) fp32
    return_final_state: bool = False,
    return_carries: bool = False,
):
    """Chunked dual form with the conv fused (see module docstring).

    Returns y (G, L, H, P) in xBC's dtype, and hN (G, H, N, P) fp32 when
    ``return_final_state``. ``return_carries`` returns (y, hN, carries):
    the state at the entry (in scan order) of every chunk, (G, nc, H, N, P)
    indexed by the chunk's position in the array, in
    `carry_dtype(xBC.dtype)` — the residual `ssd_chunked_fused_bwd`
    reads."""
    H, P, NG, N = dims
    Wc = xBC.shape[2]
    assert Wc == H * P + 2 * NG * N, (xBC.shape, dims)
    mm = xBC.dtype
    w = conv_w.float()
    b = None if conv_b is None else conv_b.float()

    def load(s0, r1):
        xc = _conv_silu_rows(xBC, w, b, s0, r1, reverse)
        return (xc[..., :H * P], _q(xc[..., H * P:H * P + NG * N], mm),
                _q(xc[..., H * P + NG * N:], mm))

    return _chunked(load, dt, A, D, dt_bias, dims, dt_softplus, reverse,
                    chunk_size, h_init, return_final_state, return_carries, mm)


def ssd_chunked(
    x: torch.Tensor,                        # (G, L, H, P) post-conv
    dt: torch.Tensor,                       # (G, L, H) raw
    A: torch.Tensor,                        # (H,)
    B_mat: torch.Tensor,                    # (G, L, NG, N)
    C: torch.Tensor,                        # (G, L, NG, N)
    D: Optional[torch.Tensor] = None,       # (H,)
    dt_bias: Optional[torch.Tensor] = None,  # (H,)
    dt_softplus: bool = False,
    reverse: bool = False,
    chunk_size: int = 64,
    h_init: Optional[torch.Tensor] = None,  # (G, H, N, P) fp32
    return_final_state: bool = False,
    return_carries: bool = False,
):
    """The unfused chunked dual form on post-conv x, B and C: the plain
    version of the `ssd_fwd` CUDA kernel (`ops/ssd_batched.py`), and the
    port of `caduceus_tpu/ops/ssd.py ssd_chunked` without its fused-conv
    mode. The chunk body and the precision policy are those of
    `ssd_chunked_fused` (matmul operands rounded to x's dtype, fp32 cumsum,
    decays and state); outputs as there."""
    G, L, H, P = x.shape
    NG, N = B_mat.shape[-2:]
    mm = x.dtype

    def load(s0, r1):
        n = r1 - s0
        return (x[:, s0:r1].float().reshape(G, n, H * P),
                _q(B_mat[:, s0:r1].reshape(G, n, NG * N), mm),
                _q(C[:, s0:r1].reshape(G, n, NG * N), mm))

    return _chunked(load, dt, A, D, dt_bias, (H, P, NG, N), dt_softplus,
                    reverse, chunk_size, h_init, return_final_state,
                    return_carries, mm)


def ssd_step(
    h: torch.Tensor,                        # (G, H, N, P) fp32 state
    x_t: torch.Tensor,                      # (G, H, P)
    dt_t: torch.Tensor,                     # (G, H) raw
    A: torch.Tensor,                        # (H,)
    B_t: torch.Tensor,                      # (G, NG, N)
    C_t: torch.Tensor,                      # (G, NG, N)
    D: Optional[torch.Tensor] = None,       # (H,)
    dt_bias: Optional[torch.Tensor] = None,
    dt_softplus: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step (O(1) per token), the port of
    `caduceus_tpu/ops/ssd.py ssd_step`: returns (h, y_t), y_t in x_t's
    dtype."""
    G, H, N, P = h.shape
    NG = B_t.shape[-2]
    rep = H // NG
    dtf = _resolve_dt(dt_t, dt_bias, dt_softplus)
    da = torch.exp(dtf * A.float()).reshape(G, NG, rep)
    dx = (dtf[..., None] * x_t.float()).reshape(G, NG, rep, P)
    h_r = (da[..., None, None] * h.reshape(G, NG, rep, N, P)
           + B_t.float()[:, :, None, :, None] * dx[:, :, :, None, :])
    y = torch.einsum("bgrnp,bgn->bgrp", h_r, C_t.float()).reshape(G, H, P)
    if D is not None:
        y = y + x_t.float() * D.float()[:, None]
    return h_r.reshape(G, H, N, P), y.to(x_t.dtype)


def _adjoint(load, store, dt, A, D, dt_bias, g_y, carries, g_hN, dims,
             dt_softplus, reverse, T, mm):
    """The chunk body of the SSD adjoint, shared by `ssd_adjoint_xc` and
    `ssd_chunked_bwd` (the plain versions of the two forms of the backward
    kernel `ssd_fused_bwd_kernel`).

    ``load(s0, r1)`` gives the forward's fp32 x (G, r1 - s0, H·P) and the
    B, C (G, r1 - s0, NG·N) of rows [s0, r1), B and C rounded to ``mm``, the
    storage dtype; ``store(s0, r1, g_x, g_B, g_C)`` takes their fp32
    gradients for the same rows. Returns ``(g_dt, g_A, g_D, g_dt_bias,
    g_h0)``: g_dt in dt's dtype, the rest fp32.

    It walks the adjoint of `_bwd_kernel` (`caduceus_tpu/ops/
    ssd_pallas_batched.py:554-749`) chunk by chunk against the scan order,
    with λ = the gradient of the chunk's exit state (g_hN at the scan's end),
    per head h of group k, G_ts = g_y_t · dx_s and LG = Lm ⊙ G:

        g_dx  = (CB ⊙ Lm)ᵀ @ g_y + w ⊙ (B @ λ)
        g_C   = Σ_h LG_h @ B + (exp(cum) ⊙ g_y) @ h_inᵀ
        g_B   = Σ_h LG_hᵀ @ C + (w ⊙ dx) @ λᵀ
        g_cum = rowsum(LG⊙CB) − colsum(LG⊙CB) + exp(cum)·Σ_p g_y·(C @ h_in)
                − w·Σ_p dx·(B @ λ) + 1[t = last]·Σ λ·h_out
        g_a   = suffix sum of g_cum in scan order (fp32)
        λ     ← exp(Σa)·λ + Cᵀ @ (exp(cum) ⊙ g_y)

    then the softplus chain on g_dt. Precision policy as the forward:
    matmul operands rounded to ``mm`` (each head's LG on its own, as the
    kernel sums the heads' products), fp32 accumulation, fp32 cumsums and
    λ; h_in is the carry as saved."""
    H, P, NG, N = dims
    G, L = dt.shape[:2]
    rep = H // NG
    dev = dt.device
    Af = A.float()
    Df = (torch.zeros(H, device=dev) if D is None else D.float())
    nc = -(-L // T)
    Lp = nc * T
    assert carries.shape == (G, nc, H, N, P), (carries.shape, (G, nc, H, N, P))
    lam = (torch.zeros(G, NG, rep, N, P, device=dev) if g_hN is None
           else g_hN.float().reshape(G, NG, rep, N, P).clone())
    g_dt = torch.zeros(G, L, H, device=dev)
    g_A = torch.zeros(H, device=dev)
    g_bias = torch.zeros(H, device=dev)
    g_D = torch.zeros(H, device=dev)
    keep = _keep_mask(T, reverse, dev)
    last = torch.zeros(T, device=dev)
    last[0 if reverse else T - 1] = 1.0

    seg = T * _SEG_CHUNKS
    starts = list(range(0, Lp, seg))
    for s0 in (starts if reverse else reversed(starts)):
        s1 = min(s0 + seg, Lp)
        r1 = min(s1, L)
        nci = (s1 - s0) // T
        pad = s1 - r1
        xs, Bq, Cq = (F.pad(t, (0, 0, 0, pad)) for t in load(s0, r1))
        dtf = F.pad(_resolve_dt(dt[:, s0:r1], dt_bias, dt_softplus),
                    (0, 0, 0, pad)).reshape(G, nci, T, H)
        xs = xs.reshape(G, nci, T, NG, rep, P)
        Bq = Bq.reshape(G, nci, T, NG, N)
        Cq = Cq.reshape(G, nci, T, NG, N)
        gy = F.pad(g_y[:, s0:r1].float(), (0, 0, 0, 0, 0, pad)).reshape(
            G, nci, T, NG, rep, P)
        h_in = carries[:, s0 // T:s1 // T].float().reshape(
            G, nci, NG, rep, N, P)

        a = dtf * Af
        cum = a.flip(2).cumsum(2).flip(2) if reverse else a.cumsum(2)
        total = a.sum(2)                                      # (G, c, H)
        ecum = torch.exp(cum).reshape(G, nci, T, NG, rep, 1)
        wv = torch.exp(total[:, :, None] - cum).reshape(G, nci, T, NG, rep, 1)
        e_end = torch.exp(total).reshape(G, nci, NG, rep, 1, 1)
        segm = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (G,c,T,T,H)
        Lm = torch.exp(torch.where(keep[:, :, None], segm,
                                   torch.full_like(segm, -float("inf"))))
        Lm = Lm.reshape(G, nci, T, T, NG, rep)
        dx = dtf.reshape(G, nci, T, NG, rep, 1) * xs
        wdx = wv * dx
        gy_e = ecum * gy

        CB = torch.einsum("gctkn,gcskn->gctsk", Cq, Bq)[..., None]
        G_ts = torch.einsum("gctkrp,gcskrp->gctskr", _q(gy, mm), _q(dx, mm))
        LG = Lm * G_ts
        lgcb = LG * CB
        rowcol = (lgcb.sum(3) - lgcb.sum(2)).reshape(G, nci, T, H)
        gdx = torch.einsum("gctskr,gctkrp->gcskrp", _q(CB * Lm, mm),
                           _q(gy, mm))
        Ch = torch.einsum("gctkn,gckrnp->gctkrp", Cq, _q(h_in, mm))
        S = torch.einsum("gcskn,gcskrp->gckrnp", Bq, _q(wdx, mm))
        h_out = e_end * h_in + S
        cterm = torch.einsum("gctkn,gctkrp->gckrnp", Cq, _q(gy_e, mm))

        lams = [None] * nci
        gend = [None] * nci
        for c in (range(nci) if reverse else range(nci - 1, -1, -1)):
            lams[c] = lam
            gend[c] = (lam * h_out[:, c]).sum((-2, -1)).reshape(G, H)
            lam = e_end[:, c] * lam + cterm[:, c]
        lams = torch.stack(lams, 1)                           # (G,c,k,r,N,P)
        gend = torch.stack(gend, 1)                           # (G, c, H)

        Blam = torch.einsum("gcskn,gckrnp->gcskrp", Bq, _q(lams, mm))
        g_dxv = gdx + wv * Blam
        qs = (ecum * (gy * Ch).sum(-1, keepdim=True)).reshape(G, nci, T, H)
        us = (wv * (dx * Blam).sum(-1, keepdim=True)).reshape(G, nci, T, H)
        r3 = (xs * g_dxv).sum(-1).reshape(G, nci, T, H)
        g_cum = rowcol + qs - us + last[:, None] * gend[:, :, None]
        g_a = g_cum.cumsum(2) if reverse else g_cum.flip(2).cumsum(2).flip(2)
        g_dts = Af * g_a + r3
        if dt_softplus:
            g_dts = g_dts * (1.0 - torch.exp(-dtf))
        valid = (torch.arange(s0, s1, device=dev) < L).reshape(1, nci, T, 1)
        g_dts = torch.where(valid, g_dts, torch.zeros_like(g_dts))
        g_A += (dtf * g_a).sum((0, 1, 2))
        g_bias += g_dts.sum((0, 1, 2))
        g_D += (gy * xs).sum((0, 1, 2, 5)).reshape(H)

        g_x = (dtf.reshape(G, nci, T, NG, rep, 1) * g_dxv
               + Df.reshape(NG, rep, 1) * gy)
        g_C = (torch.einsum("gctskr,gcskn->gctkn", _q(LG, mm), Bq)
               + torch.einsum("gctkrp,gckrnp->gctkn", _q(gy_e, mm),
                              _q(h_in, mm)))
        g_B = (torch.einsum("gctskr,gctkn->gcskn", _q(LG, mm), Cq)
               + torch.einsum("gcskrp,gckrnp->gcskn", _q(wdx, mm),
                              _q(lams, mm)))
        n = r1 - s0
        store(s0, r1, g_x.reshape(G, s1 - s0, H * P)[:, :n],
              g_B.reshape(G, s1 - s0, NG * N)[:, :n],
              g_C.reshape(G, s1 - s0, NG * N)[:, :n])
        g_dt[:, s0:r1] = g_dts.reshape(G, s1 - s0, H)[:, :n]

    return (g_dt.to(dt.dtype), g_A, g_D, g_bias, lam.reshape(G, H, N, P))


def ssd_adjoint_xc(
    xBC: torch.Tensor,                      # (G, L, Wc) pre-conv
    dt: torch.Tensor,                       # (G, L, H) raw
    A: torch.Tensor,                        # (H,)
    conv_w: torch.Tensor,                   # (K, Wc)
    conv_b: Optional[torch.Tensor],         # (Wc,)
    D: Optional[torch.Tensor],              # (H,)
    dt_bias: Optional[torch.Tensor],        # (H,)
    g_y: torch.Tensor,                      # (G, L, H, P), xBC's dtype
    carries: torch.Tensor,                  # (G, nc, H, N, P) chunk entries
    g_hN: Optional[torch.Tensor],           # (G, H, N, P) fp32
    dims: Tuple[int, int, int, int],        # (H, P, NG, N)
    dt_softplus: bool = False,
    reverse: bool = False,
    chunk_size: int = 64,
):
    """The SSD part of the adjoint of `ssd_chunked_fused`, from its saved
    chunk carries: the plain version of `ssd_fused_bwd_kernel` (K >= 1).
    Returns ``(g_xc, g_dt, g_A, g_D, g_dt_bias, g_h0)``: g_xc = d loss / d
    silu(pre) (G, L, Wc) fp32, the input of `conv_silu_bwd`; g_dt in dt's
    dtype; the rest fp32. The chunk body is `_adjoint`'s, on the x, B and C
    that the forward recomputes from xBC."""
    H, P, NG, N = dims
    G, L, Wc = xBC.shape
    assert Wc == H * P + 2 * NG * N, (xBC.shape, dims)
    mm = xBC.dtype
    w = conv_w.float()
    b = None if conv_b is None else conv_b.float()
    g_xc = torch.zeros(G, L, Wc, device=xBC.device)

    def load(s0, r1):
        xc = _conv_silu_rows(xBC, w, b, s0, r1, reverse)
        return (xc[..., :H * P], _q(xc[..., H * P:H * P + NG * N], mm),
                _q(xc[..., H * P + NG * N:], mm))

    def store(s0, r1, g_x, g_B, g_C):
        g_xc[:, s0:r1] = torch.cat([g_x, g_B, g_C], -1)

    g_dt, g_A, g_D, g_bias, g_h0 = _adjoint(
        load, store, dt, A, D, dt_bias, g_y, carries, g_hN, dims, dt_softplus,
        reverse, chunk_size, mm)
    return g_xc, g_dt, g_A, g_D, g_bias, g_h0


def ssd_chunked_bwd(
    x: torch.Tensor,                        # (G, L, H, P) post-conv
    dt: torch.Tensor,                       # (G, L, H) raw
    A: torch.Tensor,                        # (H,)
    B_mat: torch.Tensor,                    # (G, L, NG, N)
    C: torch.Tensor,                        # (G, L, NG, N)
    D: Optional[torch.Tensor],              # (H,)
    dt_bias: Optional[torch.Tensor],        # (H,)
    g_y: torch.Tensor,                      # (G, L, H, P), x's dtype
    carries: torch.Tensor,                  # (G, nc, H, N, P) chunk entries
    g_hN: Optional[torch.Tensor],           # (G, H, N, P) fp32
    dt_softplus: bool = False,
    reverse: bool = False,
    chunk_size: int = 64,
):
    """Adjoint of `ssd_chunked` from its saved chunk carries: the plain
    version of the unfused backward kernel `ssd_bwd` (the K = 0 form of
    `ssd_fused_bwd_kernel`), the CPU path's backward, and the port of the
    JAX package's `ssd_pallas_bwd_impl` / `ssd_pallas_batched_bwd_impl`
    (TPU kernels #6 and #4, one function in two VMEM layouts).

    Returns ``(g_x, g_dt, g_A, g_B, g_C, g_D, g_dt_bias, g_h0)``, their
    order: g_x / g_dt in the dtypes of x / dt; g_B, g_C (G, L, NG, N) fp32,
    the sums over the heads of each group; the rest fp32. The chunk body is
    `_adjoint`'s, on the post-conv x, B and C as given."""
    G, L, H, P = x.shape
    NG, N = B_mat.shape[-2:]
    mm = x.dtype
    dev = x.device
    g_x = torch.empty(G, L, H * P, device=dev)
    g_B = torch.empty(G, L, NG * N, device=dev)
    g_C = torch.empty(G, L, NG * N, device=dev)

    def load(s0, r1):
        n = r1 - s0
        return (x[:, s0:r1].float().reshape(G, n, H * P),
                _q(B_mat[:, s0:r1].reshape(G, n, NG * N), mm),
                _q(C[:, s0:r1].reshape(G, n, NG * N), mm))

    def store(s0, r1, gx, gB, gC):
        g_x[:, s0:r1], g_B[:, s0:r1], g_C[:, s0:r1] = gx, gB, gC

    g_dt, g_A, g_D, g_bias, g_h0 = _adjoint(
        load, store, dt, A, D, dt_bias, g_y, carries, g_hN, (H, P, NG, N),
        dt_softplus, reverse, chunk_size, mm)
    return (g_x.reshape(G, L, H, P).to(mm), g_dt, g_A,
            g_B.reshape(G, L, NG, N), g_C.reshape(G, L, NG, N), g_D, g_bias,
            g_h0)


def conv_silu_bwd(
    g_xc: torch.Tensor,                     # (G, L, Wc) fp32
    xBC: torch.Tensor,                      # (G, L, Wc) pre-conv
    conv_w: torch.Tensor,                   # (K, Wc)
    conv_b: Optional[torch.Tensor],         # (Wc,)
    reverse: bool = False,
):
    """SiLU and depthwise-conv adjoints over the whole array, from
    g_xc = d loss / d silu(pre): the plain version of `ssd_conv_bwd_kernel`.
    Returns (g_xBC in xBC's dtype, g_conv_w, g_conv_b) (fp32). Over every
    row at once the conv transpose needs no chunk-to-chunk spillover."""
    G, L, Wc = xBC.shape
    K = conv_w.shape[0]
    dev = xBC.device
    w = conv_w.float()
    b = None if conv_b is None else conv_b.float()
    pre = _conv_pre_rows(xBC, w, b, 0, L, reverse)
    sig = torch.sigmoid(pre)
    g_pre = g_xc * sig * (1.0 + pre * (1.0 - sig))
    del pre, sig
    xf = xBC.float()
    # forward: pre[i] = Σ_k w[k]·x[i-(K-1)+k]; reverse: Σ_k w[k]·x[i+K-1-k]
    front = (0, 0, K - 1, 0)
    back = (0, 0, 0, K - 1)
    gp = F.pad(g_pre, front if reverse else back)
    xp = F.pad(xf, back if reverse else front)
    g_raw = torch.zeros_like(g_pre)
    g_w = torch.empty(K, Wc, device=dev)
    for k in range(K):
        o_g = k if reverse else K - 1 - k     # g_pre row read for row j
        o_x = K - 1 - k if reverse else k     # x row tap k read for row i
        g_raw += w[k] * gp[:, o_g:o_g + L]
        g_w[k] = (xp[:, o_x:o_x + L] * g_pre).sum((0, 1))
    return g_raw.to(xBC.dtype), g_w, g_pre.sum((0, 1))


def ssd_chunked_fused_bwd(xBC, dt, A, conv_w, conv_b, D, dt_bias, g_y,
                          carries, g_hN, dims, dt_softplus=False,
                          reverse=False, chunk_size=64):
    """Adjoint of `ssd_chunked_fused` from its saved chunk carries, the
    plain version of the `ssd_fused_bwd` CUDA kernels: `ssd_adjoint_xc` then
    `conv_silu_bwd` (see their docstrings; same arguments).

    Returns ``(g_xBC, g_dt, g_A, g_conv_w, g_conv_b, g_D, g_dt_bias,
    g_h0)``, the tuple of the JAX package's
    `ssd_pallas_batched_fused_bwd_impl` (without its context-parallel edge
    gradient): g_xBC / g_dt in the dtypes of xBC / dt, the rest fp32."""
    g_xc, g_dt, g_A, g_D, g_bias, g_h0 = ssd_adjoint_xc(
        xBC, dt, A, conv_w, conv_b, D, dt_bias, g_y, carries, g_hN, dims,
        dt_softplus, reverse, chunk_size)
    g_xBC, g_w, g_b = conv_silu_bwd(g_xc, xBC, conv_w, conv_b, reverse)
    return g_xBC, g_dt, g_A, g_w, g_b, g_D, g_bias, g_h0
