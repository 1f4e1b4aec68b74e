"""Selective scan (the Mamba-1 recurrence) — plain PyTorch versions.

Port of `caduceus_tpu/ops/selective_scan.py`. For every row g, channel d
and state n:

    delta[t,d] = softplus(delta_raw[t,d] + bias[d])          (optional)
    h[t,d,n]   = exp(delta[t,d] A[d,n]) h[t-1,d,n] + delta[t,d] B[t,n] u[t,d]
    y[t,d]     = sum_n C[t,n] h[t,d,n] + D[d] u[t,d]

with the fp32 state (G, d, N). Layout (G, L, d), channels last.

- `selective_scan_ref` is the sequential oracle.
- `selective_scan` is the chunked form: the plain version of the
  `selective_scan_fwd` / `bidir_scan_fwd` CUDA kernels (`ops/scan.py`).
  It takes ``h_init``, ``reverse`` and a ragged L, returns the final
  state and, on request, the chunk carries: the fp32 state entering every
  chunk of ``chunk_size`` rows in scan order, (G, nc, d, N) indexed by
  array chunk, as the kernel writes them.
- `selective_scan_bwd` is the explicit adjoint from those carries, the
  plain version of the `selective_scan_bwd` kernel: per chunk, h is
  recomputed from the chunk's carry, then the adjoint
  ``lam[t] = C[t] g_y[t] + dA[t+1] lam[t+1]`` is swept against the scan
  order (`caduceus_tpu/ops/scan_pallas.py:26-36`). Autograd through
  `selective_scan` would keep (G, L, d, N) states, far too much at
  L = 131072.

Both walk the rows in segments of whole chunks (`_SEG_ROWS` rows per step
of the Python loop), with a log-depth scan inside each chunk and the
chunks chained one after another; ``reverse`` flips one segment at a
time. Rows past L are identity steps (resolved delta 0, u = B = C = 0),
the semantics of `_pad_state_transparent` (`scan_pallas.py:79`).

softplus is ``max(x, 0) + log1p(exp(-|x|))`` everywhere (the kernels
too): `torch.nn.functional.softplus` switches to x above 20.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# rows per step of the plain versions' segment loop: bounds their
# (G, rows, d, N) fp32 temporaries (134 MB each at G=4, d=512, N=16)
_SEG_ROWS = 1024
LOG2E = 1.4426950408889634


def _decay(dl: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """dA = exp(delta A) as the kernels compute it, exp2(delta (A log2 e))
    with A scaled first: at the model's small delta a state remembers
    thousands of rows, and a last-bit difference in dA at every row would
    add up over them."""
    return torch.exp2(dl[..., None] * (A.float() * LOG2E))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def resolve_delta(delta, delta_bias, delta_softplus):
    d = delta.float()
    if delta_bias is not None:
        d = d + delta_bias.float()
    return softplus(d) if delta_softplus else d


def selective_scan_ref(
    u: torch.Tensor,                           # (G, L, d)
    delta: torch.Tensor,                       # (G, L, d) raw
    A: torch.Tensor,                           # (d, N) negative
    B: torch.Tensor,                           # (G, L, N)
    C: torch.Tensor,                           # (G, L, N)
    D: Optional[torch.Tensor] = None,          # (d,)
    delta_bias: Optional[torch.Tensor] = None,  # (d,)
    delta_softplus: bool = False,
    reverse: bool = False,
    h_init: Optional[torch.Tensor] = None,     # (G, d, N) fp32
    return_final_state: bool = False,
):
    """Sequential reference implementation (numerics oracle)."""
    G, L, d = u.shape
    N = A.shape[-1]
    dl = resolve_delta(delta, delta_bias, delta_softplus)
    uf, Af, Bf, Cf = u.float(), A.float(), B.float(), C.float()
    h = (torch.zeros(G, d, N, device=u.device) if h_init is None
         else h_init.float())
    ys = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        dA = torch.exp(dl[:, t, :, None] * Af)
        h = dA * h + (dl[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
        ys[t] = torch.einsum("gdn,gn->gd", h, Cf[:, t])
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + uf * D.float()
    y = y.to(u.dtype)
    return (y, h) if return_final_state else y


def _inclusive_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of x[t] = a[t] x[t-1] + b[t] along dim 2 (zero
    entry state), log-depth: returns (prod a[0..t], x[t])."""
    T = a.shape[2]
    k = 1
    while k < T:
        a_lo, b_lo = a[:, :, :-k], b[:, :, :-k]
        a_hi, b_hi = a[:, :, k:], b[:, :, k:]
        b = torch.cat([b[:, :, :k], a_hi * b_lo + b_hi], dim=2)
        a = torch.cat([a[:, :, :k], a_hi * a_lo], dim=2)
        k *= 2
    return a, b


def _segments(nc: int, T: int, reverse: bool):
    """(c0, c1) chunk ranges of the segment loop, in scan order."""
    step = max(1, _SEG_ROWS // T)
    segs = [(c, min(c + step, nc)) for c in range(0, nc, step)]
    return segs[::-1] if reverse else segs


def _segment(t: torch.Tensor, r0: int, r1: int, rows: int, reverse: bool):
    """Rows [r0, r1) of a (G, L, ·) tensor in fp32, zero-padded to ``rows``
    and in scan order (flipped when ``reverse``)."""
    s = t[:, r0:r1].float()
    if r1 - r0 < rows:
        s = F.pad(s, (0, 0, 0, rows - (r1 - r0)))
    return s.flip(1) if reverse else s


def _chunked(s: torch.Tensor, n: int, T: int) -> torch.Tensor:
    return s.reshape(s.shape[0], n, T, *s.shape[2:])


def _unsegment(s: torch.Tensor, r0: int, r1: int, reverse: bool):
    """Inverse of `_segment`: (G, rows, ·) in scan order -> rows [r0, r1)
    in array order."""
    s = s.flip(1) if reverse else s
    return s[:, :r1 - r0]


def _segment_inputs(u, delta, B, C, delta_bias, delta_softplus, r0, r1, n,
                    T, reverse):
    """Scan-order fp32 chunks (G, n, T, ·) of u, the resolved delta, B, C
    for rows [r0, r1); rows past L are identity steps (all zero)."""
    rows = n * T
    dl = resolve_delta(delta[:, r0:r1], delta_bias, delta_softplus)
    dl = _segment(dl, 0, r1 - r0, rows, reverse)
    u, B, C = (_segment(t, r0, r1, rows, reverse) for t in (u, B, C))
    return tuple(_chunked(s, n, T) for s in (u, dl, B, C))


def selective_scan(
    u: torch.Tensor,                           # (G, L, d)
    delta: torch.Tensor,                       # (G, L, d) raw
    A: torch.Tensor,                           # (d, N)
    B: torch.Tensor,                           # (G, L, N)
    C: torch.Tensor,                           # (G, L, N)
    D: Optional[torch.Tensor] = None,          # (d,)
    delta_bias: Optional[torch.Tensor] = None,  # (d,)
    delta_softplus: bool = False,
    reverse: bool = False,
    chunk_size: int = 64,
    h_init: Optional[torch.Tensor] = None,     # (G, d, N) fp32
    return_final_state: bool = False,
    return_carries: bool = False,
):
    """Chunked selective scan. Returns y (G, L, d) in u's dtype, then hN
    (G, d, N) fp32 when ``return_final_state``, then the carries (G, nc,
    d, N) fp32 when ``return_carries``."""
    G, L, d = u.shape
    N = A.shape[-1]
    T = chunk_size
    nc = -(-L // T)
    Af = A.float()
    h = (torch.zeros(G, d, N, device=u.device) if h_init is None
         else h_init.float())
    ys, cars = [], {}
    for c0, c1 in _segments(nc, T, reverse):
        n = c1 - c0
        r0, r1 = c0 * T, min(c1 * T, L)
        uf, dl, Bf, Cf = _segment_inputs(u, delta, B, C, delta_bias,
                                         delta_softplus, r0, r1, n, T,
                                         reverse)
        dA = _decay(dl, Af)                                # (G, n, T, d, N)
        v = (dl * uf)[..., None] * Bf[:, :, :, None, :]
        a, b = _inclusive_scan(dA, v)
        hs = []
        for j in range(n):   # chain the chunks in scan order
            cars[c1 - 1 - j if reverse else c0 + j] = h
            hj = a[:, j] * h[:, None] + b[:, j]
            hs.append(hj)
            h = hj[:, -1]
        y = torch.einsum("gjtdn,gjtn->gjtd", torch.stack(hs, 1), Cf)
        if D is not None:
            y = y + uf * D.float()
        ys.append(_unsegment(y.reshape(G, n * T, d), r0, r1, reverse))
    y = torch.cat(ys[::-1] if reverse else ys, dim=1).to(u.dtype)
    out = (y,)
    if return_final_state:
        out += (h,)
    if return_carries:
        out += (torch.stack([cars[c] for c in range(nc)], 1),)
    return out if len(out) > 1 else y


def selective_scan_bwd(u, delta, A, B, C, D, delta_bias, g_y, carries, g_hN,
                       delta_softplus=False, reverse=False, chunk_size=64):
    """Adjoint of `selective_scan` from its carries (the contract of
    `selective_scan_pallas_bwd_impl`, `scan_pallas.py:549-684`, chained
    as `selective_scan_pallas_chained`): returns ``(g_u, g_delta, g_A,
    g_B, g_C, g_D, g_bias, g_h0)``. g_u, g_delta, g_B and g_C are in the
    dtypes of u, delta, B and C; g_A (d, N), g_D (d,), g_bias (d,) and
    g_h0 (G, d, N) are fp32 (g_D / g_bias are returned even when D / bias
    is None). ``g_hN`` may be None (zeros)."""
    G, L, d = u.shape
    N = A.shape[-1]
    T = chunk_size
    nc = -(-L // T)
    if tuple(carries.shape) != (G, nc, d, N):
        raise ValueError(f"carries {tuple(carries.shape)}, expected "
                         f"{(G, nc, d, N)} for chunk_size {T}")
    Af = A.float()
    Df = None if D is None else D.float()
    lam = (torch.zeros(G, d, N, device=u.device) if g_hN is None
           else g_hN.float())
    g_A = torch.zeros(d, N, device=u.device)
    g_D = torch.zeros(d, device=u.device)
    g_bias = torch.zeros(d, device=u.device)
    outs = []   # per segment (g_u, g_delta, g_B, g_C), in array order
    # the adjoint walks the scan backwards: segments and chunks in reverse
    for c0, c1 in _segments(nc, T, reverse)[::-1]:
        n = c1 - c0
        rows = n * T
        r0, r1 = c0 * T, min(c1 * T, L)
        uf, dl, Bf, Cf = _segment_inputs(u, delta, B, C, delta_bias,
                                         delta_softplus, r0, r1, n, T,
                                         reverse)
        gy = _chunked(_segment(g_y, r0, r1, rows, reverse), n, T)
        car = carries[:, c0:c1].float()
        if reverse:
            car = car.flip(1)    # scan order
        # recompute h over each chunk from its carry
        dA = _decay(dl, Af)                                # (G, n, T, d, N)
        du = dl * uf
        a, b = _inclusive_scan(dA, du[..., None] * Bf[:, :, :, None, :])
        h = a * car[:, :, None] + b
        h_prev = torch.cat([car[:, :, None], h[:, :, :-1]], dim=2)
        # lam_inc[t] = C[t] g_y[t] + dA[t+1] lam_inc[t+1]: a scan over the
        # flipped chunk with coefficients dA[t+1], chained chunk by chunk
        w = (Cf[:, :, :, None, :] * gy[..., None]).flip(2)
        coef = torch.cat([torch.ones_like(dA[:, :, :1]),
                          dA.flip(2)[:, :, :-1]], dim=2)
        pa, pb = _inclusive_scan(coef, w)
        lis = [None] * n
        for j in range(n - 1, -1, -1):
            li = pa[:, j] * lam[:, None] + pb[:, j]        # flipped rows
            lis[j] = li.flip(1)
            lam = dA[:, j, 0] * lis[j][:, 0]
        li = torch.stack(lis, 1)                           # (G, n, T, d, N)
        g_C = torch.einsum("gjtd,gjtdn->gjtn", gy, h)
        g_B = torch.einsum("gjtdn,gjtd->gjtn", li, du)
        g_du = torch.einsum("gjtdn,gjtn->gjtd", li, Bf)
        lam_h = li * dA * h_prev
        g_dd = torch.einsum("gjtdn,dn->gjtd", lam_h, Af)
        g_delta = g_dd + uf * g_du
        if delta_softplus:
            g_delta = g_delta * (1.0 - torch.exp(-dl))
        g_u = gy * Df + dl * g_du if Df is not None else dl * g_du
        # rows past L are zero in u, g_y and delta: no share in g_A / g_D;
        # g_delta is cut to the real rows before it is summed
        g_A = g_A + torch.einsum("gjtdn,gjtd->dn", lam_h, dl)
        seg = [_unsegment(t.reshape(G, rows, -1), r0, r1, reverse)
               for t in (g_u, g_delta, g_B, g_C)]
        g_D = g_D + (gy * uf).sum((0, 1, 2))
        g_bias = g_bias + seg[1].sum((0, 1))
        outs.append(seg)
    if not reverse:
        outs = outs[::-1]      # segments were visited right to left
    g_u, g_delta, g_B, g_C = (torch.cat(p, dim=1) for p in zip(*outs))
    return (g_u.to(u.dtype), g_delta.to(delta.dtype), g_A, g_B.to(B.dtype),
            g_C.to(C.dtype), g_D, g_bias, lam)
