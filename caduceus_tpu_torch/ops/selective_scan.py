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

- `selective_scan_runs` / `selective_scan_runs_bwd` compute the same
  functions by the kernels' decomposition (csrc/scan_common.cuh): each
  chunk cut into runs of ``run_rows`` rows, each run's affine aggregate
  (prod dA, h from 0; for the adjoint, lam's aggregate walked backwards), a
  scan of the aggregates across the runs from the chunk's carry, and each
  run re-walked from its incoming state with the same dA. The tests hold
  them to the serial versions above.

``z`` gates y as the JAX kernel's ``has_z`` does: y = (sum_n C h + D u) *
z sigmoid(z), in fp32, rounded once.

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
# rows a thread of the kernels walks per chunk (`R` in csrc/scan_common.cuh)
RUN_ROWS = 8


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


def silu_gate(y: torch.Tensor, z: Optional[torch.Tensor]) -> torch.Tensor:
    """y * z sigmoid(z) in fp32 (y unchanged without z)."""
    return y if z is None else y * F.silu(z.float())


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
    chunk_size: int = 256,
    h_init: Optional[torch.Tensor] = None,     # (G, d, N) fp32
    return_final_state: bool = False,
    return_carries: bool = False,
    z: Optional[torch.Tensor] = None,          # (G, L, d) gate
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
    y = silu_gate(torch.cat(ys[::-1] if reverse else ys, dim=1), z)
    y = y.to(u.dtype)
    out = (y,)
    if return_final_state:
        out += (h,)
    if return_carries:
        out += (torch.stack([cars[c] for c in range(nc)], 1),)
    return out if len(out) > 1 else y


def selective_scan_bwd(u, delta, A, B, C, D, delta_bias, g_y, carries, g_hN,
                       delta_softplus=False, reverse=False, chunk_size=256):
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


def _run_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of the maps x -> a x + b along ``dim`` (log-depth):
    (prod a, x from 0) of every prefix."""
    a, b = _inclusive_scan(a.movedim(dim, 2), b.movedim(dim, 2))
    return a.movedim(2, dim), b.movedim(2, dim)


def _exclusive(a: torch.Tensor, b: torch.Tensor, dim: int):
    """The inclusive prefixes shifted by one along ``dim``: the identity map
    (1, 0) first."""
    one = torch.ones_like(a.narrow(dim, 0, 1))
    return (torch.cat([one, a.narrow(dim, 0, a.shape[dim] - 1)], dim),
            torch.cat([torch.zeros_like(one), b.narrow(dim, 0, b.shape[dim] - 1)],
                      dim))


def _runs_inputs(u, delta, A, B, C, delta_bias, delta_softplus, reverse, T,
                 run_rows):
    """Scan-order fp32 (G, nc, lanes, run_rows, ·) views of u, the resolved
    delta, B, C, and dA, over the whole (padded) sequence."""
    G, L, d = u.shape
    nc = -(-L // T)
    if T % run_rows:
        raise ValueError(f"run_rows {run_rows} must divide chunk_size {T}")
    uf, dl, Bf, Cf = _segment_inputs(u, delta, B, C, delta_bias,
                                     delta_softplus, 0, L, nc, T, reverse)
    lanes = (G, nc, T // run_rows, run_rows)
    uf, dl, Bf, Cf = (t.reshape(*lanes, t.shape[-1]) for t in (uf, dl, Bf, Cf))
    return uf, dl, Bf, Cf, _decay(dl, A.float())


def selective_scan_runs(u, delta, A, B, C, D=None, delta_bias=None,
                        delta_softplus=False, reverse=False, chunk_size=256,
                        h_init=None, run_rows=RUN_ROWS, z=None,
                        drop_run=None):
    """`selective_scan` by the kernels' decomposition: (y, hN, carries).
    Per chunk, each run's aggregate (prod dA, h from 0), a scan of the
    aggregates across the runs from the chunk's carry (the chunks chained
    in scan order), each run re-walked from its incoming state.
    ``drop_run``: the run (in scan order) whose incoming state is taken as
    0 in every chunk, the fault the card checks plant in the kernels
    (`csrc/scan_common.cuh` SCAN_DROP=1)."""
    G, L, d = u.shape
    N = A.shape[-1]
    T = chunk_size
    nc = -(-L // T)
    uf, dl, Bf, Cf, dA = _runs_inputs(u, delta, A, B, C, delta_bias,
                                      delta_softplus, reverse, T, run_rows)
    v = (dl * uf)[..., None] * Bf[..., None, :]        # (G, nc, l, R, d, N)
    a, b = _run_scan(dA, v, 3)                         # within each run
    Pi, Hi = _run_scan(a[:, :, :, -1], b[:, :, :, -1], 2)   # across runs
    Pe, He = _exclusive(Pi, Hi, 2)
    h = (torch.zeros(G, d, N, device=u.device) if h_init is None
         else h_init.float())
    enter, cars = [], []
    for c in range(nc):                                # scan order
        cars.append(h)
        enter.append(Pe[:, c] * h[:, None] + He[:, c])
        h = Pi[:, c, -1] * h + Hi[:, c, -1]
    enter = torch.stack(enter, 1)                      # (G, nc, l, d, N)
    if drop_run is not None:
        enter[:, :, drop_run] = 0
    hs = a * enter[:, :, :, None] + b
    y = torch.einsum("gclrdn,gclrn->gclrd", hs, Cf)
    if D is not None:
        y = y + uf * D.float()
    y = _unsegment(y.reshape(G, nc * T, d), 0, L, reverse)
    y = silu_gate(y, z).to(u.dtype)
    if reverse:
        cars = cars[::-1]
    return y, h, torch.stack(cars, 1)


def selective_scan_runs_bwd(u, delta, A, B, C, D, delta_bias, g_y, carries,
                            g_hN, delta_softplus=False, reverse=False,
                            chunk_size=256, run_rows=RUN_ROWS, drop_run=None):
    """`selective_scan_bwd` by the kernels' decomposition, the same eight
    outputs. Per chunk from its carry: h recomputed as in
    `selective_scan_runs`; lam's run aggregates (lam -> prod dA lam + K,
    each run walked backwards), a scan of them against the run order from
    the later chunk's lam, each run re-walked from its incoming lam.
    ``drop_run``: the run whose incoming lam is taken as 0."""
    G, L, d = u.shape
    N = A.shape[-1]
    T = chunk_size
    nc = -(-L // T)
    if tuple(carries.shape) != (G, nc, d, N):
        raise ValueError(f"carries {tuple(carries.shape)}, expected "
                         f"{(G, nc, d, N)} for chunk_size {T}")
    Af = A.float()
    uf, dl, Bf, Cf, dA = _runs_inputs(u, delta, A, B, C, delta_bias,
                                      delta_softplus, reverse, T, run_rows)
    gy = _segment(g_y, 0, L, nc * T, reverse).reshape(uf.shape)
    car = carries.float()
    if reverse:
        car = car.flip(1)                              # scan order
    du = dl * uf
    a, b = _run_scan(dA, du[..., None] * Bf[..., None, :], 3)
    Pi, Hi = _run_scan(a[:, :, :, -1], b[:, :, :, -1], 2)
    Pe, He = _exclusive(Pi, Hi, 2)
    enter = Pe * car[:, :, None] + He                  # (G, nc, l, d, N)
    h = a * enter[:, :, :, None] + b                   # state after each row
    hp = torch.cat([enter[:, :, :, None], h[:, :, :, :-1]], 3)
    # lam walked backwards: x -> dA (x + C g_y) per row, runs and lanes
    # flipped
    cg = Cf[..., None, :] * gy[..., None]
    la, lb = _run_scan(dA.flip(3), (dA * cg).flip(3), 3)
    Pl, Kl = _run_scan(la[:, :, :, -1].flip(2), lb[:, :, :, -1].flip(2), 2)
    Ple, Kle = _exclusive(Pl, Kl, 2)
    lam = (torch.zeros(G, d, N, device=u.device) if g_hN is None
           else g_hN.float())
    lin = [None] * nc
    for c in range(nc - 1, -1, -1):                    # the scan's last first
        lin[c] = (Ple[:, c] * lam[:, None] + Kle[:, c]).flip(1)
        lam = Pl[:, c, -1] * lam + Kl[:, c, -1]
    lin = torch.stack(lin, 1)                          # (G, nc, l, d, N)
    if drop_run is not None:
        lin[:, :, drop_run] = 0
    # lam entering each row from the later side, then li = lam + C g_y
    ex_a, ex_b = _exclusive(la, lb, 3)
    li = (ex_a * lin[:, :, :, None] + ex_b).flip(3) + cg
    lam_h = li * dA * hp
    g_C = torch.einsum("gclrd,gclrdn->gclrn", gy, h)
    g_B = torch.einsum("gclrdn,gclrd->gclrn", li, du)
    g_du = torch.einsum("gclrdn,gclrn->gclrd", li, Bf)
    g_dd = torch.einsum("gclrdn,dn->gclrd", lam_h, Af)
    g_delta = g_dd + uf * g_du
    if delta_softplus:
        g_delta = g_delta * (1.0 - torch.exp(-dl))
    g_u = dl * g_du if D is None else gy * D.float() + dl * g_du
    g_A = torch.einsum("gclrdn,gclrd->dn", lam_h, dl)
    g_D = (gy * uf).sum((0, 1, 2, 3))
    g_u, g_delta, g_B, g_C = (_unsegment(t.reshape(G, nc * T, -1), 0, L,
                                         reverse)
                              for t in (g_u, g_delta, g_B, g_C))
    return (g_u.to(u.dtype), g_delta.to(delta.dtype), g_A, g_B.to(B.dtype),
            g_C.to(C.dtype), g_D, g_delta.float().sum((0, 1)), lam)
