"""The Mamba-1 selective scan in plain PyTorch, written for this benchmark.

For every row g, channel d and state n (fp32 throughout):

    a[t,d,n] = exp(delta[t,d] A[d,n])
    h[t,d,n] = a[t,d,n] h[t-1,d,n] + delta[t,d] u[t,d] B[t,n]
    y[t,d]   = sum_n C[t,n] h[t,d,n]

`selective_scan(u, delta, A, B, C)` takes the resolved (softplus'd) delta
and returns y without the D skip. It never holds the (G, L, d, N) states:
the rows are cut into chunks of `CHUNK` rows, a Python loop walks the
`CHUNK` positions of every chunk at once (first from a zero state, to get
each chunk's end state), a scan over the chunks gives the state entering
each chunk, and a second walk from those states gives y. The backward is
the explicit adjoint

    lam[t] = C[t] g_y[t] + a[t+1] lam[t+1]

computed the same way against the scan order, with h recomputed per chunk.
Rows past L are identity steps (delta = 0, B = C = 0).
"""

from __future__ import annotations

import torch

CHUNK = 64
# rows of the batch processed together: bounds the (rows, nc, d, N) fp32
# temporaries and the CHUNK stored states of the backward
ROW_BLOCK = 4


def _pad(t: torch.Tensor, Lp: int) -> torch.Tensor:
    L = t.shape[1]
    if L == Lp:
        return t
    pad = torch.zeros(t.shape[0], Lp - L, *t.shape[2:], dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, pad], dim=1)


def _chunk_carries(P: torch.Tensor, S: torch.Tensor,
                   reverse: bool) -> torch.Tensor:
    """Exclusive scan over the chunk axis (1) of x[c] = P[c] x[c-1] + S[c]
    (against it when ``reverse``): the value entering every chunk."""
    if reverse:
        return _chunk_carries(P.flip(1), S.flip(1), False).flip(1)
    a, b = P, S
    k = 1
    nc = a.shape[1]
    while k < nc:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return torch.cat([torch.zeros_like(b[:, :1]), b[:, :-1]], dim=1)


def _views(u, dl, B, C, T):
    g, Lp, d = u.shape
    nc = Lp // T
    return (u.view(g, nc, T, d), dl.view(g, nc, T, d),
            B.view(g, nc, T, -1), C.view(g, nc, T, -1))


def _walk_states(ur, dr, Br, A, h):
    """Walk the T positions of every chunk from ``h`` (g, nc, d, N); yields
    (t, a_t, h_t)."""
    for t in range(ur.shape[2]):
        a = torch.exp(dr[:, :, t, :, None] * A)
        h = torch.addcmul((dr[:, :, t] * ur[:, :, t])[..., None]
                          * Br[:, :, t, None, :], a, h)
        yield t, a, h


def _carries(ur, dr, Br, A):
    g, nc, T, d = ur.shape
    N = A.shape[-1]
    h = torch.zeros(g, nc, d, N, device=ur.device)
    for _, _, h in _walk_states(ur, dr, Br, A, h):
        pass
    P = torch.exp(dr.sum(2)[..., None] * A)
    return _chunk_carries(P, h, reverse=False)


def _forward_block(u, dl, A, B, C, T):
    ur, dr, Br, Cr = _views(u, dl, B, C, T)
    H = _carries(ur, dr, Br, A)
    y = torch.empty_like(ur)
    for t, _, h in _walk_states(ur, dr, Br, A, H):
        y[:, :, t] = torch.einsum("gcdn,gcn->gcd", h, Cr[:, :, t])
    return y.reshape(u.shape)


def _backward_block(u, dl, A, B, C, gy, T):
    ur, dr, Br, Cr = _views(u, dl, B, C, T)
    gyr = gy.view(ur.shape)
    g, nc, _, d = ur.shape
    H = _carries(ur, dr, Br, A)
    hs = [H]
    for _, _, h in _walk_states(ur, dr, Br, A, H):
        hs.append(h)
    # each chunk's adjoint from a zero state, then the adjoint entering each
    # chunk from the chunks after it
    carry = torch.zeros_like(H)
    for t in range(T - 1, -1, -1):
        lam = Cr[:, :, t, None, :] * gyr[:, :, t, :, None] + carry
        carry = torch.exp(dr[:, :, t, :, None] * A) * lam
    P = torch.exp(dr.sum(2)[..., None] * A)
    # mu[c] = a[first row of c+1] lam[first row of c+1], scanned backwards
    mu = _chunk_carries(P, carry, reverse=True)
    g_u = torch.empty_like(ur)
    g_dl = torch.empty_like(dr)
    g_B = torch.empty_like(Br)
    g_C = torch.empty_like(Cr)
    g_A = torch.zeros_like(A)
    carry = mu
    for t in range(T - 1, -1, -1):
        lam = Cr[:, :, t, None, :] * gyr[:, :, t, :, None] + carry
        a, h_prev, h = torch.exp(dr[:, :, t, :, None] * A), hs[t], hs[t + 1]
        s = torch.einsum("gcdn,gcn->gcd", lam, Br[:, :, t])
        ga = lam * h_prev * a                      # d/d(delta A) of the decay
        g_u[:, :, t] = dr[:, :, t] * s
        g_dl[:, :, t] = ur[:, :, t] * s + torch.einsum("gcdn,dn->gcd", ga, A)
        g_A += torch.einsum("gcdn,gcd->dn", ga, dr[:, :, t])
        g_B[:, :, t] = torch.einsum("gcdn,gcd->gcn", lam,
                                    dr[:, :, t] * ur[:, :, t])
        g_C[:, :, t] = torch.einsum("gcdn,gcd->gcn", h, gyr[:, :, t])
        carry = a * lam
    shape = u.shape
    return (g_u.reshape(shape), g_dl.reshape(shape), g_A,
            g_B.reshape(B.shape), g_C.reshape(C.shape))


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, dl, A, B, C):
        G, L, _ = u.shape
        T = CHUNK
        Lp = -(-L // T) * T
        up, dp, Bp, Cp = (_pad(t.float(), Lp) for t in (u, dl, B, C))
        ys = [_forward_block(up[i:i + ROW_BLOCK], dp[i:i + ROW_BLOCK],
                             A.float(), Bp[i:i + ROW_BLOCK],
                             Cp[i:i + ROW_BLOCK], T)
              for i in range(0, G, ROW_BLOCK)]
        ctx.save_for_backward(u, dl, A, B, C)
        return torch.cat(ys)[:, :L]

    @staticmethod
    def backward(ctx, gy):
        u, dl, A, B, C = ctx.saved_tensors
        G, L, _ = u.shape
        T = CHUNK
        Lp = -(-L // T) * T
        up, dp, Bp, Cp, gp = (_pad(t.float(), Lp) for t in (u, dl, B, C, gy))
        parts = [_backward_block(up[i:i + ROW_BLOCK], dp[i:i + ROW_BLOCK],
                                 A.float(), Bp[i:i + ROW_BLOCK],
                                 Cp[i:i + ROW_BLOCK], gp[i:i + ROW_BLOCK], T)
                 for i in range(0, G, ROW_BLOCK)]
        g_u, g_dl, g_A, g_B, g_C = zip(*parts)
        return (torch.cat(g_u)[:, :L], torch.cat(g_dl)[:, :L],
                torch.stack(g_A).sum(0), torch.cat(g_B)[:, :L],
                torch.cat(g_C)[:, :L])


def selective_scan(u, delta, A, B, C):
    """y (G, L, d) fp32 of the scan over u, delta (G, L, d), A (d, N), B, C
    (G, L, N); differentiable in all five."""
    return _Scan.apply(u, delta, A, B, C)


def selective_scan_sequential(u, delta, A, B, C):
    """The recurrence as written, one row at a time (the tests' oracle)."""
    G, L, d = u.shape
    h = torch.zeros(G, d, A.shape[-1], dtype=torch.float32, device=u.device)
    ys = []
    for t in range(L):
        h = (torch.exp(delta[:, t, :, None] * A) * h
             + (delta[:, t] * u[:, t])[..., None] * B[:, t, None, :])
        ys.append(torch.einsum("gdn,gn->gd", h, C[:, t]))
    return torch.stack(ys, dim=1)
