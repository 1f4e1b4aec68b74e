"""The Mamba-2 state-space dual (SSD) scan in plain PyTorch, written for
this benchmark: the chunked matrix form of the Mamba-2 paper
(arXiv:2405.21060, section 6, its minimal listing), differentiated by
autograd. For every row g, head h, head channel p and state n:

    a[t,h]     = exp(dt[t,h] A[h])
    s[t,h,p,n] = a[t,h] s[t-1,h,p,n] + dt[t,h] x[t,h,p] B[t,grp(h),n]
    y[t,h,p]   = sum_n C[t,grp(h),n] s[t,h,p,n]

Within a chunk of `CHUNK` rows the product runs as masked (T x T)
matrices; across chunks the states are carried by a (nc x nc) decay
matrix whose exponents are differences of float64 cumulative sums, so a
long run of strong decay does not cost the short ranges their precision.
Rows past L are identity steps (dt = 0).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

CHUNK = 128
# chunks per checkpointed block
BLOCK_CHUNKS = 64


def _pad(t: torch.Tensor, Lp: int) -> torch.Tensor:
    L = t.shape[1]
    if L == Lp:
        return t
    return torch.cat([t, t.new_zeros(t.shape[0], Lp - L, *t.shape[2:])], 1)


def _intra(x, dt, Bg, Cg, A, rep: int):
    """One block of chunks: the in-chunk outputs, each chunk's end state
    from zero and its in-chunk cumulative decay."""
    T = x.shape[2]
    dA = dt * A                                           # (G, c, T, H)
    cum = torch.cumsum(dA, dim=2)
    # decay from row s to row t (s <= t) within a chunk
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (G, c, t, s, H)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                                  torch.full_like(diff, -torch.inf)))
    # C·B once per group, shared by the group's heads
    cb = torch.einsum("gctkn,gcskn->gctsk", Cg, Bg)
    cb = cb.repeat_interleave(rep, dim=-1)                # (G, c, t, s, H)
    y = torch.einsum("gctsh,gcshp->gcthp", cb * decay * dt[:, :, None], x)
    B = Bg.repeat_interleave(rep, dim=3)                  # (G, c, T, H, N)
    to_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("gcshn,gcshp->gchpn", B * (to_end * dt)[..., None],
                          x)
    return y, states, cum


def _from_entering(Cg, cum, entering, rep: int):
    """One block of chunks: the outputs of the state entering each chunk."""
    C = Cg.repeat_interleave(rep, dim=3)
    return torch.einsum("gcthn,gchpn->gcthp", C * torch.exp(cum)[..., None],
                        entering)


def ssd(x, dt, A, B, C):
    """y (G, L, H, P) fp32 of x (G, L, H, P), resolved dt (G, L, H), A (H)
    negative, B and C (G, L, NG, N); without the D skip. The chunks run in
    blocks of `BLOCK_CHUNKS`, each under its own checkpoint, so that a
    backward holds one block's (T x T) products at a time."""
    G, L, H, P = x.shape
    NG, N = B.shape[2:]
    T = CHUNK
    Lp = -(-L // T) * T
    nc = Lp // T
    x, dt, B, C = (_pad(t.float(), Lp) for t in (x, dt, B, C))
    rep = H // NG
    x = x.view(G, nc, T, H, P)
    dt = dt.view(G, nc, T, H)
    Bg = B.view(G, nc, T, NG, N)
    Cg = C.view(G, nc, T, NG, N)
    A = A.float()
    blocks = [slice(i, min(i + BLOCK_CHUNKS, nc))
              for i in range(0, nc, BLOCK_CHUNKS)]
    parts = [checkpoint(_intra, x[:, b], dt[:, b], Bg[:, b], Cg[:, b], A,
                        rep, use_reentrant=False) for b in blocks]
    y = torch.cat([p[0] for p in parts], dim=1)
    states = torch.cat([p[1] for p in parts], dim=1)      # (G, nc, H, P, N)
    cum = torch.cat([p[2] for p in parts], dim=1)         # (G, nc, T, H)
    # the state entering chunk z: sum over c < z of the decay from the end
    # of chunk c to the start of chunk z
    chunk_cum = torch.cumsum(cum[:, :, -1, :].double(), dim=1)  # (G, nc, H)
    between = chunk_cum[:, :-1, None, :] - chunk_cum[:, None, :-1, :]
    lower = torch.ones(nc - 1, nc - 1, dtype=torch.bool,
                       device=x.device).tril()
    carry_w = torch.exp(torch.where(lower[None, :, :, None], between,
                                    torch.full_like(between, -torch.inf)))
    # row z = 0 takes nothing
    carry_w = torch.cat([carry_w.new_zeros(G, 1, nc - 1, H), carry_w], dim=1)
    carry_w = carry_w.float()                             # (G, z, c<nc-1, H)
    entering = torch.einsum("gzch,gchpn->gzhpn", carry_w, states[:, :-1])
    y = y + torch.cat([checkpoint(_from_entering, Cg[:, b], cum[:, b],
                                  entering[:, b], rep, use_reentrant=False)
                       for b in blocks], dim=1)
    return y.reshape(G, Lp, H, P)[:, :L]


def ssd_sequential(x, dt, A, B, C):
    """The recurrence as written, one row at a time (the tests' oracle)."""
    G, L, H, P = x.shape
    NG, N = B.shape[2:]
    rep = H // NG
    s = torch.zeros(G, H, P, N, dtype=x.dtype, device=x.device)
    ys = []
    for t in range(L):
        Bt = B[:, t].repeat_interleave(rep, dim=1)
        Ct = C[:, t].repeat_interleave(rep, dim=1)
        s = (torch.exp(dt[:, t] * A)[..., None, None] * s
             + (dt[:, t, :, None] * x[:, t])[..., None] * Bt[:, :, None, :])
        ys.append(torch.einsum("ghpn,ghn->ghp", s, Ct))
    return torch.stack(ys, dim=1)
