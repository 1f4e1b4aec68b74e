"""Sequence-parallel (context-parallel) scans: the sequence axis sharded
over the ranks of one mesh axis, each rank holding a contiguous shard.

Port of `caduceus_tpu/parallel/seq_scan.py` (`sequence_parallel_scan`,
`sequence_parallel_ssd`, `sequence_parallel_ssd_fused`). The same exact
two-pass construction:

1. local pass from a zero state: the shard's final state b_s; the shard's
   total decay is analytic, A_prod_s = exp(A * sum_t dt) (per channel and
   state for the v1 scan, per head for the SSD);
2. boundary exchange: every shard's (A_prod, b) gathered (`comm.all_gather`,
   a few KB per shard), and the exclusive prefix in scan order (right to
   left when ``reverse``) gives this shard's incoming state;
3. correction pass: the local scan again from that state.

Pass 2's incoming state comes from pass 1's final state, so under grad the
local adjoint receives a final-state cotangent and returns dL/dh_init
(`ops/scan.py` `_SelectiveScanFn`, `ops/ssd_batched.py` `_SSDFn` /
`_SSDFusedCPFn`). The arguments are this rank's shards; parameters are
whole. On CUDA tensors the local scans are the kernels (#7 / #8 for v1; #2
/ #4, or #5 / #6 per head, unfused; the context-parallel entry of #1 / #3
fused), on CPU tensors their plain versions.

Under tensor parallelism composed with CP (JAX: the SSDs' ``head_axis``
in the same shard_map) the arguments are this rank's heads: the x lanes
(and their conv taps) of its H / M heads and the B / C lanes of its
groups, whole or cut with the heads, with ``dims`` and the per-head
parameters its own. Every step is per head, so the body is the same and
every exchange names ``axis`` only; the caller passes a B / C lane that
every rank holds whole through `comm.copy_to_axis`, which sums its
partial gradients over the heads.
"""

from __future__ import annotations

from typing import Optional

import torch

from caduceus_tpu_torch.ops.scan import selective_scan_chained
from caduceus_tpu_torch.ops.selective_scan import resolve_delta, silu_gate
from caduceus_tpu_torch.ops.ssd import HIST_ROWS, _resolve_dt
from caduceus_tpu_torch.ops.ssd_batched import ssd_batched_fused_cp
from caduceus_tpu_torch.ops.ssd_head import resolve_ssd_kernel
from caduceus_tpu_torch.parallel.comm import all_gather, halo_shift
from caduceus_tpu_torch.parallel.mesh import Axis


def incoming_state(A_prod: torch.Tensor, b_s: torch.Tensor, axis: Axis,
                   reverse: bool) -> torch.Tensor:
    """This shard's incoming state from every shard's (A_prod, b_s): the
    exclusive prefix h <- A_prod_s h + b_s over the shards in scan order,
    in fp32. The selection is a one-hot sum, so every rank's result depends
    on every gathered value and the graph is the same on every rank."""
    a_all = all_gather(A_prod, axis)
    b_all = all_gather(b_s, axis)
    order = range(axis.size - 1, -1, -1) if reverse else range(axis.size)
    h_run = torch.zeros_like(b_s)
    mine = torch.zeros_like(b_s)
    for s in order:
        mine = mine + float(s == axis.rank) * h_run
        h_run = a_all[s] * h_run + b_all[s]
    return mine


def sequence_parallel_scan(
    u: torch.Tensor,                        # (G, L_loc, d)
    delta: torch.Tensor,
    A: torch.Tensor,                        # (d, N)
    B_mat: torch.Tensor,                    # (G, L_loc, N)
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    reverse: bool = False,
    *,
    axis: Axis,
) -> torch.Tensor:
    """The v1 selective scan of a sequence sharded over ``axis``: this
    shard's y, gated by SiLU(z) when given. Local scans:
    `ops/scan.py selective_scan_chained`."""
    G, _, d = u.shape
    N = A.shape[-1]
    zero_h = torch.zeros(G, d, N, dtype=torch.float32, device=u.device)
    _, b_s = selective_scan_chained(u, delta, A, B_mat, C, None, delta_bias,
                                    zero_h, delta_softplus, reverse)
    dsum = resolve_delta(delta, delta_bias, delta_softplus).sum(1)   # (G, d)
    A_prod = torch.exp(dsum[..., None] * A.float()[None])            # (G, d, N)
    h0 = incoming_state(A_prod, b_s, axis, reverse)
    y, _ = selective_scan_chained(u, delta, A, B_mat, C, D, delta_bias, h0,
                                  delta_softplus, reverse)
    return y if z is None else silu_gate(y.float(), z).to(y.dtype)


def sequence_parallel_ssd(
    x: torch.Tensor,                        # (G, L_loc, H, P) post-conv
    dt: torch.Tensor,                       # (G, L_loc, H)
    A: torch.Tensor,                        # (H,)
    B_mat: torch.Tensor,                    # (G, L_loc, NG, N)
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    dt_bias: Optional[torch.Tensor] = None,
    dt_softplus: bool = False,
    reverse: bool = False,
    *,
    axis: Axis,
    local_impl: str = "pallas_batched",
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """The SSD of a sequence sharded over ``axis`` on post-conv x, B, C:
    this shard's y (G, L_loc, H, P). ``local_impl`` picks the local scans as
    `ops/ssd_head.py resolve_ssd_kernel` maps a ``use_kernel`` string:
    "pallas_batched*" the head-batched `ssd_batched_chained` (#2 / #4),
    "pallas*" the per-head `ssd_head_chained` (#5 / #6)."""
    chained = resolve_ssd_kernel(local_impl)[1]
    G, _, H, P = x.shape
    N = B_mat.shape[-1]
    zero_h = torch.zeros(G, H, N, P, dtype=torch.float32, device=x.device)
    _, b_s = chained(x, dt, A, B_mat, C, None, dt_bias, zero_h, dt_softplus,
                     reverse, chunk_size)
    dsum = _resolve_dt(dt, dt_bias, dt_softplus).sum(1)              # (G, H)
    A_prod = torch.exp(dsum * A.float()[None])[..., None, None]
    h0 = incoming_state(A_prod, b_s, axis, reverse)
    y, _ = chained(x, dt, A, B_mat, C, D, dt_bias, h0, dt_softplus, reverse,
                   chunk_size)
    return y


def sequence_parallel_ssd_fused(
    xBC: torch.Tensor,                      # (G, L_loc, H·P + 2·NG·N) pre-conv
    dt: torch.Tensor,                       # (G, L_loc, H)
    A: torch.Tensor,                        # (H,)
    conv_w: torch.Tensor,                   # (K, Wc)
    conv_b: Optional[torch.Tensor] = None,
    D: Optional[torch.Tensor] = None,
    dt_bias: Optional[torch.Tensor] = None,
    dims=None,                              # (H, P, NG, N)
    dt_softplus: bool = False,
    reverse: bool = False,
    *,
    axis: Axis,
    chunk_size: Optional[int] = None,
    seg_chunks: int = 8,
    cp_chunk_size: int = 128,
) -> torch.Tensor:
    """The fused-conv SSD of a sequence sharded over ``axis``: the conv +
    SiLU + x/B/C split run inside the context-parallel kernel entry
    (`ops/ssd_batched.py ssd_batched_fused_cp`), whose conv reads the
    neighbour shard's 8 boundary raw rows (one `comm.halo_shift`; zeros at
    the sequence edge) in place of the zero history. Their gradient, the
    conv transpose's spill past this shard's edge, travels back through the
    same exchange into the neighbour's g_xBC. The shard length must suit
    the entry (`ops/ssd_batched.py fused_cp_ok` of ``cp_chunk_size`` and
    ``seg_chunks``)."""
    if dims is None:
        raise ValueError("dims=(H, P, NG, N) is required")
    H, P, NG, N = dims
    G = xBC.shape[0]
    rows = xBC[:, :HIST_ROWS] if reverse else xBC[:, -HIST_ROWS:]
    edge = halo_shift(rows, axis, to_next=not reverse)
    kw = dict(dims=dims, dt_softplus=dt_softplus, reverse=reverse,
              chunk_size=chunk_size, seg_chunks=seg_chunks,
              cp_chunk_size=cp_chunk_size)
    zero_h = torch.zeros(G, H, N, P, dtype=torch.float32, device=xBC.device)
    _, b_s = ssd_batched_fused_cp(xBC, dt, A, conv_w, conv_b, None, dt_bias,
                                  zero_h, edge, **kw)
    dsum = _resolve_dt(dt, dt_bias, dt_softplus).sum(1)
    A_prod = torch.exp(dsum * A.float()[None])[..., None, None]
    h0 = incoming_state(A_prod, b_s, axis, reverse)
    y, _ = ssd_batched_fused_cp(xBC, dt, A, conv_w, conv_b, D, dt_bias, h0,
                                edge, **kw)
    return y
