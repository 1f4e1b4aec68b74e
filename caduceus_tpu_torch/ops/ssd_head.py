"""Per-head SSD: the port of `caduceus_tpu/ops/ssd_pallas.py`'s public
surface (`ssd_pallas_chained`, `ssd_pallas`, `resolve_ssd_kernel`), the
route of ``ssm_cfg.use_kernel = "pallas"`` (TPU kernels #5, the forward,
and #6, its adjoint).

On the TPU the per-head kernels keep a (H·N, P) state in VMEM and the
head-batched ones (`ops/ssd_pallas_batched.py`, #2 and #4) a (N, H·P)
state: two layouts of one function. On the card both families are the
same kernels, one block per (g, h) with that head's (N, P) state in shared
memory: the K = 0 forward `ssd_fwd_kernel` of `csrc/ssd_fused_fwd.cu` and
the K = 0 backward `ssd_fused_bwd_kernel` of `csrc/ssd_fused_bwd.cu`
(`ops/ssd_batched.py launch_fwd` / `launch_bwd`). This module is their
second entry, with its own launch counters, ``head_fwd_launches`` and
``head_bwd_launches``, so that a run can tell the per-head model path from
the head-batched callers.

On a CPU tensor everything here is the plain version, `ops/ssd.py
ssd_chunked` (differentiated by autograd) and `ssd_chunked_bwd`; on a CUDA
tensor the kernels, or it raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from caduceus_tpu_torch.ops import ssd_batched
from caduceus_tpu_torch.ops.ssd import ssd_chunked_bwd

head_fwd_launches = 0
head_bwd_launches = 0


def ssd_head_fwd(x, dt, A, B_mat, C, D, dt_bias, dt_softplus, reverse,
                 chunk_size, h_init, save_carries: bool):
    """One launch of the forward kernel on CUDA tensors (TPU kernel #5),
    counted in ``head_fwd_launches``: (y, hN, carries), as
    `ops/ssd_batched.py launch_fwd`."""
    out = ssd_batched.launch_fwd(x, dt, A, B_mat, C, D, dt_bias, dt_softplus,
                                 reverse, chunk_size, h_init, save_carries)
    global head_fwd_launches
    head_fwd_launches += 1
    return out


def ssd_head_bwd(x, dt, A, B_mat, C, D, dt_bias, g_y, carries, g_hN,
                 dt_softplus=False, reverse=False, chunk_size=None):
    """The adjoint from the forward's carries (TPU kernel #6), `ops/ssd.py
    ssd_chunked_bwd` semantics and tuple ``(g_x, g_dt, g_A, g_B, g_C, g_D,
    g_dt_bias, g_h0)``: that plain version on a CPU tensor, one launch of
    the backward kernel on a CUDA tensor, counted in
    ``head_bwd_launches``."""
    if chunk_size is None:
        chunk_size = ssd_batched.KERNEL_CHUNK.get(x.dtype, 64)
    if not ssd_batched.on_card(x, "ssd_head_bwd"):
        return ssd_chunked_bwd(x, dt, A, B_mat, C, D, dt_bias,
                               g_y.to(x.dtype), carries, g_hN, dt_softplus,
                               reverse, chunk_size)
    out = ssd_batched.launch_bwd(x, dt, A, B_mat, C, D, dt_bias, g_y,
                                 carries, g_hN, dt_softplus, reverse,
                                 chunk_size)
    global head_bwd_launches
    head_bwd_launches += 1
    return out


def ssd_head_chained(
    x: torch.Tensor,                        # (G, L, H, P) post-conv
    dt: torch.Tensor,                       # (G, L, H) raw
    A: torch.Tensor,                        # (H,)
    B_mat: torch.Tensor,                    # (G, L, NG, N)
    C: torch.Tensor,                        # (G, L, NG, N)
    D: Optional[torch.Tensor] = None,       # (H,)
    dt_bias: Optional[torch.Tensor] = None,  # (H,)
    h_init: Optional[torch.Tensor] = None,  # (G, H, N, P) fp32
    dt_softplus: bool = True,
    reverse: bool = False,
    chunk_size: Optional[int] = None,
):
    """The counterpart of `ssd_pallas_chained`: (y (G, L, H, P) in x's
    dtype, hN (G, H, N, P) fp32), differentiable in every input with a
    cotangent for hN. ``chunk_size`` defaults to the kernel's
    (`ops/ssd_batched.py KERNEL_CHUNK`); x, B, C and dt may be column views
    of wider tensors (each row's values contiguous)."""
    return ssd_batched.chained(x, dt, A, B_mat, C, D, dt_bias, h_init,
                               dt_softplus, reverse, chunk_size, ssd_head_fwd,
                               ssd_head_bwd, "ssd_head_chained")


def ssd_head(x, dt, A, B_mat, C, D=None, dt_bias=None,
             dt_softplus: bool = False, reverse: bool = False,
             chunk_size: Optional[int] = None,
             h_init: Optional[torch.Tensor] = None,
             return_final_state: bool = False):
    """The counterpart of `ssd_pallas`, a drop-in for `ops/ssd.py
    ssd_chunked`: `ssd_head_chained` from h_init (zeros when None); y, and
    hN when ``return_final_state``."""
    y, hN = ssd_head_chained(x, dt, A, B_mat, C, D, dt_bias, h_init,
                             dt_softplus, reverse, chunk_size)
    return (y, hN) if return_final_state else y


def resolve_ssd_kernel(kernel: str):
    """Map a ``use_kernel`` string to the port's ``(ssd_fn, chained_fn)``,
    as `caduceus_tpu/ops/ssd_pallas.py resolve_ssd_kernel` maps it to the
    JAX functions: ``"pallas_batched"`` / ``"pallas_batched_interpret"``
    select the head-batched entry (`ops/ssd_batched.py`), any other string
    (``"pallas"``, ``"pallas_interpret"``) the per-head one. Interpret mode
    has no counterpart: on a CPU tensor every entry runs its plain
    version."""
    if kernel.startswith("pallas_batched"):
        return ssd_batched.ssd_batched, ssd_batched.ssd_batched_chained
    return ssd_head, ssd_head_chained
