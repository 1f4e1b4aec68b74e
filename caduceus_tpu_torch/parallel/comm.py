"""Differentiable exchanges between the ranks of one mesh axis.

The counterparts of what the JAX package's context parallelism gets from
`lax.all_gather`, `lax.ppermute` and the halos and flips that XLA inserts on
sequence-sharded arrays. Each is a `torch.autograd.Function` on an explicit
`ProcessGroup` (`mesh.Axis`), built on two collectives only, all_gather and
all_reduce, which the gloo backend offers for CUDA tensors as well as NCCL
(gloo's send / recv take CPU tensors only):

- `all_gather`: every rank's tensor, stacked in rank order. Backward: the
  gathered gradients all-reduced, and this rank's slice of them.
- `halo_shift`: each rank's boundary rows to the next rank (``to_next``) or
  to the previous one, zeros where there is none (the sequence edge): a
  ppermute. Backward: the gradient goes the other way.
- `reverse_shards`: rank s takes rank n-1-s's tensor (a flip of the
  sharded sequence axis is this and a local flip). Backward: the same.
- `conv_halo`: the K-1 rows a shard's causal conv reads from its
  neighbour (a `halo_shift` of its boundary rows).
- `all_reduce_`: an in-place sum over the axis, for values outside autograd
  (gradients, metrics).
- `copy_to_axis` / `reduce_from_axis`: Megatron's two conjugate exchanges
  of tensor parallelism. `copy_to_axis` is the identity, and all-reduces
  the gradient: it marks where a value every rank holds whole enters a
  computation each rank does on its own slice (a column-parallel product,
  the B / C lanes of a head-sharded scan), whose gradients are partial.
  `reduce_from_axis` all-reduces the ranks' partial sums (a row-parallel
  product), and its backward is the identity. Both sum in fp32: a bf16
  value is reduced as fp32 and rounded once, as one rank's fp32-accumulated
  product rounds its sum.

Every rank of the axis must call the same exchanges in the same order, in
the backward too: the functions here keep the graph the same on every rank
(an edge rank receives zeros from the exchange, not from a different
branch), so the autograd engine runs their backwards in one order
everywhere.
"""

from __future__ import annotations

import torch

from caduceus_tpu_torch.parallel.mesh import Axis


def _gather(t: torch.Tensor, axis: Axis):
    """Every rank's ``t`` (same shape everywhere), in rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(axis.size)]
    axis.group.allgather([out], [t]).wait()
    return out


def all_reduce_(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``t`` over the axis, in place (no autograd); returns it."""
    if axis.size > 1:
        axis.group.allreduce([t]).wait()
    return t


def _sum_fp32(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``t`` over the axis, reduced in fp32 and returned in
    ``t``'s dtype (one rounding)."""
    out = t.detach().to(torch.float32, memory_format=torch.contiguous_format,
                        copy=True)
    return all_reduce_(out, axis).to(t.dtype)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(g, ctx.axis), None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return _sum_fp32(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_axis(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``t`` itself; its gradient summed over the axis."""
    if axis.size == 1:
        return t
    return _CopyToAxis.apply(t, axis)


def reduce_from_axis(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of the ranks' ``t`` (fp32 sums of a bf16 ``t`` rounded
    once); the gradient passes through unchanged."""
    if axis.size == 1:
        return t
    return _ReduceFromAxis.apply(t, axis)


def row_parallel_linear(x: torch.Tensor, w: torch.Tensor, b, dtype,
                        axis: Axis) -> torch.Tensor:
    """``x @ wᵀ + b`` in ``dtype`` where ``x`` and ``w`` hold this rank's
    slice of the contraction: the partial products in fp32 (of the
    ``dtype`` operands), `reduce_from_axis`, one rounding to ``dtype``,
    then the bias, which every rank holds whole."""
    part = x.to(dtype).float() @ w.to(dtype).float().t()
    y = reduce_from_axis(part, axis).to(dtype)
    return y if b is None else y + b.to(dtype)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return torch.stack(_gather(t, axis))

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.axis)
        return g[ctx.axis.rank], None


def all_gather(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` in rank order, differentiable."""
    if axis.size == 1:
        return t[None]
    return _AllGather.apply(t, axis)


def _pick(parts, src: int, like: torch.Tensor) -> torch.Tensor:
    return parts[src] if 0 <= src < len(parts) else torch.zeros_like(like)


class _HaloShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, axis, to_next):
        ctx.axis, ctx.to_next = axis, to_next
        src = axis.rank - 1 if to_next else axis.rank + 1
        return _pick(_gather(rows, axis), src, rows).clone()

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        # the rank that received this rank's rows sends their gradient back
        dst = axis.rank + 1 if ctx.to_next else axis.rank - 1
        return _pick(_gather(g, axis), dst, g).clone(), None, None


def halo_shift(rows: torch.Tensor, axis: Axis,
               to_next: bool = True) -> torch.Tensor:
    """The rows of the previous rank (``to_next``: rank s receives rank
    s-1's) or of the next one, zeros at the end of the axis that has no
    neighbour; differentiable (the gradient travels back)."""
    if axis.size == 1:
        return torch.zeros_like(rows)
    return _HaloShift.apply(rows, axis, to_next)


class _ReverseShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return _gather(t, axis)[axis.size - 1 - axis.rank].clone()

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        return _gather(g, axis)[axis.size - 1 - axis.rank].clone(), None


def reverse_shards(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Rank s takes rank n-1-s's ``t``; differentiable."""
    if axis.size == 1:
        return t
    return _ReverseShards.apply(t, axis)


def conv_halo(x: torch.Tensor, rows: int, axis: Axis,
              reverse: bool) -> torch.Tensor:
    """The ``rows`` rows (..., rows, d) that a shard's causal conv reads
    past its edge: the previous shard's last rows, or, ``reverse`` (the
    anti-causal conv), the next shard's first rows; zeros at the sequence
    edge. ``x`` (..., L_loc, d) is this shard."""
    L = x.shape[-2]
    edge = x[..., :rows, :] if reverse else x[..., L - rows:, :]
    return halo_shift(edge, axis, to_next=not reverse)


def flip_sharded(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's shard of the flip of a tensor whose ``dim`` is sharded
    over ``axis`` in rank order: the mirror rank's shard, flipped."""
    return reverse_shards(t, axis).flip(dim)
