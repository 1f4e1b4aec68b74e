"""How a kernel's output is held against its plain version's.

One rule, used by `chip_smoke.py` and `tests/test_torch_cuda.py` for the
forward's outputs and the backward's gradients alike: the kernel's output
``k`` passes against the plain output ``p`` when

    ||k - p|| / ||p|| <= rel_l2                         (over all elements)
    |k - p| <= rtol * |p| + atol * mean|p|              (every element)

The elementwise limit scales with each value, plus a floor set by the
typical value (mean|p|), not by the largest: the outputs are heavy-tailed,
and a limit set by the largest value would let a wrong tile of typical
values pass.

``rows=True`` takes that typical value per row where the row's is the
larger: the floor of an element is atol times the larger of mean|p| over
its row (the last dimension) and over the whole tensor. For attention,
whose rows differ in size by the number of keys each averages (at L =
65,536 a causal row's output shrinks as 1/sqrt(its keys)): one mean over
all rows is set by the long rows and would hold the short ones, whose
rounding moves them by their own size, to a floor 30x smaller than that;
a row whose value cancels to ~0 (dq of the first causal row) keeps the
tensor's floor.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Tol:
    rel_l2: float
    rtol: float
    atol: float     # in units of mean|plain|


TOL = {
    # the two sides differ only in summation order; the decays exp(cum)
    # carry the rounding of cumsums that reach tens within a chunk
    torch.float32: Tol(rel_l2=1e-4, rtol=1e-4, atol=1e-4),
    # outputs and matmul operands (M, dt·x, the state for C@h) are rounded
    # to bf16, steps of 2^-7 relative. Where the two sides' fp32 values
    # straddle a rounding boundary, an output differs by a step (rtol), or
    # an operand does and shifts one term of a sum by a step of that term,
    # which the output's own size does not bound (atol). A 16x16 tile off
    # by 2^-4 or zeroed fails by a factor of 10 or more.
    torch.bfloat16: Tol(rel_l2=5e-3, rtol=2 ** -6, atol=2 ** -4),
}
# The backward's parameter gradients (g_A, g_D, g_dt_bias, g_conv_w/b) are
# sums over G·L rows taken in another order than the plain version's; that
# order moves them by a few fp32 roundings, well inside both limits. (The
# SSD kernels take every sum in a fixed order, so their outputs repeat bit
# for bit; the v1 scan adjoint's g_B / g_C are fp32 atomics: PERF.md.)

_CHUNK = 1 << 26   # elements per pass: bounds the fp32 temporaries


def compare(kernel: torch.Tensor, plain: torch.Tensor, tol: Tol,
            rows: bool = False) -> dict:
    """Errors of ``kernel`` against ``plain`` and whether they pass ``tol``.

    ``atol_needed`` is the smallest ``atol`` (in units of mean|plain|, per
    row with ``rows``) the elementwise limit would need at this ``rtol``."""
    if kernel.shape != plain.shape:
        raise ValueError(f"shapes {tuple(kernel.shape)} != {tuple(plain.shape)}")
    width = plain.shape[-1] if rows and plain.dim() else 1
    k, p = kernel.reshape(-1), plain.reshape(-1)
    step = _CHUNK - _CHUNK % width
    n = max(k.numel(), 1)
    floor = (sum(p[i:i + step].float().abs().double().sum().item()
                 for i in range(0, k.numel(), step)) / n if rows else 0.0)
    sq_d = sq_p = sum_p = 0.0
    max_d = max_p = 0.0
    excess = -math.inf
    for i in range(0, k.numel(), step):
        pc = p[i:i + step].float()
        d = (k[i:i + step].float() - pc).abs()
        pa = pc.abs()
        sq_d += d.double().square().sum().item()
        sq_p += pa.double().square().sum().item()
        sum_p += pa.double().sum().item()
        max_d = max(max_d, d.max().item())
        max_p = max(max_p, pa.max().item())
        over = d - tol.rtol * pa
        if rows:
            unit = pa.reshape(-1, width).mean(-1, keepdim=True)
            over = over.reshape(-1, width) / unit.clamp(min=max(floor,
                                                                1e-30))
        excess = max(excess, over.max().item())
    mean_p = sum_p / n
    rel_l2 = math.sqrt(sq_d) / max(math.sqrt(sq_p), 1e-30)
    atol_needed = max(excess, 0.0) / (1.0 if rows else max(mean_p, 1e-30))
    return {"max_abs_err": max_d, "max_abs_ref": max_p,
            "mean_abs_ref": mean_p, "rel_l2": rel_l2,
            "atol_needed": atol_needed,
            "ok": bool(rel_l2 <= tol.rel_l2 and atol_needed <= tol.atol)}


def describe(stats: dict) -> str:
    return (f"rel_l2 {stats['rel_l2']:.2e}, max err {stats['max_abs_err']:.3e}"
            f" (mean|ref| {stats['mean_abs_ref']:.3e}, max|ref| "
            f"{stats['max_abs_ref']:.3e}), atol needed "
            f"{stats['atol_needed']:.2e} x mean|ref|")
