"""The numbers that decide `correct`, each read against its limit.

Training (pretraining and fine-tuning) reads these numbers with the
reference replaying the same first steps from the same weights and rows;
a cell compares those its ``limits`` name:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over the leaves, the largest gap between the norms of the
  program's and the reference's first gradient (clipped, as the optimizer
  received it; the program's is read back from AdamW's first moment), over
  the larger of the reference leaf's norm and the median leaf's;
- ``change_gap``: the same for the parameters' change over the steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone under Adam);
- ``grad_diff``: over the leaves, the largest norm of the difference of
  the two first gradients, over the same denominator as ``grad_gap``. The
  gap of norms cannot see a gradient that points elsewhere with the same
  length, as one row's gradient does in place of two rows' mean;
- ``grad_gap_median``, ``change_gap_median``, ``grad_diff_median``: the
  median leaf's reading in place of the worst leaf's.

VEP compares ``feature_gap``: the largest relative L2 gap of a variant's
features over a sample of the variants the window embedded.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

import torch

NEGLIGIBLE_GRAD = 1e-3


def leaf_norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in t.items()}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep=None) -> Tuple[float, str]:
    """max over leaves of |prog - ref| / max(ref, median ref); returns
    (value, leaf)."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    worst, which = 0.0, ""
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst or not which:
            worst, which = gap, k
    return worst, which


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The median over leaves of |prog - ref| / max(ref, median ref): steady
    from seed to seed where the worst leaf is a small one's noise."""
    med = statistics.median(ref.values())
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                             for k in ref)


def gradient_numbers(prog: Dict[str, torch.Tensor],
                     ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The first gradient's numbers: ``grad_gap`` and ``grad_diff`` with
    their median leaf's readings."""
    g_ref, g_prog = leaf_norms(ref), leaf_norms(prog)
    grad_gap, grad_leaf = worst_leaf_gap(g_prog, g_ref)
    diff = leaf_norms({k: prog[k].double() - ref[k].double() for k in ref})
    med = statistics.median(g_ref.values())
    rel = {k: diff[k] / max(g_ref[k], med, 1e-30) for k in ref}
    diff_leaf = max(rel, key=rel.get)
    return {"grad_gap": grad_gap,
            "grad_gap_median": median_leaf_gap(g_prog, g_ref),
            "grad_diff": rel[diff_leaf],
            "grad_diff_median": statistics.median(rel.values()),
            "_grad_leaf": grad_leaf, "_grad_diff_leaf": diff_leaf}


def training_numbers(prog: dict, ref: dict, w0: Dict[str, torch.Tensor]
                     ) -> Dict[str, float]:
    """``prog`` / ``ref``: {"losses": [...], "grad1": {leaf: tensor},
    "params": {leaf: tensor}} of the same steps from ``w0``."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    grads = gradient_numbers(prog["grad1"], ref["grad1"])
    g_ref = leaf_norms(ref["grad1"])
    med = statistics.median(g_ref.values())
    keep = {k for k, v in g_ref.items() if v >= NEGLIGIBLE_GRAD * med}
    d_ref = leaf_norms({k: ref["params"][k].double() - w0[k].double()
                        for k in keep})
    d_prog = leaf_norms({k: prog["params"][k].double() - w0[k].double()
                         for k in keep})
    change_gap, change_leaf = worst_leaf_gap(d_prog, d_ref)
    return {"loss_gap": loss_gap, **grads, "change_gap": change_gap,
            "change_gap_median": median_leaf_gap(d_prog, d_ref),
            "_change_leaf": change_leaf,
            "_leaves_left_out": sorted(set(g_ref) - keep)}


def feature_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest relative L2 gap over rows."""
    p, r = prog.double(), ref.double()
    return float(((p - r).norm(dim=-1) / r.norm(dim=-1).clamp(min=1e-30)
                  ).max())


def judge(numbers: Dict[str, float], limits: Dict[str, Optional[float]]
          ) -> Tuple[bool, List[Tuple[str, float, Optional[float]]]]:
    """(correct, [(name, value, limit)]) over the numbers that have a
    limit entry; a missing limit or a non-finite value is not correct."""
    rows = [(k, float(numbers[k]), limits.get(k)) for k in limits]
    ok = all(lim is not None and v == v and v <= lim for _, v, lim in rows)
    return ok, rows
