"""Device-idle time under the program's own spans.

The port opens a span (`caduceus_tpu_torch/utils/tracing.py`) at each host
phase of its entry points; under the profiler each is a host interval
named ``caduceus.<name>`` in the trace. A reader here intersects the
traced stretch's device-idle intervals (`trace.Trace.gaps`) with the union
of the intervals of some of those spans, and gives the time per unit of
work in ms: 0.0 where the spans cover no idle time, None where the trace
holds none of them (a program without the spans).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

PREFIX = "caduceus."
# the spans in which the entry points wait for their input
INPUT_SPANS = ("train.next_batch", "vep.read")


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_under(view, names: Optional[Tuple[str, ...]] = None):
    """Device-idle ms per unit of work under the spans ``caduceus.<name>``
    for ``name`` in ``names`` (every ``caduceus.*`` span where None)."""
    tr = view["trace"]
    spans = [(s, s + d) for n, s, d in tr.host if n.startswith(PREFIX)
             and (names is None or n[len(PREFIX):] in names)]
    units = view["work"].get("steps") or view["work"].get("variants")
    if not spans or not units:
        return None
    return overlap(tr.gaps(), union(spans)) / 1e3 / units
