"""Arithmetic shared by the per-layer readers.

``view`` is what the harness hands a reader: ``trace`` (`trace.Trace`),
``work`` (the traced stretch's counts), ``model`` (the configuration),
``shapes`` ({"G", "L"}: the rows, both strands, and the length of the
scan launches), ``own_kernels`` (the program's ``__global__``
names) and ``flops`` (the model FLOPs of the stretch).

A kernel's roofline share is the least time of its launches (launches
times the frozen bound of `bounds.py` at the cell's shapes) over their
device time, summed over the entries of the layer; every kernel that an
entry launches counts in its time, matched by name as the profiler prints
it.
"""

from __future__ import annotations

import re

from benchmark import bounds

# (bound key, the kernel launched once per call of the entry, the kernels
# the entry launches)
SSD_ENTRIES = (
    ("ssd_fused_fwd", "ssd_fwd_kernel",
     ("ssd_fwd_state_kernel", "ssd_fwd_kernel")),
    ("ssd_fused_bwd_kernel", "ssd_fused_bwd_kernel",
     ("ssd_bwd_state_kernel", "ssd_fused_bwd_kernel", "ssd_share_sum_kernel")),
    ("ssd_conv_bwd_kernel", "ssd_conv_bwd_kernel",
     ("ssd_conv_bwd_kernel", "ssd_conv_wsum_kernel")),
)
# the prologue both SSD entries launch (csrc/ssd_common.cuh)
SSD_SHARED = ("ssd_prep_kernel",)
SCAN_ENTRIES = (
    ("bidir_scan_fwd", "selective_scan_fwd_kernel",
     ("selective_scan_fwd_kernel",)),
    ("selective_scan_bwd", "selective_scan_bwd_kernel",
     ("selective_scan_bwd_kernel", "bc_share_sum_kernel")),
)
SCAN_CHUNK = 256          # rows per chunk of the scan kernels (`ops/scan.py`)
PEAK_FLOP_PER_S = bounds.BF16_FLOP_PER_S


def _pattern(name: str):
    return re.compile(r"(?<![A-Za-z0-9_])" + re.escape(name)
                      + r"(?![A-Za-z0-9_])")


def kernel_stats(trace, name: str):
    """(launches, device seconds) of the kernels called ``name``."""
    pat = _pattern(name)
    n, s = 0, 0.0
    for k, _, dur in trace.kernels:
        if pat.search(k):
            n += 1
            s += dur / 1e6
    return n, s


def roofline(trace, entries, shared, bound_of):
    least, spent = 0.0, 0.0
    for key, main, members in entries:
        launches, _ = kernel_stats(trace, main)
        if launches:
            least += launches * bound_of[key]["bound_ms"] / 1e3
        for k in members:
            spent += kernel_stats(trace, k)[1]
    if least == 0.0:
        return None
    for k in shared:
        spent += kernel_stats(trace, k)[1]
    return 100.0 * least / spent


def ssd_roofline(view):
    m, s = view["model"], view["model"]["ssm_cfg"]
    if s["version"] != 2:
        return None
    di = s.get("expand", 2) * m["d_model"]
    P = s["headdim"]
    b = bounds.ssd_bounds(view["shapes"]["G"], view["shapes"]["L"], di // P,
                          P, s["ngroups"], s["d_state"], s.get("d_conv", 4),
                          s["ssd_chunk_size"])
    return roofline(view["trace"], SSD_ENTRIES, SSD_SHARED, b)


def scan_roofline(view):
    m, s = view["model"], view["model"]["ssm_cfg"]
    if s["version"] != 1:
        return None
    di = s.get("expand", 2) * m["d_model"]
    b = bounds.scan_bounds(view["shapes"]["G"], view["shapes"]["L"], di,
                           s["d_state"], SCAN_CHUNK)
    return roofline(view["trace"], SCAN_ENTRIES, (), b)


def is_own(kernel: str, own: set) -> bool:
    """Whether the profiler's name of a kernel (demangled, with namespaces,
    template and parameter lists) names one of ``own``."""
    return any(_pattern(n).search(kernel) for n in own)


def torch_ops_ms(view):
    """Device ms per unit of work of every kernel that is not one of the
    program's own."""
    units = view["work"].get("steps") or view["work"].get("variants")
    if not units:
        return None
    own = view["own_kernels"]
    s = sum(d for k, _, d in view["trace"].kernels if not is_own(k, own))
    return s / 1e3 / units


def idle_pct(view):
    tr = view["trace"]
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu(view):
    tr = view["trace"]
    if tr.window_s <= 0 or not view["flops"]:
        return None
    return 100.0 * view["flops"] / (tr.window_s * PEAK_FLOP_PER_S)
