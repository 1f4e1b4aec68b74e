"""The traced stretch: `torch.profiler` with CPU and CUDA activities over
a steady part of the window, exported as a Chrome trace and read back as
device intervals (kernels, copies, sets) and host intervals (operators,
runtime calls and the benchmark's own spans).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.traced_window"


@dataclass
class Trace:
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    t0: float = 0.0          # the traced window on the trace's clock, us
    t1: float = 0.0
    window_s: float = 0.0    # t1 - t0 in s

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged()) / 1e6

    def merged(self) -> List[Tuple[float, float]]:
        """Union of the device intervals inside the window, in us."""
        spans = sorted((max(s, self.t0), min(s + d, self.t1))
                       for _, s, d in self.device)
        out: List[Tuple[float, float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def gaps(self) -> List[Tuple[float, float]]:
        edges, prev = [], self.t0
        for a, b in self.merged():
            if a > prev:
                edges.append((prev, a))
            prev = b
        if self.t1 > prev:
            edges.append((prev, self.t1))
        return edges

    def host_at(self, a: float, b: float) -> str:
        """What the host was doing over [a, b): the host interval that
        covers most of it, the innermost one on a tie."""
        best, key = "idle host", (0.0, 0.0)
        for name, s, d in self.host:
            if name == WINDOW_SPAN:
                continue
            cover = min(b, s + d) - max(a, s)
            if cover > 0 and (cover, -d) > key:
                best, key = name, (cover, -d)
        return best

    def breakdown(self, n: int = 10) -> dict:
        by_name: dict = {}
        for name, _, d in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.host_at(a, b), (b - a) / 1e6]
                              for a, b in gaps]}


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tr = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            tr.device.append((name, ts, dur))
            if cat == "kernel":
                tr.kernels.append((name, ts, dur))
        elif cat in HOST_CATS:
            tr.host.append((name, ts, dur))
            if name == WINDOW_SPAN:
                tr.t0, tr.t1 = ts, ts + dur
    if tr.t1 <= tr.t0:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    tr.window_s = (tr.t1 - tr.t0) / 1e6
    return tr


def profile(fn: Callable[[], object], path: str):
    """Run ``fn`` under the profiler inside the span `WINDOW_SPAN`, ending
    in a synchronize; returns (fn's result, the Trace)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            out = fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    return out, load(path)
