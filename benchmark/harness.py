"""The general harness: finds a cell's configuration, traffic mix, cell
file, entry and metric readers by name, runs set-up, the window (or the
traced stretch) and the comparison, and prints the result.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric lives in a file of its own, found by the name that
`BENCHMARK.json` gives it:

- ``configs/<config>.json``: the model configuration as run (``model``);
- ``traffic/<mix>.json``: the entry that drives the window and its
  parameters (`generate.py` makes the data from them);
- ``workloads/<cell>.json``: the cell's comparison limits and sample sizes;
- ``entries/<entry>.py``: the code that drives one entry point of the
  program (set-up, window, traced stretch, the reference comparison);
- ``metrics/<name>.py``: the reader of every per-layer metric named
  ``<name>`` or ``<name>.<suffix>``; the suffix (one per kind of cell, as
  ``mfu.pretrain``) only selects the cells in `BENCHMARK.json`.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "caduceus_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_file(*parts: str) -> str:
    return os.path.join(BENCH_DIR, *parts)


@dataclass
class Cell:
    name: str
    spec: dict                  # the BENCHMARK.json workload entry
    config: dict                # configs/<config>.json
    traffic: dict               # traffic/<mix>.json
    settings: dict              # workloads/<cell>.json
    end_to_end: list
    per_layer: list

    @property
    def model_cfg(self) -> dict:
        return self.config["model"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, benchmark: Optional[dict] = None) -> Cell:
    bm = benchmark or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    specs = {w["name"]: w for w in bm["workloads"]}
    if name not in specs:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(specs)})")
    spec = specs[name]
    cfgs = {c["name"]: c for c in bm["configs"]}
    config = load_json(os.path.join(ROOT, cfgs[spec["config"]]["file"]))
    return Cell(
        name=name, spec=spec, config=config,
        traffic=load_json(bench_file("traffic", spec["traffic"] + ".json")),
        settings=load_json(bench_file("workloads", name + ".json")),
        end_to_end=[m for m in bm["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bm["per_layer"] if _applies(m, name)])


def entry_class(entry: str):
    return importlib.import_module(f"benchmark.entries.{entry}").Entry


def metric_reader(name: str):
    path = bench_file("metrics", name.split(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of `FORBIDDEN_MODULES`, compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def refuse_forbidden() -> None:
    found = forbidden_loaded()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found}")


def own_kernel_names() -> set:
    """The names of the program's own CUDA kernels: every ``__global__``
    function in ``caduceus_tpu_torch/csrc``."""
    import re

    names = set()
    src = os.path.join(ROOT, "caduceus_tpu_torch", "csrc")
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)"
                     r"\s*)?(?:void\s+)?(\w+)\s*\(")
    for f in sorted(os.listdir(src)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(src, f)) as fh:
                names.update(pat.findall(fh.read()))
    names.discard("void")
    return names


@dataclass
class Context:
    """What an entry gets: the cell, the seed, the device and a scratch
    directory under TMPDIR."""
    cell: Cell
    seed: int
    device: torch.device
    tmp: str

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def release(*objs) -> None:
    del objs
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def first_moment(opt, p) -> torch.Tensor:
    """AdamW's first moment of ``p`` in the program's optimizer ``opt``
    (zeros where its step kept none)."""
    m = opt.state.get(p, {}).get("exp_avg")
    return torch.zeros_like(p) if m is None else m.detach()


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, out=print,
             err=None) -> dict:
    """One run of ``cell``; prints the earlier lines and returns the result
    dict (the caller prints it as the last line)."""
    err = err or (lambda s: print(s, file=sys.stderr))
    with tempfile.TemporaryDirectory(prefix="caduceus_bench_") as tmp:
        ctx = Context(cell, int(seed), device, tmp)
        entry = entry_class(cell.traffic["entry"])(ctx)
        parts = entry.setup()
        ctx.sync()
        setup_s = time.perf_counter() - t_start
        out(json.dumps({"setup": {**parts, "setup_s": setup_s}}))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        if traced:
            from benchmark import trace as trace_mod

            work, tr = trace_mod.profile(entry.traced,
                                         os.path.join(tmp, "trace.json"))
        else:
            work = entry.window(seconds)
            tr = None
        work = entry.finish(work)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        refuse_forbidden()
        out(json.dumps({"card": device_info(device)["kind"],
                        "power_limit": power_limit() or None}))
        out(json.dumps({"window": work}))
        if traced:
            metrics = per_layer_metrics(cell, entry, work, tr)
            out(json.dumps({"own_kernels": own_kernel_stats(tr)}))
        else:
            values = entry.end_to_end(work)
            values["setup_s"] = setup_s
            values["peak_mem_gib"] = peak / 2 ** 30
            metrics = {}
            for m in cell.end_to_end:
                if m["name"] not in values:
                    raise KeyError(f"{cell.name} does not produce "
                                   f"{m['name']}")
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        entry.release()
        t_ref = time.perf_counter()
        numbers = entry.check()
        out(json.dumps({"compared": {k: v for k, v in numbers.items()
                                     if k.startswith("_")},
                        "reference_s": time.perf_counter() - t_ref}))
        from benchmark.compare import judge

        correct, rows = judge(numbers, cell.settings["limits"])
        refuse_forbidden()
        dev = {**device_info(device), "memory_peak_bytes": int(peak)}
        result = {"correct": correct, "attempted": work["attempted"],
                  "failed": work["failed"], "metrics": metrics,
                  "device": dev}
        if tr is not None:
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s
            result["breakdown"] = tr.breakdown()
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, v, lim in rows}
        for k, v, lim in rows:
            err(f"check {k} {v!r} limit {lim!r}")
        return result


def own_kernel_stats(tr) -> dict:
    """{kernel: [launches, device seconds]} of the program's own kernels in
    the traced stretch."""
    from benchmark.metrics._lib import kernel_stats

    stats = {k: list(kernel_stats(tr, k)) for k in sorted(own_kernel_names())}
    return {k: v for k, v in stats.items() if v[0]}


def per_layer_metrics(cell: Cell, entry, work: dict, tr) -> dict:
    """Each per-layer metric's reader over the traced stretch; a reader
    that finds nothing returns None and the metric is left out."""
    view = {"trace": tr, "work": work, "model": cell.model_cfg,
            "shapes": entry.shapes(), "own_kernels": own_kernel_names(),
            "flops": entry.flops(work)}
    out = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"])(view)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
