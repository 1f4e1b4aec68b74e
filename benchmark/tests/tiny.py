"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: the same
entries, generator and reference at d_model 16, 2 layers, short rows."""

import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

# Entries with no cell in BENCHMARK.json, held against the reference here:
# fine-tuning's random labels leave its first gradient all but cancelled on
# some seeds, where no compared number parts sound runs from the control.
HELD = {"v2_finetune_gb": (
    {"name": "v2_finetune_gb", "config": "caduceus_v2",
     "traffic": "gb_nontata_promoters", "chips": 1},
    {"reference_steps": 3, "trace_steps": 10,
     "limits": dict.fromkeys(("grad_gap", "grad_diff_median", "change_gap",
                              "change_gap_median"))})}


def held_cell(name: str) -> harness.Cell:
    spec, settings = HELD[name]
    bm = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = {c["name"]: c for c in bm["configs"]}[spec["config"]]
    return harness.Cell(
        name=name, spec=spec,
        config=harness.load_json(os.path.join(ROOT, cfg["file"])),
        traffic=harness.load_json(
            harness.bench_file("traffic", spec["traffic"] + ".json")),
        settings=json.loads(json.dumps(settings)),
        end_to_end=[m for m in bm["end_to_end"] if "workloads" not in m],
        per_layer=[])


def tiny_cell(name: str, dtype: str = "float32", L: int = 64,
              config: str = None):
    """``name`` cut to a tiny size; ``config`` runs its traffic on another
    configuration of `configs/`."""
    cell = held_cell(name) if name in HELD else harness.find_cell(name)
    if config:
        cell.config = harness.load_json(
            harness.bench_file("configs", config + ".json"))
    m = cell.config["model"]
    m.update(d_model=16, n_layer=2, dtype=dtype)
    s = m["ssm_cfg"]
    if s["version"] == 2:
        s.update(d_state=8, headdim=8, ssd_chunk_size=16, ssd_seg_chunks=2)
    else:
        s.update(d_state=4)
    t = cell.traffic
    t["seq_len"] = L
    if t["entry"] == "vep":
        t.update(contig_len=4096, max_variants=40)
    if t["entry"] == "finetune":
        t["batch"] = 8
    return cell


def run(cell, seed: int = 2 ** 33 + 5, seconds: float = 1.0):
    lines = []
    result = harness.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                              time.perf_counter(), out=lines.append,
                              err=lines.append)
    return result, lines
