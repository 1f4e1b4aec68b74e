"""The harness finds every configuration, traffic mix, cell, entry and
per-layer metric of BENCHMARK.json by name, and the file keeps to the
benchmark's contract's shape."""

import json
import os
import re

import pytest

from tiny import ROOT
from benchmark import harness

BM = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BM["workloads"]])
def test_cell_resolves(cell):
    c = harness.find_cell(cell)
    assert c.spec["chips"] == 1
    assert harness.entry_class(c.traffic["entry"]) is not None
    assert set(c.settings["limits"])
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in names


def test_names_units_and_keys():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    seen = set()
    for group in ("end_to_end", "per_layer"):
        for m in BM[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["name"] not in seen
            seen.add(m["name"])
            assert m["better"] in ("lower", "higher")
    for m in BM["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    pairs = {(w["config"], w["traffic"]) for w in BM["workloads"]}
    assert len(pairs) == len(BM["workloads"])
    for w in BM["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200


def test_roofline_names_follow_the_kernel_rule():
    for m in BM["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"


def test_own_kernel_names_come_from_the_program():
    own = harness.own_kernel_names()
    for k in ("ssd_fwd_kernel", "ssd_fused_bwd_kernel", "ssd_conv_bwd_kernel",
              "selective_scan_fwd_kernel", "selective_scan_bwd_kernel",
              "bc_share_sum_kernel", "ssd_prep_kernel"):
        assert k in own
