"""No module the harness loads has the top-level name jax, jaxlib, flax
or caduceus_tpu, compared whole (the port, caduceus_tpu_torch, begins with
the JAX package's name)."""

import json
import os
import subprocess
import sys

from tiny import ROOT
from benchmark import harness

PROBE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/benchmark/tests")
import torch
from benchmark import harness, calibrate, trace, bounds, flops  # noqa
from tiny import tiny_cell, run
for name in ("v2_pretrain_131k", "v1_vep_131k"):
    run(tiny_cell(name))
    for m in harness.find_cell(name).per_layer:
        harness.metric_reader(m["name"])
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def test_top_level_names_compared_whole(monkeypatch):
    mods = ["caduceus_tpu_torch", "caduceus_tpu_torch.vep", "jaxtyping",
            "flaxen", "caduceus_tpu", "jax.numpy", "jaxlib"]
    monkeypatch.setattr(sys, "modules", {m: None for m in mods})
    found = harness.forbidden_loaded()
    monkeypatch.undo()
    assert found == ["caduceus_tpu", "jax.numpy", "jaxlib"]


def test_a_run_loads_no_jax():
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "-c", PROBE, ROOT],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert "caduceus_tpu_torch" in tops
    assert not set(tops) & {"jax", "jaxlib", "flax", "caduceus_tpu"}
