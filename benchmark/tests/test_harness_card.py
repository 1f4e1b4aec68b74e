"""On the card: one short run of each cell through `run.py` prints the
contract's last line with `correct` true. Skips without a GPU.

    python -m pytest benchmark/tests -m card
"""

import json
import os
import subprocess
import sys

import pytest

from tiny import ROOT

BM = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BM["workloads"]])
def test_cell_runs_on_the_card(cell, card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "3141592653", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
