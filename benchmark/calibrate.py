"""Readings that the comparison limits are set from (not part of a run).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out FILE]

In one process: for each of ``--seeds``, the program's first steps (or,
for VEP, a short window over ``reference_variants`` variants) against the
reference, the lower readings; for each of ``--control-seeds``, the
control (the reference in fp8) and, for training cells, the planted
half-batch fault (unless ``--no-faults``), each in the program's place
against the reference, the upper readings. One JSON line per reading.
``--first-step`` takes training cells through their first step alone, on
both sides, and reads only the first gradient's numbers.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    p.add_argument("--no-faults", action="store_true",
                   help="leave out the planted half-batch fault")
    p.add_argument("--first-step", action="store_true",
                   help="training: the first step alone, its gradient's "
                        "numbers")
    a = p.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.compare import (feature_gap, gradient_numbers,
                                   training_numbers)

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.find_cell(a.workload)
    cls = harness.entry_class(cell.traffic["entry"])
    sink = open(a.out, "a") if a.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    vep = cell.traffic["entry"] == "vep"

    def numbers(prog, ref, w0):
        if a.first_step:
            return gradient_numbers(prog["grad1"], ref["grad1"])
        return training_numbers(prog, ref, w0)
    for seed in seeds + [s for s in controls if s not in seeds]:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            e = cls(harness.Context(cell, seed, dev, tmp))
            if a.first_step and not vep:
                e.first_steps = 1
            e.setup()
            if vep:
                e._run(cell.settings["reference_variants"])
            e.release()
            ref = e.reference()
            if vep:
                nums = {"feature_gap": feature_gap(
                    torch.from_numpy(e.features[e.sample()]), ref)}
            else:
                nums = numbers(e.program_result(), ref, e.w0)
            emit({"cell": cell.name, "kind": "program", "seed": seed,
                  **nums, "s": time.perf_counter() - t0})
            if seed not in controls:
                continue
            ctl = e.reference(lowp=True)
            nums = ({"feature_gap": feature_gap(ctl, ref)} if vep
                    else numbers(ctl, ref, e.w0))
            emit({"cell": cell.name, "kind": "control", "seed": seed, **nums})
            if not vep and not a.no_faults:
                emit({"cell": cell.name, "kind": "fault_half_batch",
                      "seed": seed, **numbers(
                          e.reference(half=True), ref, e.w0)})
        harness.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
