"""Run one cell of the port's benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout on an NVIDIA GPU; exits non-zero without
a result when there is no card. The last line of standard output is the
result (JSON); the numbers compared with the reference, each with its
limit, are the last lines of standard error and the result's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
# every cache the program or its libraries keep goes to a fixed directory
# inside the checkout, so that only a cell's first run there compiles
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(BUILD, sub)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    from benchmark import harness

    cell = harness.find_cell(a.workload)
    if torch.cuda.device_count() < cell.spec["chips"]:
        print(f"{a.workload} needs {cell.spec['chips']} cards",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                              torch.device("cuda", 0), T_START)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
