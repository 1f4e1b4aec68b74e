"""Logging: JSON lines on stdout and in the run dir.

The port's counterpart of `caduceus_tpu/utils/logging.py` (`make_logger`,
`param_count`; parity with the reference's rank-zero logger, `train.py:74-123`,
and its `ParamsLog` callback, `src/callbacks/params.py`). The optional
Weights & Biases sink is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import torch.nn as nn


def param_count(model: nn.Module) -> Dict[str, int]:
    """Total parameter count (`src/callbacks/params.py:27-39`)."""
    return {"params_total": int(sum(p.numel() for p in model.parameters()))}


def make_logger(run_dir: Optional[str] = None,
                rank: int = 0) -> Callable[[Dict], None]:
    """``log_fn(metrics)``: one JSON line on stdout and, with ``run_dir``,
    appended to ``<run_dir>/metrics.jsonl``. Ranks other than 0 get a
    no-op (the reference's DummyExperiment, `train.py:43-72`)."""
    if rank != 0:
        return lambda m: None
    path = None
    if run_dir:
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, "metrics.jsonl")

    def log(m: Dict) -> None:
        line = json.dumps(m)
        print(line, flush=True)
        if path is not None:
            with open(path, "a") as f:
                f.write(line + "\n")

    return log
