"""Spans at the boundaries of the port's entry points.

``span(name)`` is `torch.profiler.record_function` under the name
``caduceus.<name>``: when a `torch.profiler` records (``cli.py pretrain
--profile-dir``, the benchmark's traced runs, an operator's own profiler),
the span lands in its trace as a ``user_annotation`` on the profiler's
clock, beside the kernels; when none records, it costs what
``record_function`` costs. With ``totals``, a dict the caller owns, it also
adds the span's host seconds (`time.perf_counter`) under ``name``.

A span never synchronizes the device and never allocates on it. Enter it
on the thread that runs the entry point: the profiler does not record
spans opened on a Python thread that did not start it (the prefetch
worker's, say). Spans belong at the boundaries of an entry point's phases,
never per model layer or kernel launch.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch

PREFIX = "caduceus."


@contextlib.contextmanager
def span(name: str, totals: Optional[Dict[str, float]] = None
         ) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(PREFIX + name):
            yield
    finally:
        if totals is not None:
            totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
