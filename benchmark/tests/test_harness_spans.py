"""The readers of the program's spans, `input_wait_ms` and `host_wait_ms`,
on hand-made traces: a gap half inside a span, two overlapping spans, a
span outside the window, other host intervals beside them, and traces
without a `caduceus.*` span (a program that opens none), which the
readers, and the harness after them, leave out."""

import types

import pytest

from tiny import ROOT  # noqa: F401  (puts the checkout on the path)
from benchmark import harness
from benchmark.trace import WINDOW_SPAN, Trace

# one window of 1,000 us; the device busy over [100, 300) and [500, 800)
# (two kernels overlapping in the second), so the gaps are [0, 100),
# [300, 500) and [800, 1000)
DEVICE = [("k1", 100.0, 200.0), ("k2", 500.0, 200.0), ("k3", 600.0, 200.0)]
TRAIN = [
    (WINDOW_SPAN, 0.0, 1000.0),
    ("aten::item", 0.0, 100.0),                      # not the program's
    ("caduceus.train.next_batch", 400.0, 200.0),     # half of [300, 500)
    ("caduceus.train.step", 250.0, 200.0),           # overlaps the one above
    ("caduceus.train.optimizer", 850.0, 50.0),
    ("caduceus.train.log", 1100.0, 50.0),            # after the window
]
VEP = [
    (WINDOW_SPAN, 0.0, 1000.0),
    ("caduceus.vep.build", -50.0, 100.0),            # starts before it
    ("caduceus.vep.read", 300.0, 50.0),
    ("caduceus.vep.read", 330.0, 40.0),              # overlaps the one above
    ("caduceus.vep.forward", 450.0, 100.0),
    ("caduceus.vep.readout", 790.0, 20.0),
]


def _view(host, **work):
    tr = Trace(kernels=list(DEVICE), device=list(DEVICE), host=list(host),
               t0=0.0, t1=1000.0, window_s=1e-3)
    return {"trace": tr, "work": work}


def _read(name, view):
    return harness.metric_reader(name)(view)


def test_pretrain_spans():
    view = _view(TRAIN, steps=2)
    assert view["trace"].gaps() == [(0.0, 100.0), (300.0, 500.0),
                                    (800.0, 1000.0)]
    # next_batch covers [400, 500) of the idle time: 100 us over 2 steps
    assert _read("input_wait_ms.pretrain", view) == pytest.approx(0.05,
                                                                  abs=1e-12)
    # the union [250, 600) covers [300, 500), the optimizer [850, 900):
    # 250 us; the log after the window and aten::item add nothing
    assert _read("host_wait_ms.pretrain", view) == pytest.approx(0.125,
                                                                 abs=1e-12)


def test_vep_spans():
    view = _view(VEP, variants=4)
    # the reads' union [300, 370): 70 us over 4 variants
    assert _read("input_wait_ms.vep", view) == pytest.approx(0.0175,
                                                             abs=1e-12)
    # build [0, 50) + reads and forward [300, 370) and [450, 500) +
    # readout [800, 810): 180 us
    assert _read("host_wait_ms.vep", view) == pytest.approx(0.045, abs=1e-12)


def test_spans_that_cover_no_idle_time_read_zero():
    view = _view([(WINDOW_SPAN, 0.0, 1000.0),
                  ("caduceus.train.next_batch", 120.0, 100.0),
                  ("caduceus.train.step", 520.0, 200.0)], steps=1)
    assert _read("input_wait_ms.pretrain", view) == 0.0
    assert _read("host_wait_ms.pretrain", view) == 0.0


def test_no_program_span_reads_none():
    host = [(WINDOW_SPAN, 0.0, 1000.0), ("aten::item", 0.0, 100.0),
            ("cudaMemcpyAsync", 300.0, 150.0)]
    for name in ("input_wait_ms.pretrain", "host_wait_ms.pretrain"):
        assert _read(name, _view(host, steps=2)) is None
    # the input reader reads only the input spans
    only_step = host + [("caduceus.train.step", 300.0, 100.0)]
    assert _read("input_wait_ms.pretrain", _view(only_step, steps=2)) is None
    assert _read("host_wait_ms.pretrain", _view(only_step, steps=2)) == \
        pytest.approx(0.05, abs=1e-12)


@pytest.mark.parametrize("cell", ["v2_pretrain_131k", "v1_vep_131k"])
def test_harness_leaves_out_what_a_program_without_spans_lacks(cell):
    """A traced run of a program that opens no span (the parent of the
    spans) reports the cell's other per-layer metrics and leaves the span
    readers' out, without raising."""
    c = harness.find_cell(cell)
    entry = types.SimpleNamespace(shapes=lambda: {"G": 4, "L": 1024},
                                  flops=lambda work: 1e12)
    work = {"steps": 2} if "pretrain" in cell else {"variants": 4}
    tr = _view([(WINDOW_SPAN, 0.0, 1000.0)])["trace"]
    got = harness.per_layer_metrics(c, entry, work, tr)
    suffix = cell.split("_")[1]
    assert f"idle_pct.{suffix}" in got
    assert not any(k.startswith(("input_wait_ms", "host_wait_ms"))
                   for k in got)
    tr.host += [("caduceus.x", 300.0, 200.0)]
    got = harness.per_layer_metrics(c, entry, work, tr)
    assert f"host_wait_ms.{suffix}" in got
