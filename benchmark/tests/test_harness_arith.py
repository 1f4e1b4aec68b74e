"""The harness's arithmetic on hand-made inputs: the whole-window rate
with a stall inside the window, the idle share of a timeline with
overlapping kernels, and a roofline share against `chip_smoke.py`'s
bound."""

import time
import types

import pytest

from tiny import ROOT  # noqa: F401  (puts the checkout on the path)
from benchmark import bounds, flops
from benchmark.entries import pretrain
from benchmark.metrics import _lib
from benchmark.trace import Trace


class _StallingTrainer:
    """Two steps of 50 ms and one stall of 200 ms between them."""

    def __init__(self):
        self.state = types.SimpleNamespace(step=3)

    def fit(self, max_steps):
        while self.state.step < max_steps:
            time.sleep(0.05)
            if self.state.step == 3:
                time.sleep(0.2)
            self.state.step += 1


def test_window_rate_counts_the_stall():
    e = pretrain.Entry.__new__(pretrain.Entry)
    e.ctx = types.SimpleNamespace(sync=lambda: None)
    e.rows, e.L, e.step_s = 4, 1000, 0.05
    e.trainer = _StallingTrainer()
    e.final = {"loss": 1.0}
    e._log = lambda rec: None
    work = e._run(2)
    assert work["steps"] == 2 and work["tokens"] == 8000
    assert work["elapsed_s"] >= 0.3
    rate = e.end_to_end(work)["pretrain_tokens_per_s"]
    assert rate <= 8000 / 0.3
    assert rate == pytest.approx(8000 / work["elapsed_s"])


def _trace(kernels, t0=0.0, t1=100.0, host=()):
    tr = Trace(kernels=list(kernels), device=list(kernels), host=list(host),
               t0=t0, t1=t1)
    tr.window_s = (t1 - t0) / 1e6
    return tr


def test_idle_share_of_overlapping_kernels():
    # [10, 30) and [20, 40) overlap, [50, 60) alone, [95, 120) runs past
    # the window's end: busy 30 + 10 + 5 = 45 us of 100
    tr = _trace([("a", 10, 20), ("b", 20, 20), ("c", 50, 10),
                 ("d", 95, 25)],
                host=[("aten::copy_", 40, 10), ("bench.wait", 60, 35)])
    assert tr.busy_s() == pytest.approx(45e-6)
    assert _lib.idle_pct({"trace": tr}) == pytest.approx(55.0)
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps[0] == ["bench.wait", pytest.approx(35e-6)]
    assert ["aten::copy_", pytest.approx(10e-6)] in gaps
    assert ["idle host", pytest.approx(10e-6)] in gaps


def test_bounds_are_chip_smokes():
    import chip_smoke

    args = (4, 131072, 8, 64, 1, 128, 4, 128)
    assert bounds.ssd_bounds(*args) == chip_smoke._ssd_bounds(*args)
    args = (4, 131072, 512, 16, 256)
    assert bounds.scan_bounds(*args) == chip_smoke._scan_bounds(*args)


def test_roofline_share_of_one_shape():
    import chip_smoke

    model = {"d_model": 256, "ssm_cfg": {"version": 2, "expand": 2,
                                         "headdim": 64, "ngroups": 1,
                                         "d_state": 128, "d_conv": 4,
                                         "ssd_chunk_size": 128}}
    b = chip_smoke._ssd_bounds(4, 131072, 8, 64, 1, 128, 4, 128)
    # two forward calls of 10 ms each (state pass 2 ms + main pass 8 ms),
    # one adjoint of 20 ms, one conv adjoint of 1 ms, prep 1 ms
    # the names as the profiler prints them
    anon = "void (anonymous namespace)::"
    ks = [(anon + "ssd_fwd_state_kernel<__nv_bfloat16, 4>((anonymous "
           "namespace)::Params)", 0, 2e3),
          (anon + "ssd_fwd_kernel<__nv_bfloat16, 4>((anonymous "
           "namespace)::Params)", 0, 8e3)] * 2 + [
        (anon + "ssd_fused_bwd_kernel<__nv_bfloat16, 4>((anonymous "
         "namespace)::Params)", 0, 2e4),
        (anon + "ssd_conv_bwd_kernel<4>((anonymous namespace)::ConvParams)",
         0, 1e3),
        ("void ssd::ssd_prep_kernel<__nv_bfloat16, 4>(ssd::PrepParams)", 0,
         1e3),
        ("sm90_xmma_gemm_bf16bf16_bf16f32", 0, 5e4)]
    view = {"trace": _trace(ks), "model": model,
            "shapes": {"G": 4, "L": 131072}}
    want = 100 * (2 * b["ssd_fused_fwd"]["bound_ms"]
                  + b["ssd_fused_bwd_kernel"]["bound_ms"]
                  + b["ssd_conv_bwd_kernel"]["bound_ms"]) / 42.0
    assert _lib.ssd_roofline(view) == pytest.approx(want)
    assert _lib.scan_roofline(view) is None
    ops = _lib.torch_ops_ms({"trace": _trace(ks), "work": {"steps": 2},
                             "own_kernels": {"ssd_fwd_state_kernel",
                                             "ssd_fwd_kernel",
                                             "ssd_fused_bwd_kernel",
                                             "ssd_conv_bwd_kernel",
                                             "ssd_prep_kernel"}})
    assert ops == pytest.approx(25.0)


def test_mfu_counts_the_layer_equations():
    m = {"d_model": 256, "n_layer": 16, "ssm_cfg": {
        "version": 1, "expand": 2, "d_state": 16, "d_conv": 4,
        "dt_rank": "auto"}}
    per_token = flops.layer_flops_per_token(m)
    proj = 2 * 256 * 1024 + 2 * 512 * 256
    direction = 2 * 4 * 512 + 2 * 512 * 48 + 2 * 16 * 512 + 6 * 512 * 16 \
        + 2 * 512
    assert per_token == proj + 2 * direction
    fwd = flops.forward_flops(m, 2, 100, "mlm")
    assert fwd == 2 * 200 * 16 * per_token + 2 * 200 * 2 * 256 * 16
    assert flops.train_flops(m, 2, 100, "mlm") == 3 * fwd
    tr = _trace([("k", 0, 100)], t1=1e6)
    got = _lib.mfu({"trace": tr, "flops": 989e12 * 0.5})
    assert got == pytest.approx(50.0)
