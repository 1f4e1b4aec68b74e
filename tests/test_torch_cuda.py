"""The port's CUDA kernels on the card: `ssd_fused_fwd` (with its carries),
the unfused `ssd_fwd` and `ssd_fused_bwd` (its SiLU + conv adjoint
`ssd_conv_bwd` also alone), and the selective scan's
`selective_scan_fwd`, `bidir_scan_fwd` and `selective_scan_bwd`, against
their plain versions; the autograd Functions against finite differences; a
v1 model backward through the scan kernels; the prefill of both causal
families, card against CPU; the context-parallel entry of the fused
kernels (`ssd_batched_fused_cp`: edge_hist in, g_edge out) against its
plain version, against the unsplit kernel and across two runs; the
kernels at one rank's shapes under tensor parallelism (the tensor-parallel
model itself is held on the card by chip_smoke.py [tp_train] and [cp_tp],
whose ranks are processes); and the wrappers' refusals. Imports no JAX, so
it runs on the machine with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test needs a CUDA card and skips without one (the kernels have no CPU
mode; their arithmetic is held against JAX through the plain versions in
tests/test_torch_ssd.py and tests/test_torch_scan.py). The rule and its
tolerances are those of chip_smoke.py, in
`caduceus_tpu_torch/kernel_check.py`.
"""

import pytest
import torch

from caduceus_tpu_torch.kernel_check import TOL, compare
from caduceus_tpu_torch.ops import ssd_batched
from caduceus_tpu_torch.ops.ssd import ssd_chunked_fused, ssd_chunked_fused_bwd

GRAD_NAMES = ("g_xBC", "g_dt", "g_A", "g_conv_w", "g_conv_b", "g_D",
              "g_dt_bias", "g_h0")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dtype, G=2, L=150, H=4, P=32, NG=2, N=32, K=4, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=g, device="cuda") * sc
    Wc = H * P + 2 * NG * N
    args = (rnd(G, L, Wc).to(dtype), (rnd(G, L, H) * 0.5).to(dtype),
            -torch.exp(rnd(H, sc=0.5)), rnd(K, Wc, sc=0.5))
    kw = dict(conv_b=rnd(Wc, sc=0.1), D=rnd(H), dt_bias=rnd(H, sc=0.1),
              dims=(H, P, NG, N), dt_softplus=True, h_init=rnd(G, H, N, P),
              return_final_state=True)
    cot = (rnd(G, L, H, P).to(dtype), rnd(G, H, N, P))
    return args, kw, cot


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_matches_plain(card, dtype, reverse):
    args, kw, _ = _inputs(dtype)
    T = ssd_batched.KERNEL_CHUNK[dtype]
    before = ssd_batched.launches
    y, h = ssd_batched.ssd_batched_fused(*args, reverse=reverse, **kw)
    torch.cuda.synchronize()
    assert ssd_batched.launches == before + 1
    kw.pop("return_final_state")
    y_p, h_p, car_p = ssd_chunked_fused(*args, reverse=reverse, chunk_size=T,
                                        return_carries=True, **kw)
    _, _, car = ssd_batched.ssd_fused_fwd(
        *args, kw["conv_b"], kw["D"], kw["dt_bias"], kw["dims"], True,
        reverse, T, kw["h_init"], save_carries=True)
    assert y.dtype == dtype and h.dtype == torch.float32
    assert car.dtype == car_p.dtype and car.shape == car_p.shape
    for k, p in ((y, y_p), (h, h_p), (car, car_p)):
        stats = compare(k, p, TOL[dtype])
        assert stats["ok"], stats


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse,NG", [(False, 2), (True, 2), (True, 1)])
def test_bwd_kernel_matches_plain(card, dtype, reverse, NG):
    args, kw, (gy, ghN) = _inputs(dtype, NG=NG, seed=3)
    T = ssd_batched.KERNEL_CHUNK[dtype]
    kw.pop("return_final_state")
    h0 = kw.pop("h_init")
    dims = kw.pop("dims")
    ps = (kw["conv_b"], kw["D"], kw["dt_bias"])
    _, _, car = ssd_batched.ssd_fused_fwd(*args, *ps, dims, True, reverse, T,
                                          h0, save_carries=True)
    n0, c0 = ssd_batched.bwd_launches, ssd_batched.conv_bwd_launches
    got = ssd_batched.ssd_fused_bwd(*args, *ps, gy, car, ghN, dims, True,
                                    reverse, T)
    torch.cuda.synchronize()
    assert (ssd_batched.bwd_launches, ssd_batched.conv_bwd_launches) == (
        n0 + 1, c0 + 1)
    want = ssd_chunked_fused_bwd(*args, *ps, gy, car, ghN, dims, True,
                                 reverse, T)
    for name, k, p in zip(GRAD_NAMES, got, want):
        assert k.shape == p.shape and k.dtype == p.dtype, name
        stats = compare(k, p, TOL[dtype])
        assert stats["ok"], (name, stats)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_conv_bwd_kernel_matches_plain(card, dtype, reverse):
    """The SiLU + conv adjoint `ssd_conv_bwd` (1,024-row tiles, 128-column
    tiles of 4 columns a lane) against `ops/ssd.py conv_silu_bwd`: K 1-4, L
    200, 1000 and 4099 (one ragged tile; four and a ragged fifth), Wc 388
    contiguous (vector copies) or a column view at an odd offset (scalar
    raw rows), and Wc 203 (not a multiple of 4 or 8: scalar throughout)."""
    from caduceus_tpu_torch.ops.ssd import conv_silu_bwd as plain

    g = torch.Generator(device="cuda").manual_seed(11 + reverse)
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=g, device="cuda") * sc
    for K in (1, 2, 3, 4):
        for L in (200, 1000, 4099):
            for Wc, pad in ((388, None), (388, 3), (203, 5)):
                wide = rnd(2, L, (pad or 0) + Wc + 3).to(dtype)
                xBC = (wide[..., :Wc].contiguous() if pad is None
                       else wide[..., pad:pad + Wc])
                g_xc, w, b = rnd(2, L, Wc), rnd(K, Wc, sc=0.5), rnd(Wc, sc=0.1)
                n0 = ssd_batched.conv_bwd_launches
                got = ssd_batched.conv_silu_bwd(g_xc, xBC, w, b, reverse)
                torch.cuda.synchronize()
                assert ssd_batched.conv_bwd_launches == n0 + 1
                want = plain(g_xc, xBC, w, b, reverse)
                for name, k, p in zip(("g_xBC", "g_conv_w", "g_conv_b"), got,
                                      want):
                    assert k.shape == p.shape and k.dtype == p.dtype, name
                    stats = compare(k, p, TOL[dtype])
                    assert stats["ok"], (K, L, Wc, pad, name, stats)


@pytest.mark.cuda
def test_function_matches_finite_differences(card):
    """d/de of loss(inputs + e·v) at e = 0, by central differences in fp32,
    against Σ grad·v from the backward kernel: every differentiable input
    at once, along one seeded direction each."""
    args, kw, (gy, ghN) = _inputs(torch.float32, G=1, L=70, H=2, P=16,
                                  NG=1, N=16, seed=5)
    kw.pop("return_final_state")
    inputs = list(args) + [kw.pop("conv_b"), kw.pop("D"), kw.pop("dt_bias"),
                           kw.pop("h_init")]
    gen = torch.Generator(device="cuda").manual_seed(6)
    dirs = [torch.randn(t.shape, generator=gen, device="cuda") for t in inputs]

    def loss(ts):
        y, h = ssd_batched.ssd_batched_fused(
            ts[0], ts[1], ts[2], ts[3], conv_b=ts[4], D=ts[5], dt_bias=ts[6],
            h_init=ts[7], return_final_state=True, **kw)
        return (y.double() * gy).sum() + (h.double() * ghN).sum()

    leaves = [t.clone().requires_grad_() for t in inputs]
    loss(leaves).backward()
    analytic = sum((t.grad.double() * v).sum() for t, v in zip(leaves, dirs))
    eps = 5e-3
    with torch.no_grad():
        fd = (loss([t + eps * v for t, v in zip(inputs, dirs)])
              - loss([t - eps * v for t, v in zip(inputs, dirs)])) / (2 * eps)
    assert abs(fd - analytic) <= 5e-3 * abs(analytic), (fd.item(),
                                                       analytic.item())


@pytest.mark.cuda
def test_gradients_flow_through_both_kernels(card):
    args, kw, (gy, ghN) = _inputs(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in args]
    counts = (ssd_batched.launches, ssd_batched.bwd_launches,
              ssd_batched.conv_bwd_launches)
    y, h = ssd_batched.ssd_batched_fused(*leaves, **kw)
    ((y.float() * gy).sum() + (h * ghN).sum()).backward()
    torch.cuda.synchronize()
    assert (ssd_batched.launches, ssd_batched.bwd_launches,
            ssd_batched.conv_bwd_launches) == tuple(c + 1 for c in counts)
    for t in leaves:
        assert t.grad is not None and t.grad.shape == t.shape
        assert bool(torch.isfinite(t.grad).all())


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    args, kw, _ = _inputs(torch.float32)
    with pytest.raises(ValueError, match="chunks"):
        ssd_batched.ssd_batched_fused(*args, chunk_size=64, **kw)
    with pytest.raises(TypeError):
        ssd_batched.ssd_batched_fused(args[0].half(), *args[1:], **kw)
    with pytest.raises(TypeError):
        ssd_batched.ssd_batched_fused(args[0], args[1].bfloat16(), *args[2:],
                                      **kw)
    with pytest.raises(ValueError):
        ssd_batched.ssd_batched_fused(*args, **{**kw, "dims": (4, 24, 2, 32),
                                                "h_init": None})


# --- the Mamba-1 selective scan: selective_scan_fwd / bidir_scan_fwd (TPU
# kernels #7, #9) and selective_scan_bwd (#8), against ops/selective_scan.py

SCAN_GRADS = ("g_u", "g_delta", "g_A", "g_B", "g_C", "g_D", "g_bias", "g_h0")


def _scan_inputs(dtype, G=2, L=150, d=40, N=16, seed=0, bias=True):
    """u, delta, A, B, C, D, bias on the card, with h_init and the
    cotangents; B and C are column slices of one (G, L, R + 2N) tensor, as
    the x_proj output gives them. d = 40 leaves a partial channel tile and
    L = 150 a partial chunk."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=g, device="cuda") * sc
    dbc = rnd(G, L, 8 + 2 * N).to(dtype)
    args = [rnd(G, L, d).to(dtype), (rnd(G, L, d) * 0.5).to(dtype),
            -torch.exp(rnd(d, N, sc=0.5)), dbc[..., 8:8 + N],
            dbc[..., 8 + N:], rnd(d), rnd(d, sc=0.1) if bias else None]
    return args, rnd(G, d, N), rnd(G, L, d).to(dtype), rnd(G, d, N)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse,N", [(False, 16), (True, 16), (True, 8)])
def test_scan_fwd_kernel_matches_plain(card, dtype, reverse, N):
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan

    args, h0, _, _ = _scan_inputs(dtype, N=N, seed=10)
    before = scan.fwd_launches
    got = scan.selective_scan_fwd(*args, True, reverse, scan.KERNEL_CHUNK, h0,
                                  save_carries=True)
    torch.cuda.synchronize()
    assert scan.fwd_launches == before + 1
    want = selective_scan(*args, True, reverse, scan.KERNEL_CHUNK, h0, True,
                          True)
    for name, k, p in zip(("y", "hN", "carries"), got, want):
        assert k.shape == p.shape and k.dtype == p.dtype, name
        stats = compare(k, p, TOL[dtype])
        assert stats["ok"], (name, stats)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bidir_kernel_matches_plain(card, dtype):
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan

    f, _, _, _ = _scan_inputs(dtype, seed=11)
    r, _, _, _ = _scan_inputs(dtype, seed=12, bias=False)
    before = scan.bidir_launches
    yf, yr, cf, cr = scan.bidir_scan_fwd(*f[:2], *f[3:5], *r[:2], *r[3:5],
                                         f[2], r[2], f[5], None, f[6], r[6],
                                         save_carries=True)
    torch.cuda.synchronize()
    assert scan.bidir_launches == before + 1
    T = scan.KERNEL_CHUNK
    pf = selective_scan(*f, True, False, T, return_carries=True)
    pr = selective_scan(*r[:5], None, r[6], True, True, T,
                        return_carries=True)
    for name, k, p in (("yf", yf, pf[0]), ("carf", cf, pf[1]),
                       ("yr", yr, pr[0]), ("carr", cr, pr[1])):
        stats = compare(k, p, TOL[dtype])
        assert stats["ok"], (name, stats)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse,N", [(False, 16), (True, 16), (False, 8)])
def test_scan_bwd_kernel_matches_plain(card, dtype, reverse, N):
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan_bwd

    args, h0, gy, ghN = _scan_inputs(dtype, N=N, seed=13)
    T = scan.KERNEL_CHUNK
    _, _, car = scan.selective_scan_fwd(*args, True, reverse, T, h0,
                                        save_carries=True)
    before = scan.bwd_launches
    got = scan.selective_scan_bwd_cuda(*args, gy, car, ghN, True, reverse, T)
    torch.cuda.synchronize()
    assert scan.bwd_launches == before + 1
    want = selective_scan_bwd(*args, gy, car, ghN, True, reverse, T)
    for name, k, p in zip(SCAN_GRADS, got, want):
        assert k.shape == p.shape and k.dtype == p.dtype, name
        stats = compare(k, p, TOL[dtype])
        assert stats["ok"], (name, stats)


def _fd_check(loss, inputs, seed):
    """Central differences along one seeded direction per input against
    the analytic directional derivative (fp32, the kernels both ways)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dirs = [None if t is None else torch.randn(t.shape, generator=gen,
                                               device="cuda") for t in inputs]
    leaves = [None if t is None else t.clone().requires_grad_()
              for t in inputs]
    loss(leaves).backward()
    analytic = sum((t.grad.double() * v).sum()
                   for t, v in zip(leaves, dirs) if t is not None)
    eps = 2e-3

    def moved(s):
        return [None if t is None else t + s * eps * v
                for t, v in zip(inputs, dirs)]

    with torch.no_grad():
        fd = (loss(moved(1)) - loss(moved(-1))) / (2 * eps)
    assert abs(fd - analytic) <= 5e-3 * abs(analytic), (fd.item(),
                                                       analytic.item())


@pytest.mark.cuda
def test_scan_functions_match_finite_differences(card):
    """`_SelectiveScanFn` (h_init in, hN out, both directions) and
    `_BidirScanFn`: every differentiable input at once."""
    from caduceus_tpu_torch.ops import scan

    args, h0, gy, ghN = _scan_inputs(torch.float32, G=1, L=100, d=16, seed=14)
    args = [t.contiguous() for t in args]
    for reverse in (False, True):
        def loss(ts):
            y, h = scan.selective_scan_chained(*ts, reverse=reverse)
            return (y.double() * gy).sum() + (h.double() * ghN).sum()

        _fd_check(loss, args + [h0], 15 + reverse)
    r, _, gr, _ = _scan_inputs(torch.float32, G=1, L=100, d=16, seed=17)
    r = [t.contiguous() for t in r]

    def bloss(ts):
        f, q = ts[:7], ts[7:]
        yf, yr = scan.bidir_selective_scan(*f[:2], *f[3:5], *q[:2], *q[3:5],
                                           f[2], q[2], f[5], q[5], f[6], q[6])
        return (yf.double() * gy).sum() + (yr.double() * gr).sum()

    _fd_check(bloss, args + r, 18)


@pytest.mark.cuda
def test_v1_model_backward_runs_the_scan_kernels(card):
    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    tok = CaduceusTokenizer()
    cfg = CaduceusConfig(d_model=64, n_layer=2, vocab_size=tok.vocab_size,
                         rcps=True, complement_map=tok.complement_map,
                         residual_in_fp32=False, dtype="bfloat16",
                         ssm_cfg=SSMConfig(version=1, d_state=16))
    model = CaduceusForMaskedLM(cfg, device="cuda",
                                generator=torch.Generator().manual_seed(0))
    ids = torch.randint(7, 11, (2, 300), device="cuda")
    counts = (scan.bidir_launches, scan.bwd_launches)
    model(ids).float().square().mean().backward()
    torch.cuda.synchronize()
    assert (scan.bidir_launches, scan.bwd_launches) == (counts[0] + 2,
                                                        counts[1] + 4)
    for n, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n


@pytest.mark.cuda
def test_scan_wrappers_refuse_what_the_kernels_do_not_take(card):
    from caduceus_tpu_torch.ops import scan

    args, h0, _, _ = _scan_inputs(torch.float32)
    with pytest.raises(ValueError, match="chunk"):
        scan.selective_scan_fwd(*args, True, False, 32, h0)
    with pytest.raises(TypeError):
        scan.selective_scan_fwd(args[0].half(), *args[1:], True, False)
    with pytest.raises(TypeError):
        scan.selective_scan_fwd(args[0], args[1].bfloat16(), *args[2:], True,
                                False)
    with pytest.raises(ValueError, match="d_state"):
        a4, *_ = _scan_inputs(torch.float32, N=4)
        scan.selective_scan_fwd(*a4, True, False)


# --- the unfused SSD forward `ssd_fwd` (TPU kernel #2) against
# ops/ssd.py ssd_chunked, and the prefill that runs it


def _unfused_inputs(dtype, G=2, L=150, H=4, P=32, NG=2, N=32, seed=0):
    """x, dt, A, B, C, D, dt_bias, h_init on the card; x, B and C are column
    views of one (G, L, 16 + H·P + 2·NG·N) conv output and dt a column view
    of a wider in_proj output, as the prefill gives them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=g, device="cuda") * sc
    xc = rnd(G, L, 16 + H * P + 2 * NG * N).to(dtype)
    x = xc[..., 16:16 + H * P].reshape(G, L, H, P)
    B = xc[..., 16 + H * P:16 + H * P + NG * N].reshape(G, L, NG, N)
    C = xc[..., 16 + H * P + NG * N:].reshape(G, L, NG, N)
    dt = (rnd(G, L, H + 8) * 0.5).to(dtype)[..., 8:]
    return (x, dt, -torch.exp(rnd(H, sc=0.5)), B, C, rnd(H), rnd(H, sc=0.1),
            rnd(G, H, N, P))


def _hold_unfused(dtype, reverse, **kw):
    from caduceus_tpu_torch.ops.ssd import ssd_chunked

    x, dt, A, B, C, D, bias, h0 = _unfused_inputs(dtype, **kw)
    T = ssd_batched.KERNEL_CHUNK[dtype]
    before = ssd_batched.unfused_launches
    got = ssd_batched.ssd_fwd(x, dt, A, B, C, D, bias, True, reverse, T, h0,
                              save_carries=True)
    torch.cuda.synchronize()
    assert ssd_batched.unfused_launches == before + 1
    want = ssd_chunked(x, dt, A, B, C, D, bias, True, reverse, T, h0,
                       return_carries=True)
    for name, k, p in zip(("y", "hN", "carries"), got, want):
        assert k.shape == p.shape and k.dtype == p.dtype, name
        stats = compare(k, p, TOL[dtype])
        assert stats["ok"], (name, stats)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse,NG", [(False, 2), (True, 2), (False, 1)])
def test_unfused_kernel_matches_plain(card, dtype, reverse, NG):
    _hold_unfused(dtype, reverse, NG=NG, seed=10 + NG)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unfused_kernel_main_geometry(card, dtype):
    """H=8, P=64, N=128, ngroups 1 (the v2 mixer), a ragged L."""
    _hold_unfused(dtype, False, G=2, L=4000, H=8, P=64, NG=1, N=128, seed=20)


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 2])
def test_prefill_card_matches_cpu(card, version):
    """`inference.prefill` of a 2-layer full-width causal model (d_model
    256), fp32: the card (kernel #7 or #2, one launch per layer) against
    the CPU from the same weights, logits and every cache entry, 1e-4 of
    each tensor's largest value."""
    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig
    from caduceus_tpu_torch.inference import prefill
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    tok = CaduceusTokenizer()
    ssm = (SSMConfig(version=2, d_state=128, headdim=64, ngroups=1)
           if version == 2 else SSMConfig(version=1, d_state=16))
    cfg = CaduceusConfig(d_model=256, n_layer=2, vocab_size=tok.vocab_size,
                         rcps=False, bidirectional=False, dtype="float32",
                         complement_map=tok.complement_map, ssm_cfg=ssm)
    cpu = CaduceusForMaskedLM(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(1))
    model = CaduceusForMaskedLM(cfg, device="cuda")
    model.load_state_dict(cpu.state_dict())
    ids = torch.randint(7, 11, (2, 1000),
                        generator=torch.Generator().manual_seed(2))
    counts = (ssd_batched.unfused_launches, scan.fwd_launches)
    logits, caches = prefill(model, ids.cuda())
    torch.cuda.synchronize()
    want = (counts[0] + 2, counts[1]) if version == 2 else (counts[0],
                                                             counts[1] + 2)
    assert (ssd_batched.unfused_launches, scan.fwd_launches) == want
    ref_logits, ref_caches = prefill(cpu, ids)
    pairs = [(logits, ref_logits)] + [
        (caches[k]["fwd"][n], ref_caches[k]["fwd"][n])
        for k in ref_caches for n in ("conv", "ssm")]
    for k, p in pairs:
        err = (k.cpu() - p).abs().max().item()
        assert err <= 1e-4 * p.abs().max().item(), err


# --- the unfused SSD adjoint `ssd_bwd` (TPU kernels #4 / #6), the per-head
# route (#5 / #6) and the paired scan adjoint `bidir_scan_bwd` (#10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse,NG", [(False, 2), (True, 2), (True, 1)])
def test_unfused_bwd_kernel_matches_plain(card, dtype, reverse, NG):
    """`ssd_bwd` against `ops/ssd.py ssd_chunked_bwd` from the same carries,
    all eight gradients, strided views, nonzero h_init and g_hN."""
    from caduceus_tpu_torch.ops.ssd import ssd_chunked_bwd

    x, dt, A, B, C, D, bias, h0 = _unfused_inputs(dtype, NG=NG, seed=30 + NG)
    T = ssd_batched.KERNEL_CHUNK[dtype]
    gen = torch.Generator(device="cuda").manual_seed(31)
    gy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    ghN = torch.randn(h0.shape, generator=gen, device="cuda")
    _, _, car = ssd_batched.ssd_fwd(x, dt, A, B, C, D, bias, True, reverse, T,
                                    h0, save_carries=True)
    before = ssd_batched.unfused_bwd_launches
    got = ssd_batched.ssd_bwd(x, dt, A, B, C, D, bias, gy, car, ghN, True,
                              reverse, T)
    torch.cuda.synchronize()
    assert ssd_batched.unfused_bwd_launches == before + 1
    want = ssd_chunked_bwd(x, dt, A, B, C, D, bias, gy, car, ghN, True,
                           reverse, T)
    names = ("g_x", "g_dt", "g_A", "g_B", "g_C", "g_D", "g_dt_bias", "g_h0")
    for name, k, p in zip(names, got, want):
        assert k.shape == p.shape and k.dtype == p.dtype, name
        stats = compare(k, p, TOL[dtype])
        assert stats["ok"], (name, stats)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["batched", "head"])
def test_unfused_function_matches_finite_differences(card, entry):
    """`_SSDFn` through `ssd_batched_chained` (#2 / #4) and through
    `ssd_head_chained` (#5 / #6): every differentiable input at once, one
    forward and one backward launch on the entry's own counters."""
    from caduceus_tpu_torch.ops import ssd_head

    fn = {"batched": ssd_batched.ssd_batched_chained,
          "head": ssd_head.ssd_head_chained}[entry]
    x, dt, A, B, C, D, bias, h0 = _unfused_inputs(torch.float32, G=1, L=90,
                                                  seed=32)
    inputs = [t.contiguous() for t in (x, dt, A, B, C, D, bias, h0)]
    gen = torch.Generator(device="cuda").manual_seed(33)
    gy = torch.randn(x.shape, generator=gen, device="cuda").double()
    ghN = torch.randn(h0.shape, generator=gen, device="cuda").double()

    def loss(ts):
        y, h = fn(*ts)
        return (y.double() * gy).sum() + (h.double() * ghN).sum()

    counts = (ssd_batched.unfused_launches, ssd_batched.unfused_bwd_launches,
              ssd_head.head_fwd_launches, ssd_head.head_bwd_launches)
    _fd_check(loss, inputs, 34)
    torch.cuda.synchronize()
    # one forward + backward, then two forwards for the differences
    grown = (3, 1, 0, 0) if entry == "batched" else (0, 0, 3, 1)
    now = (ssd_batched.unfused_launches, ssd_batched.unfused_bwd_launches,
           ssd_head.head_fwd_launches, ssd_head.head_bwd_launches)
    assert tuple(b - a for a, b in zip(counts, now)) == grown


@pytest.mark.cuda
def test_pallas_model_runs_the_per_head_kernels(card):
    """A 2-layer ``use_kernel="pallas"`` v2 model: forward + backward on the
    card launch only the per-head pair (2 directions x 2 layers each), and
    its logits and gradients match the CPU's (fp32, 1e-4 of each tensor's
    largest value)."""
    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.ops import ssd_head
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    tok = CaduceusTokenizer()
    cfg = CaduceusConfig(d_model=64, n_layer=2, vocab_size=tok.vocab_size,
                         rcps=True, complement_map=tok.complement_map,
                         residual_in_fp32=False, dtype="float32",
                         ssm_cfg=SSMConfig(version=2, d_state=32, headdim=32,
                                           use_kernel="pallas"))
    cpu = CaduceusForMaskedLM(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    model = CaduceusForMaskedLM(cfg, device="cuda")
    model.load_state_dict(cpu.state_dict())
    ids = torch.randint(7, 11, (2, 300),
                        generator=torch.Generator().manual_seed(4))
    counts = (ssd_head.head_fwd_launches, ssd_head.head_bwd_launches,
              ssd_batched.launches, ssd_batched.bwd_launches)
    out = model(ids.cuda())
    out.square().mean().backward()
    torch.cuda.synchronize()
    assert (ssd_head.head_fwd_launches, ssd_head.head_bwd_launches,
            ssd_batched.launches, ssd_batched.bwd_launches) == (
        counts[0] + 4, counts[1] + 4, counts[2], counts[3])
    ref = cpu(ids)
    ref.square().mean().backward()
    pairs = [(out, ref)] + [(p.grad, q.grad) for p, q in zip(
        model.parameters(), cpu.parameters())]
    for k, p in pairs:
        err = (k.detach().cpu() - p).abs().max().item()
        assert err <= 1e-4 * p.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bidir_bwd_kernel_matches_two_launches_and_plain(card, dtype):
    """`bidir_scan_bwd` (one launch, both sets) against two launches of
    `selective_scan_bwd` and against the plain adjoints."""
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan_bwd

    f, _, gf, _ = _scan_inputs(dtype, seed=40)
    r, _, gr, _ = _scan_inputs(dtype, seed=41, bias=False)
    _, _, carf, carr = scan.bidir_scan_fwd(*f[:2], *f[3:5], *r[:2], *r[3:5],
                                           f[2], r[2], f[5], r[5], f[6], r[6],
                                           save_carries=True)
    before = (scan.bidir_bwd_launches, scan.bwd_launches)
    got = scan.bidir_scan_bwd(*f[:2], *f[3:5], *r[:2], *r[3:5], f[2], r[2],
                              f[5], r[5], f[6], r[6], gf, gr, carf, carr)
    torch.cuda.synchronize()
    assert (scan.bidir_bwd_launches, scan.bwd_launches) == (before[0] + 1,
                                                            before[1])

    def order(a, b):
        return (*a[:2], *a[3:5], *b[:2], *b[3:5], a[2], b[2], a[5], b[5],
                a[6], b[6])

    two = order(scan.selective_scan_bwd_cuda(*f, gf, carf, None, True, False),
                scan.selective_scan_bwd_cuda(*r, gr, carr, None, True, True))
    plain = order(selective_scan_bwd(*f, gf, carf, None, True, False),
                  selective_scan_bwd(*r, gr, carr, None, True, True))
    for i, (k, t, p) in enumerate(zip(got, two, plain)):
        assert k.shape == p.shape and k.dtype == p.dtype, i
        for ref in (t, p):
            stats = compare(k, ref, TOL[dtype])
            assert stats["ok"], (i, stats)


@pytest.mark.cuda
def test_paired_backward_is_taken_under_the_environment_flag(card,
                                                             monkeypatch):
    """`_BidirScanFn` launches `bidir_scan_bwd` once with
    CADUCEUS_BIDIR_BWD=1 (two `selective_scan_bwd` otherwise), and both
    backwards give the same gradients (fp32, `kernel_check.py`'s rule)."""
    from caduceus_tpu_torch.ops import scan

    f, _, gf, _ = _scan_inputs(torch.float32, seed=42)
    r, _, gr, _ = _scan_inputs(torch.float32, seed=43)
    grads = {}
    for env in ("1", "0"):
        monkeypatch.setenv("CADUCEUS_BIDIR_BWD", env)
        lf = [t.clone().requires_grad_() for t in f]
        lr = [t.clone().requires_grad_() for t in r]
        before = (scan.bidir_bwd_launches, scan.bwd_launches)
        yf, yr = scan.bidir_selective_scan(
            *lf[:2], *lf[3:5], *lr[:2], *lr[3:5], lf[2], lr[2], lf[5], lr[5],
            lf[6], lr[6])
        ((yf * gf).sum() + (yr * gr).sum()).backward()
        torch.cuda.synchronize()
        grown = (scan.bidir_bwd_launches - before[0],
                 scan.bwd_launches - before[1])
        assert grown == ((1, 0) if env == "1" else (0, 2))
        grads[env] = [t.grad for t in lf + lr]
    for a, b in zip(grads["1"], grads["0"]):
        stats = compare(a, b, TOL[torch.float32])
        assert stats["ok"], stats


@pytest.mark.cuda
def test_ssd_kernels_are_deterministic_at_the_training_shape(card):
    """The fused forward and backward (#1 + #3) and the unfused forward and
    adjoint (#2 + #4), twice on the same inputs at the training shape (G=4,
    L=131072, bf16, the main geometry): every output bit for bit the same,
    the conv-weight sums included (all sums in a fixed order, no atomics)."""
    G, L, H, P, NG, N, K = 4, 131072, 8, 64, 1, 128, 4
    T = ssd_batched.KERNEL_CHUNK[torch.bfloat16]
    g = torch.Generator(device="cuda").manual_seed(3)
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=g, device="cuda") * sc
    Wc = H * P + 2 * NG * N
    xBC, dt = rnd(G, L, Wc).bfloat16(), (rnd(G, L, H) * 0.5).bfloat16()
    ps = (-torch.exp(rnd(H, sc=0.5)), rnd(K, Wc, sc=0.5), rnd(Wc, sc=0.1),
          rnd(H), rnd(H, sc=0.1))
    h0, gy, ghN = rnd(G, H, N, P), rnd(G, L, H, P).bfloat16(), rnd(G, H, N, P)
    dims = (H, P, NG, N)
    xc = rnd(G, L, Wc).bfloat16()
    x = xc[..., :H * P].reshape(G, L, H, P)
    B = xc[..., H * P:H * P + NG * N].reshape(G, L, NG, N)
    C = xc[..., H * P + NG * N:].reshape(G, L, NG, N)
    A, _, _, D, bias = ps

    def fused():
        y, hN, car = ssd_batched.ssd_fused_fwd(xBC, dt, *ps, dims, True,
                                               False, T, h0, True)
        return (y, hN, car) + tuple(ssd_batched.ssd_fused_bwd(
            xBC, dt, *ps, gy, car, ghN, dims, True, False, T))

    def unfused():
        y, hN, car = ssd_batched.ssd_fwd(x, dt, A, B, C, D, bias, True,
                                         False, T, h0, True)
        return (y, hN, car) + tuple(ssd_batched.ssd_bwd(
            x, dt, A, B, C, D, bias, gy, car, ghN, True, False, T))

    for fn in (fused, unfused):
        first = [t.clone() for t in fn()]
        second = fn()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second)), fn


# --- the redesigned scan kernels where their pieces meet: chunks of 256
# rows (32 runs of 8), and the adjoint's clusters of channel tiles (d / 8
# tiles in clusters of up to 2: d = 40 gives 5 clusters of 1, d = 48 three
# of 2)


@pytest.mark.cuda
@pytest.mark.parametrize("L,d,dtype,reverse,G", [
    (255, 48, torch.float32, False, 2), (257, 40, torch.bfloat16, True, 2),
    (700, 48, torch.bfloat16, False, 2), (512, 40, torch.float32, True, 2),
    (9, 16, torch.float32, True, 2), (257, 512, torch.bfloat16, True, 3),
    (700, 512, torch.float32, False, 3), (300, 42, torch.float32, True, 1)])
def test_scan_kernels_at_piece_edges(card, L, d, dtype, reverse, G):
    """L = one chunk - 1 and + 1, a ragged L over three chunks, two whole
    chunks, and L shorter than a run; forward (y, hN, carries, h_init in)
    and adjoint (all eight outputs, g_hN in) against the plain versions.
    The forward runs blocks of 8 channels, or in fp32 of 4 where blocks of
    8 would be fewer than the SMs (the small fp32 cases and the prefill):
    G=3, d=512 runs 192 blocks of 8 at a ragged L, d=42 in fp32 blocks of
    4 (and the adjoint a tile of 8) whose last is partial."""
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import (selective_scan,
                                                       selective_scan_bwd)

    args, h0, gy, ghN = _scan_inputs(dtype, G=G, L=L, d=d, seed=50 + L)
    T = scan.KERNEL_CHUNK
    got = scan.selective_scan_fwd(*args, True, reverse, T, h0,
                                  save_carries=True)
    want = selective_scan(*args, True, reverse, T, h0, True, True)
    car = got[2]
    got += scan.selective_scan_bwd_cuda(*args, gy, car, ghN, True, reverse, T)
    torch.cuda.synchronize()
    want += selective_scan_bwd(*args, gy, car, ghN, True, reverse, T)
    for name, k, p in zip(("y", "hN", "carries") + SCAN_GRADS, got, want):
        assert k.shape == p.shape and k.dtype == p.dtype, name
        stats = compare(k, p, TOL[dtype])
        assert stats["ok"], (name, stats)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_scan_kernel_matches_plain(card, dtype):
    """`selective_scan_fwd` with z (a column slice of a (G, L, 2 d)
    tensor, as in_proj gives it) against the plain gated forward, and
    `selective_scan_gated` without grad is that launch."""
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan

    args, h0, _, _ = _scan_inputs(dtype, L=600, seed=60)
    G, L, d = args[0].shape
    g = torch.Generator(device="cuda").manual_seed(61)
    z = torch.randn(G, L, 2 * d, generator=g, device="cuda").to(dtype)[..., d:]
    for reverse in (False, True):
        got = scan.selective_scan_fwd(*args, True, reverse, scan.KERNEL_CHUNK,
                                      h0, save_carries=True, z=z)
        want = selective_scan(*args, True, reverse, scan.KERNEL_CHUNK, h0,
                              True, True, z=z)
        for name, k, p in zip(("y", "hN", "carries"), got, want):
            stats = compare(k, p, TOL[dtype])
            assert stats["ok"], (name, reverse, stats)
    before = scan.fwd_launches
    y = scan.selective_scan_gated(*args[:6], z, args[6], True)
    assert scan.fwd_launches == before + 1
    want = selective_scan(*args, True, z=z)
    assert compare(y, want, TOL[dtype])["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_scan_under_grad_matches_plain(card, dtype):
    """`selective_scan_gated` under grad (the kernel without z, y rounded
    to its dtype, then the gate as PyTorch ops: in bf16 a second rounding
    the launch without grad does not make) against the plain gated
    forward, both directions."""
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan

    args, _, _, _ = _scan_inputs(dtype, L=600, seed=66)
    g = torch.Generator(device="cuda").manual_seed(67)
    z = torch.randn(args[0].shape, generator=g, device="cuda").to(dtype)
    u = args[0].clone().requires_grad_()
    for reverse in (False, True):
        before = scan.fwd_launches
        y = scan.selective_scan_gated(u, *args[1:6], z, args[6], True,
                                      reverse)
        assert y.requires_grad and scan.fwd_launches == before + 1
        want = selective_scan(*args, True, reverse, z=z)
        stats = compare(y.detach(), want, TOL[dtype])
        assert stats["ok"], (reverse, stats)


@pytest.mark.cuda
def test_gated_scan_matches_finite_differences(card):
    """`selective_scan_gated` under grad (the kernel without z and its
    adjoint, the gate as PyTorch ops): every input, z included."""
    from caduceus_tpu_torch.ops import scan

    args, _, gy, _ = _scan_inputs(torch.float32, G=1, L=300, d=16, seed=62)
    args = [t.contiguous() for t in args]
    g = torch.Generator(device="cuda").manual_seed(63)
    z = torch.randn(args[0].shape, generator=g, device="cuda")
    for reverse in (False, True):
        def loss(ts):
            y = scan.selective_scan_gated(*ts[:6], ts[7], ts[6], True,
                                          reverse)
            return (y.double() * gy).sum()

        _fd_check(loss, args + [z], 64 + reverse)


@pytest.mark.cuda
def test_scan_kernels_are_deterministic_at_the_training_shape(card):
    """#9 + #8 (both directions), #7 + #8 with h_init and g_hN, and #10,
    twice on the same inputs at the training shape (G=4, L=131072, d=512,
    N=16, bf16): every output bit for bit the same (g_B / g_C added in a
    fixed order, no float atomics)."""
    from caduceus_tpu_torch.ops import scan

    G, L, d, N = 4, 131072, 512, 16
    T = scan.KERNEL_CHUNK
    f, h0, gyf, ghN = _scan_inputs(torch.bfloat16, G=G, L=L, d=d, N=N,
                                   seed=70)
    r, _, gyr, _ = _scan_inputs(torch.bfloat16, G=G, L=L, d=d, N=N, seed=71)
    pa = (*f[:2], *f[3:5], *r[:2], *r[3:5], f[2], r[2], f[5], r[5], f[6],
          r[6])

    def paired():
        yf, yr, cf, cr = scan.bidir_scan_fwd(*pa, save_carries=True)
        return (yf, yr, cf, cr) + scan.selective_scan_bwd_cuda(
            *f, gyf, cf, None, True, False, T)[:7] + \
            scan.selective_scan_bwd_cuda(*r, gyr, cr, None, True, True, T)[:7]

    def one_direction():
        out = scan.selective_scan_fwd(*f, True, False, T, h0,
                                      save_carries=True)
        return out + scan.selective_scan_bwd_cuda(*f, gyf, out[2], ghN, True,
                                                  False, T)

    def paired_bwd():
        _, _, cf, cr = scan.bidir_scan_fwd(*pa, save_carries=True)
        return scan.bidir_scan_bwd(*pa, gyf, gyr, cf, cr)

    for fn in (paired, one_direction, paired_bwd):
        first = [t.clone() for t in fn()]
        second = fn()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second)), fn


def _resume_config(version):
    """`configs/hg38_mlm_v2.yaml` (v2) or `configs/hg38_mlm.yaml` (v1) at
    full width, 2 layers."""
    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    tok = CaduceusTokenizer()
    ssm = (SSMConfig(version=2, d_state=128, headdim=64, ngroups=1, d_conv=4,
                     expand=2, ssd_chunk_size=128, ssd_seg_chunks=8)
           if version == 2 else SSMConfig(version=1, d_state=16, d_conv=4,
                                          expand=2))
    return CaduceusConfig(
        d_model=256, n_layer=2, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, residual_in_fp32=False,
        dtype="bfloat16", param_dtype="float32", remat=True, remat_span=1,
        ssm_cfg=ssm)


@pytest.mark.cuda
@pytest.mark.parametrize("version", [2, 1])
def test_backward_repeats_bit_for_bit_on_the_card(card, tmp_path, version):
    """Forward and backward of six MLM batches of 4 x 4096 tokens (ids
    with masks, PAD and random tokens, as the loader makes them), twice
    each from the same weights: every parameter's gradient equal, the
    embedding's among them (PyTorch's CUDA embedding backward is not:
    `models/caduceus.py _Embedding`)."""
    from caduceus_tpu_torch.data.hg38 import HG38DataModule
    from caduceus_tpu_torch.data.synthetic import make_synthetic_genome
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.train.metrics import cross_entropy_loss

    fa, bed = make_synthetic_genome(str(tmp_path / "genome"), chrom_len=1 << 16)
    dm = HG38DataModule(bed, fa, max_length=4096, batch_size=4, seed=1)
    model = CaduceusForMaskedLM(_resume_config(version), device="cuda",
                                generator=torch.Generator().manual_seed(5))

    def grads(batch):
        for p in model.parameters():
            p.grad = None
        ids = torch.from_numpy(batch["input_ids"]).cuda()
        tgt = torch.from_numpy(batch["targets"]).cuda()
        cross_entropy_loss(model(ids), tgt)[0].backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    for k, batch in enumerate(dm.train_loader()):
        if k == 6:
            break
        a, b = grads(batch), grads(batch)
        for n in a:
            assert torch.equal(a[n], b[n]), (k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("version", [2, 1])
def test_trainer_resume_is_bit_exact_on_the_card(card, tmp_path, version):
    """`Trainer.fit(4)` against fit(2), save, a fresh Trainer, restore,
    fit(4), at L=4096, batches of 4 in 2 micro-batches, EMA on: steps 3
    and 4 log the same loss, acc and grad_norm, and the parameters and the
    EMA end the same, compared with ==."""
    from caduceus_tpu_torch.data.hg38 import HG38DataModule
    from caduceus_tpu_torch.data.synthetic import make_synthetic_genome
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.train.trainer import Trainer, TrainerConfig

    fa, bed = make_synthetic_genome(str(tmp_path / "genome"), chrom_len=1 << 16)
    cfg = _resume_config(version)

    def trainer(run_dir):
        dm = HG38DataModule(bed, fa, max_length=4096, batch_size=4, seed=1)
        model = CaduceusForMaskedLM(cfg, device="cuda",
                                    generator=torch.Generator().manual_seed(5))
        records = []
        t = Trainer(model, TrainerConfig(
            max_steps=4, log_every=1, eval_every=100, checkpoint_every=100,
            accum_steps=2, ema_decay=0.999, run_dir=str(run_dir)),
            dm.train_loader(), log_fn=records.append)
        t.init_state()
        return t, records

    whole, rec_w = trainer(tmp_path / "whole")
    whole.fit(4)
    first, _ = trainer(tmp_path / "cut")
    first.fit(2)
    first.save_checkpoint()
    del first
    second, rec_r = trainer(tmp_path / "cut")
    assert second.restore_checkpoint() and second.state.step == 2
    second.fit(4)
    for a, b in zip(rec_w[2:], rec_r):
        assert a["step"] == b["step"]
        for k in ("loss", "acc", "grad_norm"):
            assert a[k] == b[k], (a["step"], k, a[k], b[k])
    assert [r["step"] for r in rec_r] == [3, 4]
    for (n, p), (_, q) in zip(whole.model.named_parameters(),
                              second.model.named_parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(whole.state.ema_params[n],
                           second.state.ema_params[n]), n


# -- the fine-tuning shape: 128 sequences of 251 bases, both strands ---------

FT_G, FT_L = 256, 251


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kernel", ["ssd_fused_fwd", "ssd_fused_bwd",
                                    "bidir_scan_fwd", "selective_scan_bwd"])
def test_kernels_at_the_finetune_shape(card, kernel, reverse):
    """#1, #3a + #3b, #9 and #8 at G=256, L=251 (4 bf16 SSD chunks, the
    last of 59 rows, one segment per (g, h); one ragged 256-row scan chunk;
    #3b's 1,024-row tile longer than the sequence), full width, bf16,
    against their plain versions by the `kernel_check.py` rule."""
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import (
        selective_scan,
        selective_scan_bwd,
    )

    dt = torch.bfloat16
    if kernel.startswith("ssd"):
        args, kw, (gy, _) = _inputs(dt, G=FT_G, L=FT_L, H=8, P=64, NG=1,
                                    N=128, seed=20 + reverse)
        T = ssd_batched.KERNEL_CHUNK[dt]
        ps = (kw["conv_b"], kw["D"], kw["dt_bias"])
        got = ssd_batched.ssd_fused_fwd(*args, *ps, kw["dims"], True, reverse,
                                        T, None, save_carries=True)
        want = ssd_chunked_fused(*args, *ps, dims=kw["dims"],
                                 dt_softplus=True, reverse=reverse,
                                 chunk_size=T, return_carries=True)
        names = ("y", "hN", "carries")
        if kernel == "ssd_fused_bwd":
            car = got[2]
            got = ssd_batched.ssd_fused_bwd(*args, *ps, gy, car, None,
                                            kw["dims"], True, reverse, T)
            want = ssd_chunked_fused_bwd(*args, *ps, gy, car, None,
                                         kw["dims"], True, reverse, T)
            names = GRAD_NAMES
    else:
        args, _, gy, _ = _scan_inputs(dt, G=FT_G, L=FT_L, d=512, N=16,
                                      seed=30 + reverse)
        T = scan.KERNEL_CHUNK
        if kernel == "bidir_scan_fwd":
            r, _, _, _ = _scan_inputs(dt, G=FT_G, L=FT_L, d=512, N=16,
                                      seed=40 + reverse)
            f, r = (r, args) if reverse else (args, r)
            yf, yr, cf, cr = scan.bidir_scan_fwd(
                *f[:2], *f[3:5], *r[:2], *r[3:5], f[2], r[2], f[5], r[5],
                f[6], r[6], save_carries=True)
            got = (yf, cf, yr, cr)
            want = (selective_scan(*f, True, False, T, return_carries=True)
                    + selective_scan(*r, True, True, T, return_carries=True))
            names = ("yf", "carf", "yr", "carr")
        else:
            _, _, car = scan.selective_scan_fwd(*args, True, reverse, T,
                                                None, save_carries=True)
            got = scan.selective_scan_bwd_cuda(*args, gy, car, None, True,
                                               reverse, T)
            want = selective_scan_bwd(*args, gy, car, None, True, reverse, T)
            names = SCAN_GRADS
    torch.cuda.synchronize()
    for name, k, p in zip(names, got, want):
        if p is None:
            continue
        assert k.shape == p.shape and k.dtype == p.dtype, name
        stats = compare(k, p, TOL[dt])
        assert stats["ok"], (kernel, name, stats)


def _chip_smoke_ssd_inputs(G, L, seed):
    """chip_smoke.py `ssd_inputs` at full width in bf16 (H=8, P=64, NG=1,
    N=128, K=4, ``width_pad=512``): the same draws for a seed, so a seed
    names the same case there and here."""
    H, P, NG, N, K = 8, 64, 1, 128, 4
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=g, device="cuda") * sc
    Wc = H * P + 2 * NG * N
    wide = rnd(G, L, 512 + Wc + H)
    wide[..., 512 + Wc:] *= 0.5
    wide = wide.to(torch.bfloat16)
    return dict(
        xBC=wide[..., 512:512 + Wc], dt=wide[..., 512 + Wc:],
        A=-torch.exp(rnd(H, sc=0.5)), conv_w=rnd(K, Wc, sc=0.5),
        conv_b=rnd(Wc, sc=0.1), D=rnd(H), dt_bias=rnd(H, sc=0.1),
        h_init=rnd(G, H, N, P), dims=(H, P, NG, N),
        g_y=rnd(G, L, H, P).to(torch.bfloat16), g_hN=rnd(G, H, N, P))


# seed -> the outputs of #3a + #3b that miss the rule with h_init and g_hN at
# the fine-tuning shape: ROADMAP.md queue 3 item 7. They must miss, so that
# a change that makes one pass shows here and empties the table.
FT_GHN_KNOWN_MISSES = {701: {"g_dt_bias"}}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(700, 712))
def test_ssd_bwd_with_final_state_cotangent_at_the_finetune_shape(card, seed):
    """#3a + #3b at G=256, L=251, full width, bf16 (reverse on odd seeds),
    from a forward with h_init and with a nonzero final-state cotangent
    g_hN, against the plain version by the `kernel_check.py` rule: every
    output passes but the known misses of `FT_GHN_KNOWN_MISSES`, which
    fail. No model path passes g_hN (the step's case is held above)."""
    inp = _chip_smoke_ssd_inputs(FT_G, FT_L, seed)
    reverse = seed % 2 == 1
    T = ssd_batched.KERNEL_CHUNK[torch.bfloat16]
    args = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
            inp["D"], inp["dt_bias"])
    _, _, car = ssd_batched.ssd_fused_fwd(*args, inp["dims"], True, reverse,
                                          T, inp["h_init"], save_carries=True)
    got = ssd_batched.ssd_fused_bwd(*args, inp["g_y"], car, inp["g_hN"],
                                    inp["dims"], True, reverse, T)
    torch.cuda.synchronize()
    want = ssd_chunked_fused_bwd(*args, inp["g_y"], car, inp["g_hN"],
                                 inp["dims"], True, reverse, T)
    missed = {name for name, k, p in zip(GRAD_NAMES, got, want)
              if not compare(k, p, TOL[torch.bfloat16])["ok"]}
    assert missed == FT_GHN_KNOWN_MISSES.get(seed, set()), (seed, missed)


def _finetune_task(tmp_path, n_train=300, n_test=64):
    from caduceus_tpu_torch.data.classification import (
        ClassificationDataModule,
        make_synthetic_classification_task,
    )

    make_synthetic_classification_task(str(tmp_path), task="t",
                                       n_train=n_train, n_test=n_test,
                                       seq_len=FT_L, num_classes=2, seed=1)
    return ClassificationDataModule(str(tmp_path), "t", max_length=FT_L,
                                    batch_size=64, train_val_split_seed=1,
                                    seed=1)


def _full_width(version, n_layer, dtype):
    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    tok = CaduceusTokenizer()
    ssm = (SSMConfig(version=2, d_state=128, headdim=64, ngroups=1)
           if version == 2 else SSMConfig(version=1, d_state=16))
    return CaduceusConfig(d_model=256, n_layer=n_layer,
                          vocab_size=tok.vocab_size, rcps=True,
                          complement_map=tok.complement_map,
                          residual_in_fp32=False, dtype=dtype, remat=True,
                          ssm_cfg=ssm)


@pytest.mark.cuda
@pytest.mark.parametrize("version", [2, 1])
def test_finetune_step_card_matches_cpu(card, tmp_path, version):
    """One fine-tuning step (RCPS classifier, 2 layers, full width, fp32,
    64 sequences of 251 bases) on the card and on the CPU from the same
    weights and batch: the loss within 1e-5 and every gradient within 1e-4
    of the CPU's largest element."""
    from types import SimpleNamespace

    from caduceus_tpu_torch.finetune import (
        _make_classifier,
        _to_device,
        make_finetune_step,
    )

    dm = _finetune_task(tmp_path)
    cfg = _full_width(version, 2, "float32")
    batch = next(dm.batches("train", seed=1))
    out = {}
    for dev in ("cpu", "cuda"):
        model = _make_classifier(cfg, 2, "mean", False, "left", device=dev,
                                 generator=torch.Generator().manual_seed(3))
        step = make_finetune_step(model, SimpleNamespace(step=lambda: None),
                                  "single_label_classification")
        loss = step(_to_device(batch, dev))
        out[dev] = (float(loss), {n: p.grad.cpu()
                                  for n, p in model.named_parameters()})
    (l_c, g_c), (l_k, g_k) = out["cpu"], out["cuda"]
    assert abs(l_k - l_c) <= 1e-5 * abs(l_c)
    for n in g_c:
        s = g_c[n].abs().max().item() + 1e-30
        assert (g_k[n] - g_c[n]).abs().max().item() <= 1e-4 * s, n


@pytest.mark.cuda
@pytest.mark.parametrize("version", [2, 1])
def test_finetune_one_repeats_bit_for_bit_on_the_card(card, tmp_path,
                                                      version):
    """Two `finetune_one` runs of one seed on the card (RCPS classifier, 4
    layers, full width, bf16, 2 epochs): the same logs, metrics and
    best-val parameters, bit for bit."""
    from caduceus_tpu_torch.finetune import finetune_one

    dm = _finetune_task(tmp_path)
    cfg = _full_width(version, 4, "bfloat16")
    runs = []
    for _ in range(2):
        logs = []
        res, best = finetune_one(cfg, dm, 2, epochs=2, seed=5, metric="all",
                                 log_fn=logs.append, return_state=True,
                                 device="cuda")
        runs.append((logs, res, best))
    (l1, r1, b1), (l2, r2, b2) = runs
    assert l1 == l2 and r1 == r2
    assert b1.keys() == b2.keys()
    for k in b1:
        assert torch.equal(b1[k], b2[k]), k


# --- the context-parallel entry of #1 / #3a / #3b (`ssd_batched_fused_cp`):
# edge_hist in, its gradient g_edge out

CP_GRADS = GRAD_NAMES + ("g_edge",)
CP_SHAPES = {"small": dict(L_loc=256, H=4, P=32, NG=2, N=32),
             "cp": dict(L_loc=131072, H=8, P=64, NG=1, N=128),
             # one rank's lanes under tensor parallelism over 2
             "tp": dict(L_loc=131072, H=4, P=64, NG=1, N=128)}
# (shape, reverse): outputs known to miss the rule at these inputs,
# ROADMAP.md queue 3 item 11: at the CP shape, forward, one element of
# g_xBC's C columns (row 39305, column 644: |plain| 0.83, |err| 0.148, atol
# needed 0.062517 > 0.0625 x mean|ref|), with edge_hist, with an all-zero
# one and without it alike: a cancelling sum of the heads' g_C shares and
# the conv transpose, 39,000 rows from the edge. Its float64 value is
# 0.7401: the kernel (0.6797) is nearer than the plain version (0.8281).
# Each must still miss (the test flags a stale entry), the entry without
# edge_hist too, and the kernel must stay the nearer.
CP_KNOWN_MISSES = {("cp", False): ("g_xBC",)}


def _cp_inputs(dtype, shape, n_shards=2, seed=0):
    """A sequence of n_shards shards of the shape's length, G=2, with
    h_init, the cotangents and one shard's random edge rows."""
    c = CP_SHAPES[shape]
    H, P, NG, N = c["H"], c["P"], c["NG"], c["N"]
    G, L = 2, c["L_loc"] * n_shards
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=g, device="cuda") * sc
    Wc = H * P + 2 * NG * N
    return dict(
        xBC=rnd(G, L, Wc).to(dtype), dt=(rnd(G, L, H) * 0.5).to(dtype),
        A=-torch.exp(rnd(H, sc=0.5)), conv_w=rnd(4, Wc, sc=0.5),
        conv_b=rnd(Wc, sc=0.1), D=rnd(H), dt_bias=rnd(H, sc=0.1),
        h_init=rnd(G, H, N, P), g_y=rnd(G, L, H, P).to(dtype),
        g_hN=rnd(G, H, N, P), edge=rnd(G, 8, Wc).to(dtype),
        dims=(H, P, NG, N), n=n_shards)


def _cp_shard_pair(inp, reverse, edge):
    """Shard 0 through the CP entry's kernels and its plain version, with
    ``edge``: (kernel outputs, plain outputs): y, hN, carries and the nine
    gradients (g_edge last)."""
    n_loc = inp["xBC"].shape[1] // inp["n"]
    T = ssd_batched.KERNEL_CHUNK[inp["xBC"].dtype]
    a = (inp["xBC"][:, :n_loc], inp["dt"][:, :n_loc], inp["A"],
         inp["conv_w"], inp["conv_b"], inp["D"], inp["dt_bias"])
    gy = inp["g_y"][:, :n_loc]
    fk = ssd_batched.ssd_fused_fwd(*a, inp["dims"], True, reverse, T,
                                   inp["h_init"], True, edge_hist=edge)
    bk = ssd_batched.ssd_fused_bwd(*a, gy, fk[2], inp["g_hN"], inp["dims"],
                                   True, reverse, T, edge_hist=edge)
    fp = ssd_chunked_fused(*a, dims=inp["dims"], dt_softplus=True,
                           reverse=reverse, chunk_size=T,
                           h_init=inp["h_init"], return_carries=True,
                           edge_hist=edge)
    bp = ssd_chunked_fused_bwd(*a, gy, fp[2], inp["g_hN"], inp["dims"], True,
                               reverse, T, edge_hist=edge)
    return tuple(fk) + tuple(bk), tuple(fp) + tuple(bp)


def _exact_g_xBC_B(inp, g, r, c):
    """g_xBC[g, r, c] of shard 0 (forward scan, with inp's edge rows and
    its final-state cotangent) for a B column c, in float64 with no
    rounding between operations at the same bf16 inputs: B_t feeds S_t =
    a_t S_(t-1) + dt_t B_t x_t^T only, so its gradient is dt_t x_t .
    lambda_t, where lambda_t = dL/dS_t comes from the adjoint recurrence
    lambda_t = C_t g_y_t + a_(t+1) lambda_(t+1) from the shard's end (g_hN
    there) down to row r; then the SiLU' and the conv transpose."""
    H, P, NG, N = inp["dims"]
    n_loc = inp["xBC"].shape[1] // inp["n"]
    K = inp["conv_w"].shape[0]
    assert NG == 1 and H * P <= c < H * P + N and r + K <= n_loc
    d = lambda t: t.double()
    w, b = d(inp["conv_w"]), d(inp["conv_b"])
    ext = torch.cat([d(inp["edge"][g, 8 - (K - 1):]),
                     d(inp["xBC"][g, :n_loc])])       # rows -(K-1) .. n_loc-1
    pre = sum(w[k] * ext[k:k + n_loc] for k in range(K)) + b
    xc = pre * torch.sigmoid(pre)
    x = xc[:, :H * P].reshape(n_loc, H, P)
    C = xc[:, H * P + N:]
    dt = torch.nn.functional.softplus(d(inp["dt"][g, :n_loc])
                                      + d(inp["dt_bias"]))
    decay = torch.exp(dt * d(inp["A"]))
    gy = d(inp["g_y"][g, :n_loc])
    lam = d(inp["g_hN"][g])                               # (H, N, P)
    g_B = torch.zeros(K, N, dtype=torch.float64, device=lam.device)
    for t in range(n_loc - 1, r - 1, -1):
        lam = lam + C[t][None, :, None] * gy[t][:, None, :]
        if t < r + K:
            g_B[t - r] = torch.einsum("h,hp,hnp->n", dt[t], x[t], lam)
        lam = decay[t][:, None, None] * lam
    j = c - H * P
    z = pre[r:r + K, c]
    sg = torch.sigmoid(z)
    g_pre = g_B[:, j] * sg * (1 + z * (1 - sg))
    return float(sum(w[k, c] * g_pre[K - 1 - k] for k in range(K)))


def _exact_g_xBC_C(inp, g, r, c):
    """g_xBC[g, r, c] of shard 0 (forward scan, with inp's edge rows) for a
    C column c, evaluated in float64 with no rounding between operations
    at the same bf16 inputs: C feeds only y_t = C_t . S_t + D x_t, so its
    gradient is sum_h g_y[t, h] . S_t[h]; the states S_t come from a
    float64 recurrence over rows 0 .. r + K - 1, the SiLU' and the conv
    transpose then give the element."""
    H, P, NG, N = inp["dims"]
    n_loc = inp["xBC"].shape[1] // inp["n"]
    K = inp["conv_w"].shape[0]
    t1 = r + K                          # rows r .. r + K - 1 feed the element
    assert NG == 1 and c >= H * P + N and t1 <= n_loc
    d = lambda t: t.double()
    w, b = d(inp["conv_w"]), d(inp["conv_b"])
    ext = torch.cat([d(inp["edge"][g, 8 - (K - 1):]),
                     d(inp["xBC"][g, :t1])])           # rows -(K-1) .. t1-1
    pre = sum(w[k] * ext[k:k + t1] for k in range(K)) + b
    xc = pre * torch.sigmoid(pre)
    x = xc[:, :H * P].reshape(t1, H, P)
    B = xc[:, H * P:H * P + N]
    dt = torch.nn.functional.softplus(d(inp["dt"][g, :t1]) + d(inp["dt_bias"]))
    decay = torch.exp(dt * d(inp["A"]))
    S = d(inp["h_init"][g])
    g_C = torch.zeros(K, N, dtype=torch.float64, device=S.device)
    gy = d(inp["g_y"][g])
    for t in range(t1):
        S = (decay[t][:, None, None] * S
             + dt[t][:, None, None] * B[t][None, :, None] * x[t][:, None, :])
        if t >= r:
            g_C[t - r] = torch.einsum("hp,hnp->n", gy[t], S)
    j = c - (H * P + N)
    z = pre[r:r + K, c]
    sg = torch.sigmoid(z)
    g_pre = g_C[:, j] * sg * (1 + z * (1 - sg))
    # forward conv: x row r feeds pre[r + (K-1) - k] through tap k
    return float(sum(w[k, c] * g_pre[K - 1 - k] for k in range(K)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ("small", torch.float32), ("small", torch.bfloat16),
    ("cp", torch.bfloat16)])
@pytest.mark.parametrize("reverse", [False, True])
def test_cp_entry_matches_plain(card, shape, dtype, reverse):
    """One shard through the CP entry with random edge rows against its
    plain version with them: y, hN, the carries and all nine gradients,
    g_edge included; with all-zero edge rows, the entry without edge_hist
    bit for bit (forward and backward)."""
    inp = _cp_inputs(dtype, shape)
    got, want = _cp_shard_pair(inp, reverse, inp["edge"])
    names = ("y", "hN", "carries") + CP_GRADS
    miss = CP_KNOWN_MISSES.get((shape, reverse), ())
    stats = {}
    for name, k, p in zip(names, got, want):
        stats[name] = compare(k, p, TOL[dtype])
        assert stats[name]["ok"] != (name in miss), (name, stats[name])
    zero, _ = _cp_shard_pair(inp, reverse, torch.zeros_like(inp["edge"]))
    before = (ssd_batched.launches, ssd_batched.bwd_launches)
    no_edge, no_edge_plain = _cp_shard_pair(inp, reverse, None)
    assert (ssd_batched.launches, ssd_batched.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    for name, a, b in zip(names, zero, no_edge):
        assert torch.equal(a, b), name
    for name in miss:   # the entry without edge_hist misses it too
        i = names.index(name)
        assert not compare(no_edge[i], no_edge_plain[i], TOL[dtype])["ok"]
    if ("cp", False) == (shape, reverse):
        # the g_xBC element of the known miss against its float64 value
        k, p = got[3], want[3]
        excess = ((k.float() - p.float()).abs()
                  - TOL[dtype].rtol * p.float().abs())
        g, r, c = torch.unravel_index(excess.argmax(), k.shape)
        g, r, c = int(g), int(r), int(c)
        exact = _exact_g_xBC_C(inp, g, r, c)
        kv, pv = float(k[g, r, c]), float(p[g, r, c])
        print(f"g_xBC[{g}, {r}, {c}]: kernel {kv!r}, plain {pv!r}, float64 "
              f"{exact!r}")
        # the kernel is the nearer of the two to the exact value
        assert abs(kv - exact) <= abs(pv - exact), (kv, pv, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ("small", torch.float32), ("small", torch.bfloat16),
    ("cp", torch.bfloat16)])
@pytest.mark.parametrize("reverse", [False, True])
def test_cp_shards_match_the_whole_sequence(card, shape, dtype, reverse):
    """The sequence cut into shards, each through `ssd_batched_fused_cp`
    with its neighbour's rows as edge_hist and the previous shard's hN as
    h_init (under autograd), against one `ssd_batched_fused` call: y, hN
    and the gradients of xBC, conv_w and h_init."""
    n = 4 if shape == "small" else 2
    inp = _cp_inputs(dtype, shape, n_shards=n, seed=1)
    out = []
    for split in (True, False):
        xBC = inp["xBC"].clone().requires_grad_(True)
        cw = inp["conv_w"].clone().requires_grad_(True)
        h0 = inp["h_init"].clone().requires_grad_(True)
        kw = dict(dims=inp["dims"], dt_softplus=True, reverse=reverse)
        if split:
            n_loc = xBC.shape[1] // n
            ys, h = [None] * n, h0
            before = ssd_batched.cp_launches
            for s in (range(n - 1, -1, -1) if reverse else range(n)):
                sl = slice(s * n_loc, (s + 1) * n_loc)
                nb = s + 1 if reverse else s - 1
                if 0 <= nb < n:
                    rows = xBC[:, nb * n_loc:(nb + 1) * n_loc]
                    edge = rows[:, :8] if reverse else rows[:, -8:]
                else:
                    edge = torch.zeros_like(inp["edge"])
                ys[s], h = ssd_batched.ssd_batched_fused_cp(
                    xBC[:, sl], inp["dt"][:, sl], inp["A"], cw,
                    inp["conv_b"], inp["D"], inp["dt_bias"], h, edge, **kw)
            assert ssd_batched.cp_launches == before + n
            y = torch.cat(ys, 1)
        else:
            y, h = ssd_batched.ssd_batched_fused(
                xBC, inp["dt"], inp["A"], cw, conv_b=inp["conv_b"],
                D=inp["D"], dt_bias=inp["dt_bias"], h_init=h0,
                return_final_state=True, **kw)
        loss = ((y.float() * inp["g_y"].float()).sum()
                + (h * inp["g_hN"]).sum())
        out.append((y.detach(), h.detach())
                   + torch.autograd.grad(loss, (xBC, cw, h0)))
    for name, k, p in zip(("y", "hN", "g_xBC", "g_conv_w", "g_h0"), *out):
        stats = compare(k, p, TOL[dtype])
        assert stats["ok"], (name, stats)


@pytest.mark.cuda
def test_cp_entry_repeats_bit_for_bit(card):
    """The CP entry's forward and adjoint twice at the CP shape (G=2,
    L_loc=131072, bf16, both directions): every output, g_edge included,
    bit for bit the same (its spill is written by one tile, no atomics)."""
    inp = _cp_inputs(torch.bfloat16, "cp", seed=2)
    for reverse in (False, True):
        first, _ = _cp_shard_pair(inp, reverse, inp["edge"])
        first = [t.clone() for t in first]
        again, _ = _cp_shard_pair(inp, reverse, inp["edge"])
        torch.cuda.synchronize()
        for name, a, b in zip(("y", "hN", "carries") + CP_GRADS, first,
                              again):
            assert torch.equal(a, b), (reverse, name)


# --- the flash-attention kernels of the hybrid Hyena layers ------------

ATTN_NAMES = ("o", "lse", "dq", "dk", "dv")


def _attn_case(dtype, B, L, H, hd, causal, seed, packed=False):
    """The three attention kernels and their plain versions on the same
    card tensors: {name: (kernel, plain)}, and the kernels' outputs of a
    second run. With ``packed`` q, k and v are strided views of one
    (B, L, 3 H hd) tensor, as `MHA.forward` splits its Wqkv output."""
    from caduceus_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        w = torch.randn(B, L, 3 * H * hd, generator=g, device="cuda").to(dtype)
        q, k, v = (t.view(B, L, H, hd) for t in w.split(H * hd, dim=-1))
        assert not q.is_contiguous() and k.stride(1) == 3 * H * hd
        do = torch.randn(B, L, H, hd, generator=g, device="cuda").to(dtype)
    else:
        q, k, v, do = (torch.randn(B, L, H, hd, generator=g,
                                   device="cuda").to(dtype) for _ in range(4))
    sc = hd ** -0.5

    def kernels():
        o, lse = attention.attention_fwd(q, k, v, causal, sc)
        return (o, lse, *attention.attention_bwd(q, k, v, o, lse, do, causal,
                                                 sc))

    got = kernels()
    po, plse = attention.attention_fwd_plain(q, k, v, causal, sc)
    plain = (po, plse, *attention.attention_bwd_plain(
        q, k, v, got[0], got[1], do, causal, sc))
    torch.cuda.synchronize()
    return dict(zip(ATTN_NAMES, zip(got, plain))), kernels()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("L,hd,packed", [
    pytest.param(251, 32, False, id="251-32"),
    pytest.param(256, 64, False, id="256-64"),
    pytest.param(100, 16, False, id="100-16"),
    pytest.param(130, 128, False, id="130-128"),
    pytest.param(1000, 32, False, id="1000-32"),
    pytest.param(1000, 64, False, id="1000-64"),
    pytest.param(1000, 32, True, id="1000-32-packed"),
    pytest.param(251, 64, True, id="251-64-packed")])
def test_attention_kernels_match_plain(card, dtype, causal, L, hd, packed):
    """`attn_fwd`, `attn_bwd_dkv` and `attn_bwd_dq` against the plain
    versions (O and lse; dq, dk, dv from the kernel's own O and lse), at
    ragged and aligned L (L=1000: several 128- and 64-row tiles each way),
    q, k, v also as strided views of one packed tensor, by the rule of
    `kernel_check.py` with the floor taken per row (`compare(rows=True)`);
    the launch counters move by one each; a second run repeats every
    output bit for bit."""
    from caduceus_tpu_torch.ops import attention

    before = (attention.fwd_launches, attention.bwd_dkv_launches,
              attention.bwd_dq_launches)
    pairs, again = _attn_case(dtype, 2, L, 3, hd, causal, seed=L + hd,
                              packed=packed)
    assert (attention.fwd_launches, attention.bwd_dkv_launches,
            attention.bwd_dq_launches) == tuple(b + 2 for b in before)
    for name, (k, p) in pairs.items():
        tol = TOL[torch.float32] if name == "lse" else TOL[dtype]
        stats = compare(k, p, tol, rows=True)
        assert stats["ok"], (name, stats)
    for name, a, b in zip(ATTN_NAMES, (k for k, _ in pairs.values()), again):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_step_through_the_kernels(card, dtype):
    """A 1-layer `MHA` forward and backward on the card (`_AttentionFn`:
    the three kernels) against autograd of the same layer over the plain
    attention on the card: output and every gradient by the kernels'
    rule; the kernels launched once each."""
    from caduceus_tpu_torch.models.hyena import MHA
    from caduceus_tpu_torch.ops import attention

    name = "float32" if dtype == torch.float32 else "bfloat16"
    layer = MHA(64, 4, dtype=name,
                generator=torch.Generator().manual_seed(3)).to("cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(2, 200, 64, generator=g, device="cuda")
    cot = torch.randn(2, 200, 64, generator=g, device="cuda").to(dtype)

    def step():
        for p in layer.parameters():
            p.grad = None
        xi = x.clone().requires_grad_(True)
        out = layer(xi)
        out.backward(cot)
        return [out.detach(), xi.grad] + [p.grad for p in layer.parameters()]

    before = attention.fwd_launches, attention.bwd_dq_launches
    got = step()
    assert (attention.fwd_launches, attention.bwd_dq_launches) == (
        before[0] + 1, before[1] + 1)

    def plain_fn(q, k, v, causal=True, sm_scale=None, use_kernel="auto"):
        o, _ = attention.attention_fwd_plain(q, k, v, causal,
                                             q.shape[-1] ** -0.5)
        return o

    import caduceus_tpu_torch.models.hyena as hy
    real = hy.mha_attention
    hy.mha_attention = plain_fn
    try:
        want = step()
    finally:
        hy.mha_attention = real
    for i, (a, b) in enumerate(zip(got, want)):
        stats = compare(a, b, TOL[dtype], rows=a.dim() > 1)
        assert stats["ok"], (i, stats)


def _rc_config(version, n_layer, dtype):
    """`configs/hg38_mlm.yaml` (v1) / `hg38_mlm_v2.yaml` (v2) at full
    width: RCPS, tied "add" BiMamba."""
    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    tok = CaduceusTokenizer()
    ssm = (SSMConfig(version=1, d_state=16, d_conv=4, expand=2)
           if version == 1 else
           SSMConfig(version=2, d_state=128, headdim=64, ngroups=1, d_conv=4,
                     expand=2, ssd_chunk_size=128, ssd_seg_chunks=8))
    return CaduceusConfig(
        d_model=256, n_layer=n_layer, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, bidirectional=True,
        bidirectional_strategy="add", bidirectional_weight_tie=True,
        rms_norm=True, residual_in_fp32=False, fused_add_norm=True,
        dtype=dtype, param_dtype="float32", ssm_cfg=ssm)


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("n_layer,dtype,L", [
    (2, "float32", 1000), (16, "float32", 16384), (16, "bfloat16", 131072)],
    ids=["small", "path-fp32", "path-bf16"])
def test_rc_equivariance_through_the_kernels(card, version, n_layer, dtype,
                                             L):
    """logits(RC(x)) equal logits(x) flipped in L and permuted by the
    complement map, through `bidir_scan_fwd` (#9, v1) or `ssd_fused_fwd`
    (#1, v2) at full width (random weights): fp32 by the kernels' fp32
    rule, at 2 layers and L=1000 (a ragged last chunk) and at 16 layers
    and L=16,384; bf16 at 16 layers and L=131,072 within 5e-2 of
    max|logit| (chip_smoke.py [convert])."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.ops import scan

    cfg = _rc_config(version, n_layer, dtype)
    model = CaduceusForMaskedLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(31)
    ).to("cuda")
    cm = cfg.padded_complement_map()
    comp = torch.tensor([cm[i] for i in range(cfg.padded_vocab_size)],
                        device="cuda")
    ids = torch.randint(7, 11, (1, L),
                        generator=torch.Generator().manual_seed(L)).cuda()
    before = scan.bidir_launches, ssd_batched.launches
    with torch.inference_mode():
        fwd = model(ids)
        rc = model(comp[ids.flip(-1)])
    torch.cuda.synchronize()
    launched = (scan.bidir_launches - before[0],
                ssd_batched.launches - before[1])
    assert launched == ((2 * n_layer, 0) if version == 1
                        else (0, 4 * n_layer))
    want = fwd.flip(1)[..., comp]
    assert bool(torch.isfinite(rc).all())
    if dtype == "float32":
        stats = compare(rc, want, TOL[torch.float32])
        assert stats["ok"], stats
    else:
        err = (rc - want).abs().max().item()
        assert err <= 5e-2 * want.abs().max().item(), err


# --- tensor parallelism: the kernels at one rank's shapes (a model axis of
# 2: half the channels or heads); the model's collectives are held on the
# card by chip_smoke.py [tp_train] and [cp_tp] (processes: threaded ranks
# share one autograd device thread, so their backwards would wait on each
# other)

# (kernel, output index): the elements (g, row, column) known to miss the
# elementwise limit at these inputs, ROADMAP.md queue 3 item 11: the CP
# entry's g_xBC at one B-column element, a cancelling sum of the heads'
# g_B shares (kernel 11.75, plain 12.125, float64 11.785: the kernel
# nearer). The test fails if another element misses or this one no longer
# does.
TP_KNOWN_MISSES = {("cp_entry", 3): [(0, 85676, 345)]}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["scan", "unfused", "cp_entry",
                                    "attention"])
def test_kernels_at_the_tensor_parallel_shapes(card, kernel):
    """Each kernel at one rank's shape of the tensor-parallel paths, bf16,
    against its plain version by the rule of kernel_check.py, and run
    twice on the same inputs: every output, gradients included, bit for
    bit the same. #9 + #8 at G=4, L=131072, 256 of v1's 512 channels; #2 +
    #4 at 4 of v2's 8 heads (G=4, L=131072); the CP entry of #1 / #3 at 4
    heads (G=2, L_loc=131072, edge_hist); #11 at 4 of the Hyena MHA's 8
    heads (G=2, L=65536, hd=32, causal, q / k / v views of one packed
    tensor). The CP entry's g_xBC may miss the rule only as ROADMAP.md
    queue 3 item 11 says and `TP_KNOWN_MISSES` registers."""
    if kernel == "scan":
        from caduceus_tpu_torch.ops import scan
        from caduceus_tpu_torch.ops.selective_scan import (selective_scan,
                                                           selective_scan_bwd)

        G, L, d, N = 4, 131072, 256, 16
        T = scan.KERNEL_CHUNK
        f, _, gyf, _ = _scan_inputs(torch.bfloat16, G=G, L=L, d=d, N=N,
                                    seed=90)
        r, _, gyr, _ = _scan_inputs(torch.bfloat16, G=G, L=L, d=d, N=N,
                                    seed=91)
        pa = (*f[:2], *f[3:5], *r[:2], *r[3:5], f[2], r[2], f[5], r[5],
              f[6], r[6])

        def run():
            yf, yr, cf, cr = scan.bidir_scan_fwd(*pa, save_carries=True)
            return (yf, cf, yr, cr) + scan.selective_scan_bwd_cuda(
                *f, gyf, cf, None, True, False, T)[:7]

        got = run()
        pf = selective_scan(*f, True, False, T, return_carries=True)
        pr = selective_scan(*r, True, True, T, return_carries=True)
        want = (*pf, *pr) + selective_scan_bwd(*f, gyf, got[1], None, True,
                                               False, T)[:7]
    elif kernel == "unfused":
        from caduceus_tpu_torch.ops.ssd import ssd_chunked, ssd_chunked_bwd

        x, dt, A, B, C, D, bias, h0 = _unfused_inputs(
            torch.bfloat16, G=4, L=131072, H=4, P=64, NG=1, N=128, seed=92)
        T = ssd_batched.KERNEL_CHUNK[torch.bfloat16]
        gy = torch.randn(x.shape, device="cuda").bfloat16()
        a = (x, dt, A, B, C, D, bias)

        def run():
            y, hN, car = ssd_batched.ssd_fwd(*a, True, False, T, h0, True)
            return (y, hN, car) + tuple(ssd_batched.ssd_bwd(
                *a, gy, car, None, True, False, T))

        got = run()
        fp = ssd_chunked(*a, True, False, T, h0, return_carries=True)
        want = tuple(fp) + tuple(ssd_chunked_bwd(*a, gy, got[2], None, True,
                                                 False, T))
    elif kernel == "cp_entry":
        inp = _cp_inputs(torch.bfloat16, "tp", seed=93)

        def run():
            return _cp_shard_pair(inp, False, inp["edge"])[0]

        got, want = _cp_shard_pair(inp, False, inp["edge"])
    else:
        pairs, again = _attn_case(torch.bfloat16, 2, 65536, 4, 32, True,
                                  seed=94, packed=True)
        got = tuple(k for k, _ in pairs.values())
        want = tuple(p for _, p in pairs.values())
        for name, (k, p) in pairs.items():
            tol = TOL[torch.float32] if name == "lse" else TOL[torch.bfloat16]
            stats = compare(k, p, tol, rows=True)
            assert stats["ok"], (name, stats)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        return
    for i, (k, p) in enumerate(zip(got, want)):
        assert k.shape == p.shape and k.dtype == p.dtype, i
        stats = compare(k, p, TOL[torch.bfloat16])
        if (kernel, i) in TP_KNOWN_MISSES:
            _hold_known_misses(inp, k, p, stats,
                               TP_KNOWN_MISSES[(kernel, i)])
            continue
        assert stats["ok"], (kernel, i, stats)
    first = [t.clone() for t in got]
    second = run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second)), kernel


def _hold_known_misses(inp, k, p, stats, known):
    """g_xBC of the CP entry against its plain version where some elements
    are known to miss the elementwise limit: rel_l2 within the rule, the
    elements over the limit exactly the ``known`` ones (a stale entry
    fails too), each in the B or C columns with the kernel (``k``) the
    nearer of the two to its float64 value."""
    tol = TOL[torch.bfloat16]
    assert stats["rel_l2"] <= tol.rel_l2, stats
    pa = p.float().abs()
    over = ((k.float() - p.float()).abs()
            - tol.rtol * pa - tol.atol * stats["mean_abs_ref"])
    misses = sorted(tuple(int(v) for v in e)
                    for e in (over > 0).nonzero().tolist())
    print(f"g_xBC: {len(misses)} elements over the limit: {misses[:20]}")
    H, P, NG, N = inp["dims"]
    assert len(misses) <= 20 and all(c >= H * P for _, _, c in misses), (
        "misses in the x columns or more than 20", misses[:20])
    nearer = []
    for g, r, c in misses:
        exact = (_exact_g_xBC_C if c >= H * P + NG * N
                 else _exact_g_xBC_B)(inp, g, r, c)
        kv, pv = float(k[g, r, c]), float(p[g, r, c])
        print(f"g_xBC[{g}, {r}, {c}]: kernel {kv!r}, plain {pv!r}, float64 "
              f"{exact!r}")
        nearer.append(abs(kv - exact) <= abs(pv - exact))
    assert all(nearer), ("the plain version nearer", misses, nearer)
    assert misses == sorted(known), ("misses", misses, "known", known)
