"""The port's CUDA kernels on the card: `ssd_fused_fwd` (with its carries),
the unfused `ssd_fwd` and `ssd_fused_bwd` (its SiLU + conv adjoint
`ssd_conv_bwd` also alone), and the selective scan's
`selective_scan_fwd`, `bidir_scan_fwd` and `selective_scan_bwd`, against
their plain versions; the autograd Functions against finite differences; a
v1 model backward through the scan kernels; the prefill of both causal
families, card against CPU; and the wrappers' refusals. Imports no JAX, so
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
