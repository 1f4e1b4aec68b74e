"""The port's CUDA kernels on the card: `ssd_fused_fwd` (with its carries)
and `ssd_fused_bwd` against their plain versions, the autograd Function
against finite differences, and the wrapper's refusals. Imports no JAX, so
it runs on the machine with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test needs a CUDA card and skips without one (the kernels have no CPU
mode; their arithmetic is held against JAX through the plain versions in
tests/test_torch_ssd.py). The rule and its tolerances are those of
chip_smoke.py, in `caduceus_tpu_torch/kernel_check.py`.
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
