"""The port's selective scan (`caduceus_tpu_torch/ops/selective_scan.py`,
`ops/scan.py`) against the JAX package, on the CPU.

The plain forward `selective_scan` is the plain version of the
`selective_scan_fwd` / `bidir_scan_fwd` CUDA kernels (TPU kernels #7 and
#9); it is held in fp32 at 1e-5 against the JAX oracle `selective_scan_ref`,
the XLA chunked `selective_scan` (h_init -> hN) and the TPU kernels run in
interpret mode. The explicit adjoint `selective_scan_bwd`, the plain
version of the `selective_scan_bwd` kernel (#8), is held against `jax.grad`
(1e-5 scale-normalized), against autograd through the plain forward, and
against the TPU backward kernel in interpret mode at the JAX tests' own
5e-3 scale-normalized (`tests/test_scan_pallas_bwd.py`): that kernel
stores its carries, h and dA in bf16 (`scan_pallas.py:318`, `:650-651`).
The paired backward (`bidir_scan_bwd`, TPU kernel #10, taken by
`_BidirScanFn` under ``CADUCEUS_BIDIR_BWD=1``) is held against the JAX
paired kernel `bidir_scan_bwd_impl` in interpret mode at the same 5e-3, and
against the default two-launch backward.
The same numpy inputs go to both sides. Shapes are tiny (G=2, L<=50,
d=16, N=4), chunks of 16 rows and segments of 2 chunks, so a ragged L,
several segments and the chunk chaining are all reached. The kernels
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caduceus_tpu.ops.scan_pallas import (
    selective_scan_pallas_bwd_impl,
    selective_scan_pallas_fwd_impl,
)
from caduceus_tpu.ops.scan_pallas_bidir import (
    bidir_scan_bwd_impl,
    bidir_scan_fwd_impl,
)
from caduceus_tpu.ops.selective_scan import selective_scan as jax_scan
from caduceus_tpu.ops.selective_scan import selective_scan_ref as jax_ref
from caduceus_tpu_torch.ops import scan
from caduceus_tpu_torch.ops import selective_scan as plain

T = 16
KEYS = ("u", "delta", "A", "B", "C", "D", "bias")
GRADS = ("u", "delta", "A", "B", "C", "D", "bias", "h0")


@pytest.fixture(autouse=True)
def two_chunk_segments(monkeypatch):
    monkeypatch.setattr(plain, "_SEG_ROWS", 2 * T)


def inputs(G=2, L=50, d=16, N=4, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return dict(u=f(G, L, d), delta=f(G, L, d, sc=0.5),
                A=-np.exp(f(d, N, sc=0.5)), B=f(G, L, N), C=f(G, L, N),
                D=f(d), bias=f(d, sc=0.1), h0=f(G, d, N),
                g_y=f(G, L, d), g_hN=f(G, d, N))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jit(fn, *args, **kw):
    """``fn(*args, **kw)`` run as one compiled program, the arrays among the
    arguments passed as its inputs and the rest fixed (eager dispatch of
    the interpret-mode kernels costs about twice the compile)."""
    pos = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]
    keys = [k for k, a in kw.items() if isinstance(a, np.ndarray)]

    def run(*arrays):
        a, k = list(args), dict(kw)
        for i, v in zip(pos, arrays):
            a[i] = v
        for n, v in zip(keys, arrays[len(pos):]):
            k[n] = v
        return fn(*a, **k)

    return jax.jit(run)(*[args[i] for i in pos], *[kw[k] for k in keys])


def _args(x):
    return [_t(x[k]) for k in KEYS]


def _tr(h):
    """(G, d, N) <-> the JAX kernels' (G, N, d)."""
    return np.swapaxes(np.asarray(h), 1, 2)


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_forward_matches_jax(reverse):
    """Ragged L (50 = 3 chunks + 2 rows), h_init -> hN, and the carries:
    the state entering each chunk in scan order."""
    x = inputs()
    u, dl, A, B, C, D, bias = _args(x)
    jx = [x[k] for k in ("u", "delta", "A", "B", "C")]
    y_ref = plain.selective_scan_ref(u, dl, A, B, C, D, bias, True, reverse)
    np.testing.assert_allclose(y_ref.numpy(), np.asarray(_jit(
        jax_ref, *jx, D=x["D"], delta_bias=x["bias"], delta_softplus=True,
        reverse=reverse)), rtol=0, atol=1e-5)
    y, hN, car = plain.selective_scan(u, dl, A, B, C, D, bias, True, reverse,
                                      T, _t(x["h0"]), True, True)
    yj, hj = _jit(jax_scan, *jx, D=x["D"], delta_bias=x["bias"],
                      delta_softplus=True, reverse=reverse, chunk_size=T,
                      h_init=x["h0"], return_final_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(hN.numpy(), np.asarray(hj), rtol=0, atol=1e-5)
    L = u.shape[1]
    assert car.shape == (2, 4, 16, 4)
    for c in range(car.shape[1]):
        rows = slice((c + 1) * T, L) if reverse else slice(0, c * T)
        want = _t(x["h0"])
        if rows.stop > rows.start:
            _, want = plain.selective_scan_ref(
                u[:, rows], dl[:, rows], A, B[:, rows], C[:, rows], D, bias,
                True, reverse, want, return_final_state=True)
        np.testing.assert_allclose(car[:, c].numpy(), want.numpy(), rtol=0,
                                   atol=1e-5, err_msg=f"carry {c}")


@functools.lru_cache(maxsize=None)
def jax_bidir():
    """The JAX paired kernels in interpret mode on `inputs(L=24)` (set f)
    and `inputs(L=24, seed=1)` (set r), one compile shared by the forward
    and the backward tests: #9's (yf, yr) and #10's 14 gradients of
    <yf, g_yf> + <yr, g_yr> from #9's own (bf16) carries."""
    x, xr = inputs(L=24), inputs(L=24, seed=1)

    @jax.jit
    def tpu(*a):
        yf, yr, carf, carr, Tj = bidir_scan_fwd_impl(
            *a[:14], True, T, 2, True, save_carries=True)
        return (yf, yr), bidir_scan_bwd_impl(*a, carf, carr, True, Tj, True)

    return tpu(*[s[k] for s in (x, xr) for k in ("u", "delta", "B", "C")],
               x["A"], xr["A"], x["D"], xr["D"], x["bias"], xr["bias"],
               x["g_y"], xr["g_y"])


def test_plain_forward_matches_tpu_kernels_interpret():
    """#7 (one direction, h_init -> hN) and #9 (two sets in one launch,
    the second right to left) in interpret mode."""
    x, xr = inputs(L=24), inputs(L=24, seed=1)
    for reverse in (False, True):
        y, hN = plain.selective_scan(*_args(x), True, reverse, T, _t(x["h0"]),
                                     return_final_state=True)
        yj, hj = _jit(selective_scan_pallas_fwd_impl, x["u"], x["delta"],
                      x["A"], x["B"], x["C"], x["D"], None, x["bias"], True,
                      reverse, T, 2, True, h_init=_tr(x["h0"]))
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5)
        np.testing.assert_allclose(hN.numpy(), _tr(hj), atol=1e-5)
    f, r = _args(x), _args(xr)
    yf, yr, _, _ = scan.bidir_scan_fwd(*f[:2], *f[3:5], *r[:2], *r[3:5],
                                       f[2], r[2], f[5], r[5], f[6], r[6],
                                       chunk_size=T)
    yfj, yrj = jax_bidir()[0]
    np.testing.assert_allclose(yf.numpy(), np.asarray(yfj), atol=1e-5)
    np.testing.assert_allclose(yr.numpy(), np.asarray(yrj), atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_adjoint_matches_jax_grad_and_autograd(reverse):
    """Loss <y, g_y> + <hN, g_hN>: jax.grad through the XLA chunked scan
    (it takes h_init and returns hN) and autograd through the plain
    forward, against `selective_scan_bwd` from the plain carries."""
    x = inputs()
    _, car = plain.selective_scan(*_args(x), True, reverse, T, _t(x["h0"]),
                                 return_carries=True)
    got = plain.selective_scan_bwd(*_args(x), _t(x["g_y"]), car,
                                   _t(x["g_hN"]), True, reverse, T)

    def loss(u, dl, A, B, C, D, bias, h0):
        y, h = jax_scan(u, dl, A, B, C, D=D, delta_bias=bias,
                        delta_softplus=True, reverse=reverse, chunk_size=T,
                        h_init=h0, return_final_state=True)
        return jnp.sum(y * x["g_y"]) + jnp.sum(h * x["g_hN"])

    want = jax.jit(jax.grad(loss, argnums=tuple(range(8))))(
        *[jnp.asarray(x[k]) for k in KEYS + ("h0",)])
    leaves = [_t(x[k]).clone().requires_grad_() for k in KEYS + ("h0",)]
    y, h = plain.selective_scan(*leaves[:7], True, reverse, T, leaves[7],
                                return_final_state=True)
    ((y * _t(x["g_y"])).sum() + (h * _t(x["g_hN"])).sum()).backward()
    for name, g, w, leaf in zip(GRADS, got, want, leaves):
        assert g.shape == leaf.shape, name
        _close(g.numpy(), w, 1e-5, f"jax.grad {name}")
        _close(g.numpy(), leaf.grad.numpy(), 1e-5, f"autograd {name}")


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_adjoint_matches_tpu_kernel_interpret(reverse):
    """The chained TPU backward (g_hN in, g_h0 out) from its own bf16
    carries, at its 5e-3 scale-normalized."""
    x = inputs(L=24, seed=2)
    _, car = plain.selective_scan(*_args(x), True, reverse, T, _t(x["h0"]),
                                 return_carries=True)
    got = plain.selective_scan_bwd(*_args(x), _t(x["g_y"]), car,
                                   _t(x["g_hN"]), True, reverse, T)
    @jax.jit
    def tpu(u, dl, A, B, C, D, bias, g_y, h0, g_hN):
        _, _, car_j, Tj = selective_scan_pallas_fwd_impl(
            u, dl, A, B, C, D, None, bias, True, reverse, T, 2, True,
            save_carries=True, h_init=h0)
        return selective_scan_pallas_bwd_impl(
            u, dl, A, B, C, D, bias, g_y, car_j, True, reverse, Tj, True,
            g_hN=g_hN)

    want = tpu(*[x[k] for k in KEYS], x["g_y"], _tr(x["h0"]),
               _tr(x["g_hN"]))
    want = list(want[:7]) + [_tr(want[7])]
    for name, g, w in zip(GRADS, got, want):
        _close(g.numpy(), w, 5e-3, f"tpu kernel {name}")


def test_wrappers_and_functions_run_the_plain_versions_on_cpu():
    """On CPU tensors the kernel wrappers are the plain versions and
    count no launch; the autograd Functions give the plain adjoint."""
    x = inputs(L=40, seed=3)
    counts = (scan.fwd_launches, scan.bidir_launches, scan.bwd_launches)
    args = _args(x)
    y, hN, car = scan.selective_scan_fwd(*args, True, True, T, _t(x["h0"]),
                                         save_carries=True)
    y_p, h_p, car_p = plain.selective_scan(*args, True, True, T, _t(x["h0"]),
                                           True, True)
    for a, b in ((y, y_p), (hN, h_p), (car, car_p)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    g = scan.selective_scan_bwd_cuda(*args, _t(x["g_y"]), car, _t(x["g_hN"]),
                                     True, True, T)
    leaves = [t.clone().requires_grad_() for t in args + [_t(x["h0"])]]
    y, h = scan.selective_scan_chained(*leaves, reverse=True, chunk_size=T)
    ((y * _t(x["g_y"])).sum() + (h * _t(x["g_hN"])).sum()).backward()
    for name, a, leaf in zip(GRADS, g, leaves):
        torch.testing.assert_close(leaf.grad, a, rtol=0, atol=0, msg=name)
    # the paired Function: two plain adjoints, set 2 reversed
    r = _args(inputs(L=40, seed=4))
    lf = [t.clone().requires_grad_() for t in args]
    lr = [t.clone().requires_grad_() for t in r]
    yf, yr = scan.bidir_selective_scan(*lf[:2], *lf[3:5], *lr[:2], *lr[3:5],
                                       lf[2], lr[2], lf[5], lr[5], lf[6],
                                       lr[6], chunk_size=T)
    ((yf * _t(x["g_y"])).sum() + (yr * 2 * _t(x["g_y"])).sum()).backward()
    for leaves_, a, rev, gy in ((lf, args, False, x["g_y"]),
                                (lr, r, True, 2 * x["g_y"])):
        _, c = plain.selective_scan(*a, True, rev, T, return_carries=True)
        want = plain.selective_scan_bwd(*a, _t(gy), c, None, True, rev, T)
        for name, leaf, w in zip(GRADS, leaves_, want):
            torch.testing.assert_close(leaf.grad, w, rtol=1e-6, atol=1e-6,
                                       msg=name)
    assert (scan.fwd_launches, scan.bidir_launches,
            scan.bwd_launches) == counts


def test_paired_backward_matches_tpu_kernel_and_two_launches(monkeypatch):
    """`_BidirScanFn` with ``CADUCEUS_BIDIR_BWD=1`` (read when the backward
    runs, as the JAX `_bwd` reads it): its 14 gradients against the JAX
    paired adjoint `bidir_scan_bwd_impl` in interpret mode, from the JAX
    forward's own (bf16) carries, at 5e-3 scale-normalized; and equal, on
    the CPU, to the default backward's two plain adjoints."""
    x, xr = inputs(L=24), inputs(L=24, seed=1)
    f, r = _args(x), _args(xr)
    grads = {}
    for env in ("1", "0"):
        monkeypatch.setenv("CADUCEUS_BIDIR_BWD", env)
        lf = [t.clone().requires_grad_() for t in f]
        lr = [t.clone().requires_grad_() for t in r]
        yf, yr = scan.bidir_selective_scan(
            *lf[:2], *lf[3:5], *lr[:2], *lr[3:5], lf[2], lr[2], lf[5], lr[5],
            lf[6], lr[6], chunk_size=T)
        ((yf * _t(x["g_y"])).sum() + (yr * _t(xr["g_y"])).sum()).backward()
        # the order of `bidir_scan_bwd_impl`'s outputs
        grads[env] = [lf[0], lf[1], lf[3], lf[4], lr[0], lr[1], lr[3], lr[4],
                      lf[2], lr[2], lf[5], lr[5], lf[6], lr[6]]
    for a, b in zip(grads["1"], grads["0"]):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    for i, (leaf, w) in enumerate(zip(grads["1"], jax_bidir()[1])):
        _close(leaf.grad.numpy(), w, 5e-3, f"paired TPU kernel output {i}")


@pytest.fixture
def one_thread():
    """One intra-op thread: the tiny ops below would otherwise wait on a
    thread pool shared with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runs_case(reverse, L, N, drop_run=None, seed=5):
    """The kernels' decomposition (`selective_scan_runs`, `_runs_bwd`: runs
    of 4 rows, 4 runs a chunk of T) and the serial plain versions on the
    same inputs, h_init and g_hN nonzero: ((y, hN, carries) + 8 gradients)
    of each."""
    x = inputs(L=L, d=8, N=N, seed=seed)
    a = _args(x)
    h0, gy, ghN = _t(x["h0"]), _t(x["g_y"]), _t(x["g_hN"])
    serial = plain.selective_scan(*a, True, reverse, T, h0, True, True)
    runs = plain.selective_scan_runs(*a, True, reverse, T, h0, 4,
                                     drop_run=drop_run)
    car = serial[2]
    serial += plain.selective_scan_bwd(*a, gy, car, ghN, True, reverse, T)
    runs += plain.selective_scan_runs_bwd(*a, gy, car, ghN, True, reverse, T,
                                          4, drop_run=drop_run)
    return runs, serial


OUT_NAMES = ("y", "hN", "carries") + GRADS


@pytest.mark.parametrize("reverse,L,N", [(False, 50, 8), (True, 50, 16),
                                         (False, 3, 16), (True, 10, 8)])
def test_runs_decomposition_equals_serial(one_thread, reverse, L, N):
    """Ragged L (50 = 3 chunks + 2 rows), L shorter than a chunk (10) and
    than a run (3), both directions, N = 8 and 16: every output of the
    forward and the adjoint at 1e-5 of its largest element (fp32)."""
    runs, serial = _runs_case(reverse, L, N)
    for name, got, want in zip(OUT_NAMES, runs, serial):
        assert got.shape == want.shape, name
        _close(got.numpy(), want.numpy(), 1e-5, name)


@pytest.mark.parametrize("reverse", [False, True])
def test_runs_decomposition_dropped_state_fails(one_thread, reverse):
    """Run 1's incoming state (lam in the adjoint) taken as 0, the kernels'
    planted fault: y and the adjoint's outputs leave the tolerance."""
    runs, serial = _runs_case(reverse, 50, 8, drop_run=1)
    for name in ("y", "u", "delta", "A"):
        i = OUT_NAMES.index(name)
        with pytest.raises(AssertionError):
            _close(runs[i].numpy(), serial[i].numpy(), 1e-5, name)


@functools.lru_cache(maxsize=None)
def jax_gated(reverse):
    """JAX's XLA `selective_scan(z=...)` on `inputs(seed=6)` with a gate z,
    and `jax.grad` of <y, g_y> in the nine inputs (z included)."""
    x = inputs(seed=6)
    z = np.random.default_rng(7).standard_normal(x["u"].shape).astype(
        np.float32)

    def fwd(u, dl, A, B, C, D, z, bias):
        return jax_scan(u, dl, A, B, C, D=D, z=z, delta_bias=bias,
                        delta_softplus=True, reverse=reverse, chunk_size=T)

    def loss(*a):
        return jnp.sum(fwd(*a) * x["g_y"])

    args = [x[k] for k in ("u", "delta", "A", "B", "C", "D")] + [z, x["bias"]]
    y, g = jax.jit(lambda *a: (fwd(*a), jax.grad(
        loss, argnums=tuple(range(8)))(*a)))(*args)
    return x, z, np.asarray(y), [np.asarray(t) for t in g]


@pytest.mark.parametrize("reverse", [False, True])
def test_gated_scan_matches_jax(one_thread, reverse):
    """The SiLU(z) gate (#7's ``has_z``): the plain forward and the
    differentiable one-direction entry `selective_scan_gated` against JAX's
    XLA `selective_scan(z=...)`, and the entry's gradients (the ungated
    Function's adjoint under the PyTorch gate) against `jax.grad`, all at
    1e-5 of the largest element (fp32)."""
    x, z, y_want, g_want = jax_gated(reverse)
    a = _args(x)
    y = plain.selective_scan(*a, True, reverse, T, z=_t(z))
    _close(y.numpy(), y_want, 1e-5, "plain gated y")
    names = ("u", "delta", "A", "B", "C", "D", "z", "bias")
    vals = dict(zip(KEYS, a), z=_t(z))
    leaves = {k: vals[k].clone().requires_grad_() for k in names}
    y = scan.selective_scan_gated(
        leaves["u"], leaves["delta"], leaves["A"], leaves["B"], leaves["C"],
        leaves["D"], leaves["z"], leaves["bias"], True, reverse, T)
    _close(y.detach().numpy(), y_want, 1e-5, "gated entry y")
    with torch.no_grad():
        y_ng = scan.selective_scan_gated(*a[:6], _t(z), a[6], True, reverse, T)
    _close(y_ng.numpy(), y_want, 1e-5, "gated entry y without grad")
    (y * _t(x["g_y"])).sum().backward()
    for name, w in zip(names, g_want):
        _close(leaves[name].grad.numpy(), w, 1e-5, f"jax.grad {name}")


@pytest.mark.parametrize("reverse", [False, True])
def test_gated_scan_bf16_under_grad_matches_plain(one_thread, reverse):
    """In bf16, `selective_scan_gated` under grad rounds y before the
    PyTorch gate and after it, the call without grad once: both outputs
    held against the plain gated forward by kernel_check's bf16 rule, and
    the gradients are finite."""
    from caduceus_tpu_torch.kernel_check import TOL, compare

    x = inputs(seed=8)
    a = [t.to(torch.bfloat16) if t.dim() == 3 else t for t in _args(x)]
    z = torch.randn(a[0].shape, generator=torch.Generator().manual_seed(9))
    z = z.to(torch.bfloat16)
    want = plain.selective_scan(*a, True, reverse, T, z=z)
    u = a[0].clone().requires_grad_()
    y = scan.selective_scan_gated(u, *a[1:6], z, a[6], True, reverse, T)
    with torch.no_grad():
        y_ng = scan.selective_scan_gated(*a[:6], z, a[6], True, reverse, T)
    for what, got in (("under grad", y), ("without grad", y_ng)):
        assert got.dtype == torch.bfloat16, what
        stats = compare(got.detach(), want, TOL[torch.bfloat16])
        assert stats["ok"], (what, stats)
    y.float().sum().backward()
    assert torch.isfinite(u.grad.float()).all()
