"""The port's ops (`caduceus_tpu_torch/ops`) against the JAX package, on the CPU.

`ssd_chunked_fused` is the plain version of the `ssd_fused_fwd` CUDA kernel;
it is held against the JAX TPU kernel run in interpret mode
(`ssd_pallas_batched_fused(..., interpret=True)`) and against the XLA
chunked form (`ssd_chunked(conv_w=..., dims=...)`); tolerance 1e-4, as in
tests/test_ssd_pallas_batched.py. `ssd_chunked_fused_bwd`, the plain
version of the `ssd_fused_bwd` kernels, is held against the VJP of the
same interpret-mode TPU kernels (2e-5 scale-normalized, the JAX package's
own gradient tolerance). The same numpy inputs go to both sides,
in fp32. `ssd_chunked`, the plain version of the unfused `ssd_fwd` kernel
(the prefill's SSD), is held against the JAX TPU kernel #2 in interpret mode
(`ssd_pallas_batched_chained(..., interpret=True)`) and against the XLA
`ssd_chunked`, 1e-4 as the fused form; `ssd_step` against the JAX
`ssd_step` and against `ssd_chunked`; under grad the CPU wrapper
`ssd_batched_chained` gives the gradients of the explicit plain adjoint
`ssd_chunked_bwd` (held against JAX in tests/test_torch_ssd_head.py). The
kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).

The kernels' chunk-parallel decomposition (`segment_states` /
`segment_lambdas`, the pre-passes; `combine_segments`; each segment's walk
from its entry state: ``segments=S`` of the plain versions) is held,
torch only, to the serial plain versions, forward and adjoint, by the rule
and tolerances the kernels are held to (`kernel_check.py`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caduceus_tpu.ops.conv import causal_conv1d as jax_conv
from caduceus_tpu.ops.norms import add_norm as jax_add_norm
from caduceus_tpu.ops.norms import layer_norm as jax_layer_norm
from caduceus_tpu.ops.ssd import ssd_chunked, ssd_ref as jax_ssd_ref
from caduceus_tpu.ops.ssd import ssd_step as jax_ssd_step
from caduceus_tpu.ops.ssd_pallas_batched import (
    ssd_pallas_batched_chained,
    ssd_pallas_batched_fused,
)
from caduceus_tpu_torch.ops import ssd_batched
from caduceus_tpu_torch.ops.conv import causal_conv1d
from caduceus_tpu_torch.ops.norms import add_norm, layer_norm
from caduceus_tpu_torch.ops.ssd import ssd_chunked as port_ssd_chunked
from caduceus_tpu_torch.ops.ssd import (
    ssd_chunked_bwd,
    ssd_chunked_fused,
    ssd_chunked_fused_bwd,
    ssd_ref,
    ssd_step,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def fused_inputs(G=2, L=100, H=4, P=8, NG=2, N=16, K=4, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    Wc = H * P + 2 * NG * N
    return dict(xBC=f(G, L, Wc), dt=f(G, L, H, sc=0.5),
                A=-np.exp(f(H, sc=0.5)), conv_w=f(K, Wc, sc=0.5),
                conv_b=f(Wc, sc=0.1), D=f(H), dt_bias=f(H, sc=0.1),
                h_init=f(G, H, N, P), dims=(H, P, NG, N))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port(inp, reverse, chunk):
    return ssd_chunked_fused(
        _t(inp["xBC"]), _t(inp["dt"]), _t(inp["A"]), _t(inp["conv_w"]),
        _t(inp["conv_b"]), _t(inp["D"]), _t(inp["dt_bias"]),
        dims=inp["dims"], dt_softplus=True, reverse=reverse,
        chunk_size=chunk, h_init=_t(inp["h_init"]), return_final_state=True)


GRAD_NAMES = ("xBC", "dt", "A", "conv_w", "conv_b", "D", "dt_bias", "h_init")


def _cotangents(inp):
    G, L = inp["xBC"].shape[:2]
    H, P, _, N = inp["dims"]
    rng = np.random.default_rng(7)
    return (rng.standard_normal((G, L, H, P)).astype(np.float32),
            rng.standard_normal((G, H, N, P)).astype(np.float32))


FWD_CASES = [(False, 2), (True, 2), (True, 1)]    # (reverse, NG)
BWD_CASES = [(False, 2), (True, 2), (False, 1)]


@functools.lru_cache(maxsize=None)
def jax_fused(reverse, NG):
    """The JAX references of `fused_inputs(NG=NG)`, one jit shared by the
    forward and the backward tests of a case: the TPU kernels in interpret
    mode (y, hN, and for a backward case the VJP of <y, g_y> + <hN, g_hN>
    in all eight inputs; one chunk per grid step, as the kernels' in-kernel
    chunk loop is unrolled when traced) and, for a forward case, the XLA
    chunked form (y, hN); None for what the case's tests do not read."""
    inp = fused_inputs(NG=NG)
    dims = inp["dims"]
    fwd, bwd = (reverse, NG) in FWD_CASES, (reverse, NG) in BWD_CASES

    @jax.jit
    def run(*a):
        def pal(*v):
            return ssd_pallas_batched_fused(
                v[0], v[1], v[2], v[3], conv_b=v[4], D=v[5], dt_bias=v[6],
                dims=dims, dt_softplus=True, reverse=reverse, chunk_size=16,
                interpret=True, h_init=v[7], return_final_state=True,
                seg_chunks=1)

        (y, h), pull = jax.vjp(pal, *a) if bwd else (pal(*a), None)
        xla = ssd_chunked(
            a[0], a[1], a[2], None, None, D=a[5], dt_bias=a[6],
            dt_softplus=True, reverse=reverse, chunk_size=16, h_init=a[7],
            return_final_state=True, conv_w=a[3], conv_b=a[4],
            dims=dims) if fwd else None
        cot = tuple(map(jnp.asarray, _cotangents(inp)))
        grads = pull(cot) if bwd else None
        return (y, h), xla, grads

    return run(*(jnp.asarray(inp[n]) for n in GRAD_NAMES))


@pytest.mark.parametrize("reverse,NG", FWD_CASES)
def test_fused_plain_matches_jax_kernel_and_xla(reverse, NG):
    inp = fused_inputs(NG=NG)
    (y_pal, h_pal), (y_xla, h_xla), _ = jax_fused(reverse, NG)
    # T=16 as the JAX side; T=64 (the kernel's chunk: one ragged chunk at
    # L=100) must give the same function
    for chunk in (16, 64):
        y, h = _port(inp, reverse, chunk)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_pal), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_pal), **TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_xla), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_xla), **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_ssd_ref_matches_jax_and_fused_form(reverse):
    inp = fused_inputs(L=40)
    H, P, NG, N = inp["dims"]
    xc = causal_conv1d(_t(inp["xBC"]), _t(inp["conv_w"]), _t(inp["conv_b"]),
                       reverse=reverse)
    G, L = xc.shape[:2]
    x = xc[..., :H * P].reshape(G, L, H, P)
    B = xc[..., H * P:H * P + NG * N].reshape(G, L, NG, N)
    C = xc[..., H * P + NG * N:].reshape(G, L, NG, N)
    args = [x, _t(inp["dt"]), _t(inp["A"]), B, C, _t(inp["D"]),
            _t(inp["dt_bias"])]
    y, h = ssd_ref(*args, dt_softplus=True, reverse=reverse,
                   h_init=_t(inp["h_init"]), return_final_state=True)
    y_j, h_j = jax.jit(lambda *a: jax_ssd_ref(
        *a[:7], dt_softplus=True, reverse=reverse, h_init=a[7],
        return_final_state=True))(*(jnp.asarray(a.numpy()) for a in args),
                                  jnp.asarray(inp["h_init"]))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **TOL)
    y_f, h_f = _port(inp, reverse, 16)
    np.testing.assert_allclose(y_f.numpy(), y.numpy(), **TOL)
    np.testing.assert_allclose(h_f.numpy(), h.numpy(), **TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("activation", ["silu", None])
def test_causal_conv1d_matches_jax(reverse, activation):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    got = causal_conv1d(_t(x), _t(w), _t(b), activation, reverse)
    want = jax_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                    activation, reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("use_rms", [True, False])
@pytest.mark.parametrize("residual_in_fp32", [True, False])
def test_add_norm_matches_jax(use_rms, residual_in_fp32):
    rng = np.random.default_rng(4)
    x, res = (rng.standard_normal((2, 5, 8)).astype(np.float32)
              for _ in range(2))
    w, b = (rng.standard_normal(8).astype(np.float32) for _ in range(2))
    for r in (None, res):
        got = add_norm(_t(x), _t(w), _t(b), None if r is None else _t(r),
                       use_rms=use_rms, residual_in_fp32=residual_in_fp32)
        want = jax_add_norm(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if r is None else jnp.asarray(r), use_rms=use_rms,
            residual_in_fp32=residual_in_fp32)
        for g, wv in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-5,
                                       atol=1e-5)
    np.testing.assert_allclose(
        layer_norm(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b))), rtol=1e-5, atol=1e-5)


def test_wrapper_runs_plain_version_on_cpu():
    inp = fused_inputs(L=70)
    before = ssd_batched.launches
    args = (_t(inp["xBC"]), _t(inp["dt"]), _t(inp["A"]), _t(inp["conv_w"]))
    kw = dict(conv_b=_t(inp["conv_b"]), D=_t(inp["D"]),
              dt_bias=_t(inp["dt_bias"]), dims=inp["dims"], dt_softplus=True,
              h_init=_t(inp["h_init"]), return_final_state=True)
    y, h = ssd_batched.ssd_batched_fused(*args, **kw)
    y_p, h_p = ssd_chunked_fused(
        *args, chunk_size=ssd_batched.KERNEL_CHUNK[torch.float32], **kw)
    assert torch.equal(y, y_p) and torch.equal(h, h_p)
    assert ssd_batched.launches == before  # no kernel on a CPU tensor


def test_wrapper_rejects_bad_shapes():
    inp = fused_inputs()
    args = [_t(inp["xBC"]), _t(inp["dt"]), _t(inp["A"]), _t(inp["conv_w"])]
    with pytest.raises(ValueError):
        ssd_batched.ssd_batched_fused(*args, dims=(4, 8, 2, 8))
    with pytest.raises(ValueError):
        ssd_batched.ssd_batched_fused(args[0], args[1][:, :-1], *args[2:],
                                      dims=inp["dims"])
    with pytest.raises(ValueError):
        ssd_batched.ssd_batched_fused(*args)


@pytest.mark.parametrize("reverse,NG", BWD_CASES)
def test_fused_bwd_plain_matches_jax_kernel_and_autograd(reverse, NG):
    """`ssd_chunked_fused_bwd` (the plain version of the backward kernel)
    against jax.grad through the TPU kernels in interpret mode, and against
    autograd through `ssd_chunked_fused`: all eight gradients, loss on both
    y and hN, nonzero h_init; 2e-5 scale-normalized, as
    tests/test_ssd_pallas_batched.py holds the JAX kernels."""
    inp = fused_inputs(NG=NG)
    dims = inp["dims"]
    gy, ghN = _cotangents(inp)
    vals = [inp[n] for n in GRAD_NAMES]
    want = jax_fused(reverse, NG)[2]

    t = [_t(v) for v in vals]
    _, _, car = ssd_chunked_fused(
        *t[:7], dims=dims, dt_softplus=True, reverse=reverse, chunk_size=16,
        h_init=t[7], return_carries=True)
    got = ssd_chunked_fused_bwd(*t[:7], _t(gy), car, _t(ghN), dims,
                                dt_softplus=True, reverse=reverse,
                                chunk_size=16)

    leaves = [v.clone().requires_grad_() for v in t]
    y, h = ssd_chunked_fused(
        *leaves[:7], dims=dims, dt_softplus=True, reverse=reverse,
        chunk_size=16, h_init=leaves[7], return_final_state=True)
    ((y * _t(gy)).sum() + (h * _t(ghN)).sum()).backward()

    for name, g, w, leaf in zip(GRAD_NAMES, got, want, leaves):
        w = np.asarray(w)
        s = float(np.abs(w).max()) + 1e-9
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy() / s, w / s, atol=2e-5,
                                   err_msg=f"vs JAX: {name}")
        np.testing.assert_allclose(g.numpy() / s, leaf.grad.numpy() / s,
                                   atol=2e-5, err_msg=f"vs autograd: {name}")


def test_fused_bwd_wrapper_runs_plain_version_on_cpu():
    inp = fused_inputs(L=70)
    t = {k: (_t(v) if k != "dims" else v) for k, v in inp.items()}
    args = (t["xBC"], t["dt"], t["A"], t["conv_w"], t["conv_b"], t["D"],
            t["dt_bias"])
    T = ssd_batched.KERNEL_CHUNK[torch.float32]
    _, _, car = ssd_chunked_fused(*args, dims=inp["dims"], dt_softplus=True,
                                  chunk_size=T, h_init=t["h_init"],
                                  return_carries=True)
    gy = torch.randn(*t["xBC"].shape[:2], *inp["dims"][:2],
                     generator=torch.Generator().manual_seed(0))
    before = (ssd_batched.bwd_launches, ssd_batched.conv_bwd_launches)
    got = ssd_batched.ssd_fused_bwd(*args, gy, car, None, inp["dims"], True)
    want = ssd_chunked_fused_bwd(*args, gy, car, None, inp["dims"], True,
                                 chunk_size=T)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (ssd_batched.bwd_launches, ssd_batched.conv_bwd_launches) == before


def unfused_inputs(G=2, L=100, H=4, P=8, NG=2, N=16, seed=1):
    """Post-conv x (G, L, H, P), B and C (G, L, NG, N) as column views of
    one (G, L, 8 + H·P + 2·NG·N) tensor, as the prefill gives them, with dt,
    the per-head parameters and h_init."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    wide = _t(f(G, L, 8 + H * P + 2 * NG * N))
    x = wide[..., 8:8 + H * P].reshape(G, L, H, P)
    B = wide[..., 8 + H * P:8 + H * P + NG * N].reshape(G, L, NG, N)
    C = wide[..., 8 + H * P + NG * N:].reshape(G, L, NG, N)
    return (x, _t(f(G, L, H, sc=0.5)), _t(-np.exp(f(H, sc=0.5))), B, C,
            _t(f(H)), _t(f(H, sc=0.1)), _t(f(G, H, N, P)))


@pytest.mark.parametrize("reverse,NG", [(False, 2), (True, 2), (True, 1)])
def test_ssd_chunked_matches_jax_kernel_and_xla(reverse, NG):
    """The plain version of `ssd_fwd` against the TPU kernel #2 in
    interpret mode and the XLA chunked form, h_init -> hN; at T = 16 as the
    JAX side, and at the kernel's T (one ragged chunk at L = 100)."""
    x, dt, A, B, C, D, bias, h0 = unfused_inputs(NG=NG)
    j = [jnp.asarray(t.numpy()) for t in (x, dt, A, B, C, D, bias, h0)]

    @jax.jit
    def run(*j):
        return (ssd_pallas_batched_chained(
                    *j, dt_softplus=True, reverse=reverse, chunk_size=16,
                    interpret=True, seg_chunks=2),
                ssd_chunked(*j[:5], D=j[5], dt_bias=j[6], dt_softplus=True,
                            reverse=reverse, chunk_size=16, h_init=j[7],
                            return_final_state=True))

    (y_pal, h_pal), (y_xla, h_xla) = run(*j)
    for chunk in (16, ssd_batched.KERNEL_CHUNK[torch.float32], 64):
        y, h = port_ssd_chunked(x, dt, A, B, C, D, bias, True, reverse,
                                chunk, h0, return_final_state=True)
        for got, want in ((y, y_pal), (h, h_pal), (y, y_xla), (h, h_xla)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssd_chunked_equals_fused_form_on_the_conv_output():
    inp = fused_inputs(L=70)
    H, P, NG, N = inp["dims"]
    xc = causal_conv1d(_t(inp["xBC"]), _t(inp["conv_w"]), _t(inp["conv_b"]))
    G, L = xc.shape[:2]
    args = (_t(inp["dt"]), _t(inp["A"]))
    y, h = port_ssd_chunked(
        xc[..., :H * P].reshape(G, L, H, P), *args,
        xc[..., H * P:H * P + NG * N].reshape(G, L, NG, N),
        xc[..., H * P + NG * N:].reshape(G, L, NG, N), _t(inp["D"]),
        _t(inp["dt_bias"]), True, False, 16, _t(inp["h_init"]),
        return_final_state=True)
    y_f, h_f = _port(inp, False, 16)
    np.testing.assert_allclose(y.numpy(), y_f.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h_f.numpy(), **TOL)


def test_ssd_step_matches_jax_and_the_chunked_form():
    """`ssd_step` against the JAX `ssd_step` (1e-6) and, stepped over
    L = 20 rows, against `ssd_chunked` (1e-4)."""
    x, dt, A, B, C, D, bias, h0 = unfused_inputs(L=20)
    h_j, y_j = jax_ssd_step(*(jnp.asarray(t.numpy()) for t in (
        h0, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D, bias)),
        dt_softplus=True)
    h, ys = h0, []
    for t in range(20):
        h, y_t = ssd_step(h, x[:, t], dt[:, t], A, B[:, t], C[:, t], D, bias,
                          True)
        ys.append(y_t)
        if t == 0:
            np.testing.assert_allclose(h.numpy(), np.asarray(h_j), 1e-6, 1e-6)
            np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), 1e-6,
                                       1e-6)
    y_c, h_c = port_ssd_chunked(x, dt, A, B, C, D, bias, True, False, 16, h0,
                                return_final_state=True)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_c.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), h_c.numpy(), **TOL)


def test_chained_wrapper_runs_plain_version_on_cpu_and_refuses_grad():
    """On CPU tensors `ssd_batched_chained` is the plain `ssd_chunked` and
    launches nothing. Under grad (it no longer refuses it) autograd through
    the plain version gives the explicit plain adjoint `ssd_chunked_bwd`'s
    eight gradients, g_h0 among them, within 1e-5 of each one's largest
    element (two fp32 sums in other orders). Bad shapes still raise."""
    x, dt, A, B, C, D, bias, h0 = unfused_inputs(L=70)
    T = ssd_batched.KERNEL_CHUNK[torch.float32]
    before = (ssd_batched.unfused_launches, ssd_batched.unfused_bwd_launches)
    y, h = ssd_batched.ssd_batched_chained(x, dt, A, B, C, D, bias, h0)
    y_p, h_p, car = port_ssd_chunked(x, dt, A, B, C, D, bias, True, False, T,
                                     h0, return_carries=True)
    assert torch.equal(y, y_p) and torch.equal(h, h_p)
    gen = torch.Generator().manual_seed(1)
    gy, ghN = torch.randn(y.shape, generator=gen), torch.randn(
        h.shape, generator=gen)
    want = ssd_chunked_bwd(x, dt, A, B, C, D, bias, gy, car, ghN, True,
                           False, T)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C, D, bias,
                                                    h0)]
    y, h = ssd_batched.ssd_batched_chained(*leaves)
    ((y * gy).sum() + (h * ghN).sum()).backward()
    for leaf, w in zip(leaves, want):
        assert leaf.grad.shape == w.shape
        torch.testing.assert_close(leaf.grad / w.abs().max(),
                                   w / w.abs().max(), rtol=0, atol=1e-5)
    assert (ssd_batched.unfused_launches,
            ssd_batched.unfused_bwd_launches) == before  # no kernel
    with pytest.raises(ValueError):
        ssd_batched.ssd_batched_chained(x, dt[:, :-1], A, B, C)


# -- the chunk-parallel decomposition (torch only) --------------------------


@pytest.fixture
def one_thread():
    """One intra-op thread for these tiny tensors: with the default thread
    per core, each op's thread pool waits on the other test workers' load,
    which made these tests ~40x slower in the whole suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _segment_inputs(dtype, NG, L, seed, H=4, P=16, N=16, K=4, G=2):
    """Inputs whose state outlives a segment: dt near 0.05 and |A| near
    0.2, so a row decays the state by ~1% and the state entering a segment
    moves its rows (a dropped one fails the checks below)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(*s, generator=g) * sc
    Wc = H * P + 2 * NG * N
    return dict(xBC=r(G, L, Wc).to(dtype), dt=r(G, L, H, sc=0.5).to(dtype),
                A=-0.2 * torch.exp(r(H, sc=0.5)), conv_w=r(K, Wc, sc=0.5),
                conv_b=r(Wc, sc=0.1), D=r(H), dt_bias=r(H, sc=0.1) - 3.0,
                h_init=r(G, H, N, P), g_y=r(G, L, H, P).to(dtype),
                g_hN=r(G, H, N, P), dims=(H, P, NG, N))


def _hold(got, want, dtype):
    from caduceus_tpu_torch.kernel_check import TOL as KTOL, compare

    return all(compare(g, w, KTOL[dtype])["ok"] for g, w in zip(got, want))


def _segmented_pairs(inp, reverse, S):
    """(serial, segmented) outputs of the four plain functions: the fused
    forward (y, hN, carries) and adjoint, the unfused forward and adjoint
    on the fused form's conv output."""
    from caduceus_tpu_torch.ops.ssd import _conv_silu_rows, ssd_adjoint_xc

    dtype = inp["xBC"].dtype
    T = ssd_batched.KERNEL_CHUNK[dtype]
    H, P, NG, N = inp["dims"]
    G, L, _ = inp["xBC"].shape
    a7 = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
          inp["D"], inp["dt_bias"])
    kw = dict(dims=inp["dims"], dt_softplus=True, reverse=reverse,
              chunk_size=T, h_init=inp["h_init"], return_carries=True)
    out = {}
    fwd = [ssd_chunked_fused(*a7, segments=s, **kw) for s in (None, S)]
    out["fused fwd"] = fwd
    car = fwd[0][2]
    out["fused adjoint"] = [ssd_adjoint_xc(
        *a7, inp["g_y"], car, inp["g_hN"], inp["dims"], True, reverse, T,
        segments=s) for s in (None, S)]
    xc = _conv_silu_rows(inp["xBC"], inp["conv_w"], inp["conv_b"], 0, L,
                         reverse).to(dtype)
    x = xc[..., :H * P].reshape(G, L, H, P)
    B = xc[..., H * P:H * P + NG * N].reshape(G, L, NG, N)
    C = xc[..., H * P + NG * N:].reshape(G, L, NG, N)
    u = (x, inp["dt"], inp["A"], B, C, inp["D"], inp["dt_bias"])
    ufwd = [port_ssd_chunked(*u, True, reverse, T, inp["h_init"],
                             return_carries=True, segments=s)
            for s in (None, S)]
    out["unfused fwd"] = ufwd
    out["unfused adjoint"] = [ssd_chunked_bwd(
        *u, inp["g_y"], ufwd[0][2], inp["g_hN"], True, reverse, T,
        segments=s) for s in (None, S)]
    return out


@pytest.mark.parametrize("NG", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segmented_decomposition_equals_serial(one_thread, dtype, reverse, NG):
    """Pre-pass + combine + per-segment walk against the serial walk, for
    the fused and the unfused forms, forward (y, hN, carries) and adjoint
    (every gradient, g_h0 among them), from a nonzero h_init and g_hN, at a
    ragged L (200 rows: the last chunk part-filled) cut into 3 segments (4
    of 7 chunks in fp32, 2 of 4 in bf16)."""
    inp = _segment_inputs(dtype, NG, 200, seed=10 + NG + 2 * reverse)
    for name, (serial, seg) in _segmented_pairs(inp, reverse, 3).items():
        assert _hold(seg, serial, dtype), name


def test_segmented_decomposition_short_sequence_and_dropped_state(one_thread):
    """L shorter than one segment (one chunk for 4 segments) gives the
    serial result; and a segment's incoming state dropped in the combine
    (forward and adjoint) fails the check, so the tests above see it."""
    from caduceus_tpu_torch.ops import ssd

    inp = _segment_inputs(torch.float32, 2, 20, seed=20)
    for name, (serial, seg) in _segmented_pairs(inp, False, 4).items():
        assert _hold(seg, serial, torch.float32), name
    inp = _segment_inputs(torch.float32, 2, 200, seed=21)
    real = ssd.combine_segments

    def dropped(states, sums, h0, scan_reverse):
        entries, last = real(states, sums, h0, scan_reverse)
        entries = entries.clone()
        entries[:, :, 1] = 0
        return entries, last

    try:
        ssd.combine_segments = dropped
        for reverse in (False, True):
            pairs = _segmented_pairs(inp, reverse, 3)
            for name in ("fused fwd", "fused adjoint", "unfused fwd",
                         "unfused adjoint"):
                assert not _hold(pairs[name][1], pairs[name][0],
                                 torch.float32), (name, reverse)
    finally:
        ssd.combine_segments = real


# -- the conv adjoint's tiles (torch only) ----------------------------------


def _conv_adjoint_inputs(G, L, Wc, K, seed):
    """fp32 g_xc, xBC, conv_w, conv_b: Wc not a multiple of the kernel's 4
    columns per lane."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(*s, generator=g) * sc
    return r(G, L, Wc), r(G, L, Wc), r(K, Wc, sc=0.5), r(Wc, sc=0.1)


def _conv_adjoint_close(got, want):
    """1e-6 relative in fp32, each output against its own largest value."""
    return all(torch.allclose(a, b, rtol=1e-6,
                              atol=1e-6 * float(b.abs().max()))
               for a, b in zip(got, want))


# (K, reverse, L, tile rows): 150 rows in ragged 24-row tiles (7 per batch
# row, 14 partials in 8 ranges), and 1,100 rows in the kernel's own tiles
CONV_TILE_CASES = [(K, rev, 150, 24) for K in (2, 4) for rev in (False, True)]
CONV_TILE_CASES += [(3, False, 1100, None), (1, True, 1100, None)]


@pytest.mark.parametrize("K,reverse,L,tile", CONV_TILE_CASES)
def test_conv_adjoint_tiles_equal_serial(one_thread, K, reverse, L, tile):
    """`conv_silu_bwd_tiled` (the `ssd_conv_bwd` kernel's row tiles, halos
    and fixed-order partial sums) against the serial `conv_silu_bwd`, which
    test_fused_bwd_plain_matches_jax_kernel_and_autograd holds to the JAX
    kernel: g_xBC, g_conv_w and g_conv_b within 1e-6 relative (fp32)."""
    from caduceus_tpu_torch.ops.ssd import (CONV_TILE_ROWS, conv_silu_bwd,
                                            conv_silu_bwd_tiled)

    g_xc, xBC, w, b = _conv_adjoint_inputs(2, L, 50, K, seed=30 + K)
    got = conv_silu_bwd_tiled(g_xc, xBC, w, b, reverse,
                              tile or CONV_TILE_ROWS)
    want = conv_silu_bwd(g_xc, xBC, w, b, reverse)
    assert [t.shape for t in got] == [t.shape for t in want]
    assert _conv_adjoint_close(got, want)


@pytest.mark.parametrize("side", ["raw rows before", "g_xc rows after"])
@pytest.mark.parametrize("reverse", [False, True])
def test_conv_adjoint_tiles_fail_without_one_tiles_halo(one_thread, side,
                                                        reverse):
    """One tile's halo dropped (its raw rows before the tile, or its g_xc
    rows past it in the scan's order) fails the check above."""
    from caduceus_tpu_torch.ops import ssd

    g_xc, xBC, w, b = _conv_adjoint_inputs(2, 150, 50, 4, seed=40)
    want = ssd.conv_silu_bwd(g_xc, xBC, w, b, reverse)
    real = ssd.conv_tile_rows

    def dropped(r0, r1, K, rev):
        (x0, x1), (g0, g1) = real(r0, r1, K, rev)
        if r0 != 48:
            return (x0, x1), (g0, g1)
        if side == "raw rows before":
            return ((x0, r1) if rev else (r0, x1)), (g0, g1)
        return (x0, x1), ((r0, g1) if rev else (g0, r1))

    try:
        ssd.conv_tile_rows = dropped
        got = ssd.conv_silu_bwd_tiled(g_xc, xBC, w, b, reverse, 24)
    finally:
        ssd.conv_tile_rows = real
    assert not _conv_adjoint_close(got, want)
