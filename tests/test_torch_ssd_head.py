"""The port's unfused SSD adjoint and the per-head route (``use_kernel =
"pallas"``) against the JAX package, on the CPU.

- `ops/ssd.py ssd_chunked_bwd`, the plain version of the unfused backward
  kernel `ssd_bwd` (TPU kernels #6 and #4), and the two chained entries
  `ops/ssd_head.py ssd_head_chained` and `ops/ssd_batched.py
  ssd_batched_chained` (forward and autograd), against the JAX package's
  `ssd_pallas_chained` (#5 / #6) and `ssd_pallas_batched_chained` (#2 /
  #4) run in interpret mode: their forward is `ssd_pallas_fwd_impl` /
  `ssd_pallas_batched_fwd_impl`, their VJP `ssd_pallas_bwd_impl` /
  `ssd_pallas_batched_bwd_impl` (`ops/ssd_pallas.py:557-607`,
  `ops/ssd_pallas_batched.py:1029-1074`). All eight gradients, g_h0
  among them, with a cotangent on hN and a nonzero h_init; 1e-4 on the
  forward, 2e-5 scale-normalized on the gradients (the JAX package's own
  tolerances, tests/test_ssd_pallas_batched.py).
- A 2-layer v2 model with ``use_kernel="pallas"``: logits and every
  parameter gradient against the JAX model with ``"pallas_interpret"``.

The same numpy inputs go to both sides, in fp32, at the sizes of the JAX
kernels' interpret-mode tests: L <= 64 (ragged against the chunk of 16),
H <= 4, P <= 16, N <= 16. The kernels run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
import functools

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caduceus_tpu.config import CaduceusConfig as JaxConfig
from caduceus_tpu.config import SSMConfig as JaxSSM
from caduceus_tpu.models.caduceus import CaduceusForMaskedLM as JaxLM
from caduceus_tpu.ops.ssd_pallas import ssd_pallas_chained
from caduceus_tpu.ops.ssd_pallas_batched import ssd_pallas_batched_chained
from caduceus_tpu.tokenization import CaduceusTokenizer
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models import mamba2
from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
from caduceus_tpu_torch.ops import ssd_batched, ssd_head
from caduceus_tpu_torch.ops.ssd import ssd_chunked, ssd_chunked_bwd
from caduceus_tpu_torch.params import from_jax_params, to_jax_params

T = 16
NAMES = ("x", "dt", "A", "B", "C", "D", "dt_bias", "h0")
JAX_CHAINED = {"head": ssd_pallas_chained,
               "batched": ssd_pallas_batched_chained}
PORT_CHAINED = {"head": ssd_head.ssd_head_chained,
                "batched": ssd_batched.ssd_batched_chained}


def inputs(G=2, L=40, H=4, P=8, NG=2, N=16, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    vals = (f(G, L, H, P), f(G, L, H, sc=0.5), -np.exp(f(H, sc=0.5)),
            f(G, L, NG, N), f(G, L, NG, N), f(H), f(H, sc=0.1),
            f(G, H, N, P))
    return vals, f(G, L, H, P), f(G, H, N, P)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol, what):
    want = np.asarray(want)
    s = float(np.abs(want).max()) + 1e-9
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(got.detach().numpy() / s, want / s, rtol=0,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("entry,reverse,NG,H", [
    ("head", True, 1, 2), ("batched", False, 2, 4)])
def test_unfused_adjoint_and_chained_entry_match_jax_kernels(entry, reverse,
                                                             NG, H):
    """One JAX VJP of the chained TPU kernels (interpret mode, T = 16, one
    chunk per grid step: the in-kernel chunk loop is unrolled when traced,
    and the per-head kernels' loop over heads too, hence 2 heads there)
    against the port's chained entry on the CPU (forward, and autograd
    through the plain version) and against the explicit plain adjoint
    `ssd_chunked_bwd` from the plain carries. Two heads share each group's
    B and C in both cases."""
    vals, gy, ghN = inputs(H=H, NG=NG, seed=NG + 2 * reverse)

    @jax.jit
    def vjp(*a):
        (y, h), pull = jax.vjp(lambda *v: JAX_CHAINED[entry](
            *v, dt_softplus=True, reverse=reverse, chunk_size=T,
            interpret=True, seg_chunks=1), *a)
        return y, h, pull((jnp.asarray(gy), jnp.asarray(ghN)))

    y_j, h_j, g_j = vjp(*(jnp.asarray(v) for v in vals))
    leaves = [_t(v).clone().requires_grad_() for v in vals]
    y, h = PORT_CHAINED[entry](*leaves, dt_softplus=True, reverse=reverse,
                               chunk_size=T)
    _close(y, y_j, 1e-4, "y")
    _close(h, h_j, 1e-4, "hN")
    ((y * _t(gy)).sum() + (h * _t(ghN)).sum()).backward()
    t = [_t(v) for v in vals]
    _, _, car = ssd_chunked(*t[:7], True, reverse, T, t[7],
                            return_carries=True)
    plain = ssd_chunked_bwd(*t[:7], _t(gy), car, _t(ghN), True, reverse, T)
    for name, leaf, g, w in zip(NAMES, leaves, plain, g_j):
        _close(leaf.grad, w, 2e-5, f"{entry} autograd g_{name}")
        _close(g, w, 2e-5, f"ssd_chunked_bwd g_{name}")


def test_resolve_ssd_kernel_maps_the_jax_strings():
    """The JAX ``use_kernel`` strings: "pallas*" to the per-head entry
    (which the mixer's per-head route calls), "pallas_batched*" to the
    head-batched one; a v2 mixer direction calls the per-head entry for
    "pallas*" and the fused path for "auto", "xla" and "pallas_batched"."""
    for k in ("pallas", "pallas_interpret"):
        assert ssd_head.resolve_ssd_kernel(k) == (ssd_head.ssd_head,
                                                  ssd_head.ssd_head_chained)
    for k in ("pallas_batched", "pallas_batched_interpret"):
        assert ssd_head.resolve_ssd_kernel(k) == (
            ssd_batched.ssd_batched, ssd_batched.ssd_batched_chained)
    # the mixer: "pallas*" calls the per-head entry through
    # `resolve_ssd_kernel`, every other string the fused path
    cfg = pallas_model()[0]
    x = torch.zeros(1, 8, cfg.d_inner + 2 * 16)
    dt = torch.zeros(1, 8, cfg.d_inner // 16)
    for k, want in (("pallas", 1), ("pallas_interpret", 1), ("auto", 0),
                    ("xla", 0), ("pallas_batched", 0)):
        pc = CaduceusConfig.from_dict(dataclasses.asdict(cfg))
        pc.ssm_cfg.use_kernel = k
        calls = []

        def spy(*a, **kw):
            calls.append(k)
            return ssd_head.ssd_head(*a, **kw)

        direction = mamba2._DirectionParamsV2(pc, torch.Generator())
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mamba2, "resolve_ssd_kernel",
                       lambda kernel: (spy, None))
            direction(x, dt, reverse=False)
        assert len(calls) == want, k


@functools.lru_cache(maxsize=None)
def pallas_model():
    """A 2-layer causal v2 model (d_model 16, 2 heads of 16, d_state 16,
    ngroups 1; `Mamba2Mixer`, one direction a layer: the scan runs left to
    right here and right to left in the kernel test above) with
    ``use_kernel="pallas_interpret"``, one chunk per grid step of the JAX
    kernels (as above): the JAX config, the
    flat params (the port's seeded init through `to_jax_params`, with
    non-trivial norm weights and D), ids and a cotangent for the logits."""
    tok = CaduceusTokenizer()
    cfg = JaxConfig(
        d_model=16, n_layer=2, vocab_size=tok.vocab_size, rcps=False,
        bidirectional=False, complement_map=tok.complement_map,
        residual_in_fp32=False, dtype="float32", param_dtype="float32",
        ssm_cfg=JaxSSM(version=2, d_state=16, headdim=16, ngroups=1,
                       ssd_chunk_size=16, ssd_seg_chunks=1,
                       use_kernel="pallas_interpret"))
    pc = CaduceusConfig.from_dict(dataclasses.asdict(cfg))
    model = CaduceusForMaskedLM(pc, device="cpu",
                                generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    flat = to_jax_params(model.state_dict())
    for k, v in flat.items():
        if "norm" in k or k.endswith("/D"):
            flat[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    ids = rng.integers(7, 11, (2, 40)).astype(np.int32)
    cot = rng.standard_normal((2, 40, pc.padded_vocab_size)).astype(
        np.float32)
    return cfg, flat, ids, cot


def test_pallas_model_logits_and_gradients_match_jax():
    """The port's per-head route (`models/mamba2.py`: conv in the storage
    dtype, then `ssd_head` on column views; on the CPU the plain SSD under
    autograd) against the JAX model's `use_kernel="pallas_interpret"`
    (the per-head TPU kernels #5 / #6 in interpret mode): logits 1e-5
    absolute, as tests/test_torch_model.py; each parameter gradient of
    <logits, cot> 1e-4 of its largest element, as
    tests/test_torch_train.py."""
    cfg, flat, ids, cot = pallas_model()
    pc = CaduceusConfig.from_dict(dataclasses.asdict(cfg))
    jmodel = JaxLM(cfg)

    @jax.jit
    def value_and_grad(p):
        def f(p):
            logits = jmodel.apply({"params": p}, jnp.asarray(ids))
            return jnp.sum(logits * cot), logits
        return jax.value_and_grad(f, has_aux=True)(p)

    (_, want), g_want = value_and_grad(tu.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/"))
    model = CaduceusForMaskedLM(pc, device="cpu")
    model.load_state_dict(from_jax_params(flat, pc))
    got = model(_t(ids).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    (got * _t(cot)).sum().backward()
    g_want = tu.flatten_dict(g_want, sep="/")
    grads = to_jax_params({n: p.grad for n, p in model.named_parameters()})
    assert grads.keys() == flat.keys() == {k for k in g_want}
    for path, g in grads.items():
        w = np.asarray(g_want[path])
        s = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(g / s, w / s, rtol=0, atol=1e-4,
                                   err_msg=path)
