"""The port's inference path (`caduceus_tpu_torch/inference.py`) against
`caduceus_tpu.inference`, on the CPU.

Both causal families at a small size (d_model 32, 2 layers, fp32): v1
(Mamba-1, d_state 8) and v2 (Mamba-2, d_state 16, headdim 16, ngroups 2).
The same JAX init goes through `params.py` into the port's
`CaduceusForMaskedLM`, and the same numpy-seeded ids and states go to both
sides. The JAX v2 prefill runs the TPU kernel #2 itself in interpret mode
(``use_kernel="pallas_batched_interpret"``, chunked by its
``ssd_chunk_size`` of 16; with ``"pallas_interpret"`` the per-head #5);
the port's runs the plain version of its CUDA kernel, `ops/ssd.py
ssd_chunked`, chunked as the kernel chunks
(`KERNEL_CHUNK`, 32 rows in fp32), which computes the same function. The
v1 JAX side runs ``use_kernel="xla"``. Tolerances: 1e-5 absolute on the
steps and on the decode logits (the same arithmetic in another order), 1e-4
on prefill logits and states (two chunkings of the scan), as
tests/test_inference.py holds the JAX paths against each other.
"""

import dataclasses
import functools

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caduceus_tpu import inference as jinf
from caduceus_tpu.config import CaduceusConfig as JaxConfig
from caduceus_tpu.config import SSMConfig as JaxSSM
from caduceus_tpu.models.caduceus import CaduceusForMaskedLM as JaxLM
from caduceus_tpu.tokenization import CaduceusTokenizer
from caduceus_tpu_torch import inference as inf
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
from caduceus_tpu_torch.params import from_jax_params

STEP = dict(rtol=1e-5, atol=1e-5)
PREFILL = dict(rtol=1e-4, atol=1e-4)
SSM = {
    "v1": JaxSSM(version=1, d_state=8, use_kernel="xla"),
    # one chunk per grid step of the interpret-mode kernels (their chunk
    # loop is unrolled when traced)
    "v2": JaxSSM(version=2, d_state=16, headdim=16, ngroups=2,
                 ssd_chunk_size=16, ssd_seg_chunks=1,
                 use_kernel="pallas_batched_interpret"),
}


@functools.lru_cache(maxsize=None)
def family(name):
    """(JAX config, JAX params, port model) of a causal model: the JAX init
    with non-trivial norm weights and D (they init to ones)."""
    tok = CaduceusTokenizer()
    cfg = JaxConfig(
        d_model=32, n_layer=2, vocab_size=tok.vocab_size, rcps=False,
        bidirectional=False, complement_map=tok.complement_map,
        dtype="float32", param_dtype="float32", ssm_cfg=SSM[name])
    rng = np.random.default_rng(11)
    # the parameters do not depend on use_kernel: init through the XLA
    # form, which traces faster than the interpret-mode kernels
    xla = dataclasses.replace(cfg, ssm_cfg=dataclasses.replace(
        cfg.ssm_cfg, use_kernel="xla"))
    params = jax.jit(JaxLM(xla).init)(jax.random.PRNGKey(3),
                                      jnp.full((1, 16), 7, jnp.int32))
    flat = {k: np.asarray(v) for k, v in
            tu.flatten_dict(params["params"], sep="/").items()}
    for k, v in flat.items():
        if "norm" in k or k.endswith("/D"):
            flat[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    pcfg = CaduceusConfig.from_dict(dataclasses.asdict(cfg))
    model = CaduceusForMaskedLM(pcfg, device="cpu")
    model.load_state_dict(from_jax_params(flat, pcfg))
    jparams = {k: jnp.asarray(v) for k, v in flat.items()}
    return cfg, {"params": tu.unflatten_dict(jparams, sep="/")}, model


def _ids(B, L, seed):
    return np.random.default_rng(seed).integers(7, 11, (B, L)).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    """Every leaf of a port cache (or a tensor) against the JAX one."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_direction_steps_match_jax(name):
    """`mamba_direction_step` / `mamba2_direction_step` from the same
    nonzero cache and input, and `ssd_step` inside the latter."""
    cfg, params, model = family(name)
    dp = params["params"]["backbone"]["layers_1"]["mixer"]["mamba_fwd"]["fwd"]
    port_dp = model.backbone.layers[1].mixer.mamba_fwd.fwd
    cache = jinf.init_cache(cfg, 3)["layers_1"]["fwd"]
    rng = np.random.default_rng(5)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in cache.items()}
    port_cache = {k: _t(v) for k, v in cache.items()}
    width = cache["conv"].shape[-1]
    x_t = rng.standard_normal((3, width)).astype(np.float32)
    if name == "v1":
        want = jax.jit(lambda x, c: jinf.mamba_direction_step(
            dp, cfg, x, c))(x_t, cache)
        got = inf.mamba_direction_step(port_dp, _t(x_t), port_cache)
    else:
        dt_t = rng.standard_normal((3, cfg.nheads)).astype(np.float32)
        want = jax.jit(lambda x, d, c: jinf.mamba2_direction_step(
            dp, cfg, x, d, c))(x_t, dt_t, cache)
        got = inf.mamba2_direction_step(port_dp, _t(x_t), _t(dt_t),
                                        port_cache)
    _close(got[0], want[0], STEP)
    _close(got[1], want[1], STEP)


@pytest.mark.parametrize("mode", ["parallel", "stepwise"])
@pytest.mark.parametrize("name", ["v1", "v2"])
def test_prefill_and_lm_step_match_jax(name, mode):
    """Last-position logits and every cache entry of `prefill`, then one
    `lm_step` from those caches, against the JAX functions."""
    cfg, params, model = family(name)
    ids = _ids(2, 40, 1)
    want_logits, want_caches = jax.jit(lambda i: jinf.prefill(
        params, cfg, i, mode=mode))(ids)
    got_logits, got_caches = inf.prefill(model, _t(ids).long(), mode=mode)
    assert got_logits.shape == (2, cfg.padded_vocab_size)
    _close(got_logits, want_logits, PREFILL)
    _close(got_caches, want_caches, PREFILL)
    tok = _ids(2, 1, 2)[:, 0]
    want_logits, want_caches = jax.jit(lambda t, c: jinf.lm_step(
        params, cfg, t, c))(tok, want_caches)
    got_logits, got_caches = inf.lm_step(model, _t(tok).long(), got_caches)
    _close(got_logits, want_logits, PREFILL)
    _close(got_caches, want_caches, PREFILL)


def test_pallas_prefill_matches_jax():
    """The v2 model of `family("v2")` with ``use_kernel`` "pallas_interpret":
    JAX's prefill runs the per-head TPU kernel #5 in interpret mode, the
    port's (`_resolved_infer_kernel`) `ops/ssd_head.py ssd_head_chained`,
    the plain version on the CPU. Logits and caches at the prefill's 1e-4."""
    cfg, params, _ = family("v2")
    cfg = dataclasses.replace(cfg, ssm_cfg=dataclasses.replace(
        cfg.ssm_cfg, use_kernel="pallas_interpret"))
    pcfg = CaduceusConfig.from_dict(dataclasses.asdict(cfg))
    assert inf._resolved_infer_kernel(pcfg) == "pallas_interpret"
    model = CaduceusForMaskedLM(pcfg, device="cpu")
    model.load_state_dict(from_jax_params(
        {k: np.asarray(v) for k, v in tu.flatten_dict(
            params["params"], sep="/").items()}, pcfg))
    ids = _ids(2, 40, 1)
    want_logits, want_caches = jax.jit(lambda i: jinf.prefill(
        params, cfg, i))(ids)
    got_logits, got_caches = inf.prefill(model, _t(ids).long())
    _close(got_logits, want_logits, PREFILL)
    _close(got_caches, want_caches, PREFILL)


# bf16 prefill vs the JAX bf16 prefill, in units of the JAX value's
# max|.|: the first layer's scan state (before any bf16 rounding of a
# layer's output: what is left is the bf16 conv, rounded per op here and
# fused by XLA) and every other output (a few bf16 steps, 2^-8 each, passed
# through one more layer)
BF16_FIRST_STATE = 3e-3
BF16 = 1e-2


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_bf16_prefill_matches_jax(name):
    """A bf16 model's prefill (logits and every cache entry) against the
    JAX bf16 prefill, the XLA routes, the weights of `family`. The JAX
    prefill adds the fp32 conv bias uncast, so its scan runs in fp32; the
    port's `_conv_tail` does the same (a scan in bf16 put the first
    layer's state 6.0e-3 / 6.4e-3 of max from JAX's)."""
    cfg, params, _ = family(name)
    cfg = dataclasses.replace(cfg, dtype="bfloat16", ssm_cfg=dataclasses.replace(
        cfg.ssm_cfg, use_kernel="xla"))
    pcfg = CaduceusConfig.from_dict(dataclasses.asdict(cfg))
    model = CaduceusForMaskedLM(pcfg, device="cpu")
    model.load_state_dict(from_jax_params(
        {k: np.asarray(v) for k, v in tu.flatten_dict(
            params["params"], sep="/").items()}, pcfg))
    ids = _ids(2, 40, 1)
    want_logits, want_caches = jax.jit(lambda i: jinf.prefill(
        params, cfg, i))(ids)
    got_logits, got_caches = inf.prefill(model, _t(ids).long())

    def err(got, want):
        want = np.asarray(want, np.float32)
        return np.abs(got.float().numpy() - want).max() / np.abs(want).max()

    assert err(got_logits, want_logits) <= BF16
    for key, layer in want_caches.items():
        for n, want in layer["fwd"].items():
            got = got_caches[key]["fwd"][n]
            tol = BF16_FIRST_STATE if (key, n) == ("layers_0", "ssm") else BF16
            assert err(got, want) <= tol, (key, n, err(got, want))


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_chained_prefill_equals_one_call(name):
    """A prompt split in two chained prefills (at 2 rows, fewer than
    d_conv = 4, and at 19, inside a chunk) gives one call's logits and
    caches; the conv ring buffer holds the last d_conv inputs exactly as
    the stepwise form does."""
    _, _, model = family(name)
    ids = _t(_ids(2, 40, 3)).long()
    one_logits, one_caches = inf.prefill(model, ids)
    for split in (2, 19):
        _, c1 = inf.prefill(model, ids[:, :split])
        logits, c2 = inf.prefill(model, ids[:, split:], caches=c1)
        _close(logits, one_logits.numpy(), STEP)
        _close(c2, {k: {d: {n: t.numpy() for n, t in v.items()}
                        for d, v in layer.items()}
                    for k, layer in one_caches.items()}, STEP)
    _, step_caches = inf.prefill(model, ids, mode="stepwise")
    for key, layer in one_caches.items():
        torch.testing.assert_close(layer["fwd"]["conv"],
                                   step_caches[key]["fwd"]["conv"],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_greedy_generate_matches_jax(name):
    """Greedy `generate` token for token against JAX, and each new token
    the argmax of the port's full forward over prompt + generated tokens
    (the check of tests/test_inference.py)."""
    cfg, params, model = family(name)
    ids = _ids(2, 8, 4)
    want = np.asarray(jax.jit(lambda i: jinf.generate(params, cfg, i, 6))(
        ids))
    got = inf.generate(model, _t(ids).long(), 6)
    assert got.shape == (2, 14)
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.inference_mode():
        full = model(got[:, :-1])
    np.testing.assert_array_equal(full[:, 7:].argmax(-1).numpy(),
                                  got[:, 8:].numpy())


def test_sampling_respects_top_k_and_seed():
    """Each sampled token lies in the top k of the logits it was drawn
    from (those of the full forward at its position); the same generator
    seed gives the same tokens; top_k = 1 is greedy."""
    _, _, model = family("v2")
    ids = _t(_ids(2, 6, 5)).long()

    def sample(seed, top_k):
        return inf.generate(model, ids, 10,
                            generator=torch.Generator().manual_seed(seed),
                            temperature=1.0, top_k=top_k)

    out = sample(7, 3)
    assert torch.equal(out, sample(7, 3))
    with torch.inference_mode():
        full = model(out[:, :-1])[:, 5:]
    top3 = full.topk(3, dim=-1).indices
    assert bool((top3 == out[:, 6:, None]).any(-1).all())
    assert torch.equal(sample(8, 1), inf.generate(model, ids, 10))
    assert not torch.equal(sample(7, None), sample(9, None))


def test_refuses_bidirectional_and_rcps():
    tok = CaduceusTokenizer()
    for kw in (dict(rcps=True, bidirectional=True),
               dict(rcps=False, bidirectional=True)):
        cfg = CaduceusConfig(d_model=16, n_layer=1, vocab_size=tok.vocab_size,
                             complement_map=tok.complement_map,
                             dtype="float32", **kw)
        model = CaduceusForMaskedLM(cfg, device="cpu")
        ids = torch.full((1, 4), 7)
        with pytest.raises(NotImplementedError):
            inf.prefill(model, ids)
        with pytest.raises(NotImplementedError):
            inf.generate(model, ids, 2)
        with pytest.raises(NotImplementedError):
            inf.lm_step(model, ids[:, 0], inf.init_cache(cfg, 1, "cpu"))
