"""The port's Mamba-2 Caduceus models against the JAX package, on the CPU.

The same numpy-seeded ids and the same weights (JAX init, moved through
`caduceus_tpu_torch/params.py`) go through `CaduceusForMaskedLM` /
`Caduceus` of both packages in fp32. The JAX side runs with
``use_kernel="xla"`` (one case through the Pallas kernel in interpret
mode); the port runs the plain version of its SSD kernel. Tolerance: 1e-5
absolute on logits and hidden states (rounding of two fp32 programs that
chunk the scan differently).
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
from caduceus_tpu.models.caduceus import canonical_to_reference
from caduceus_tpu.models.mamba2 import rms_norm_gated as jax_rms_norm_gated
from caduceus_tpu.tokenization import CaduceusTokenizer
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models.caduceus import Caduceus, CaduceusForMaskedLM
from caduceus_tpu_torch.models.mamba2 import rms_norm_gated
from caduceus_tpu_torch.params import from_jax_params, to_jax_params

ATOL = 1e-5


_INITS = {}


def _jax_init(cfg, ids, seed):
    """The JAX init of one parameter tree. Its values depend only on the
    modules' names and shapes (flax derives each parameter's key from its
    path), so the configs that build the same tree share one init: those
    that differ only in rcps, fused_add_norm, the bidirectional strategy or
    use_kernel, which the key leaves out."""
    key = (cfg.n_layer, cfg.bidirectional_weight_tie, cfg.bidirectional,
           seed)
    if key not in _INITS:
        params = jax.jit(JaxLM(cfg).init)(jax.random.PRNGKey(seed),
                                          jnp.asarray(ids))
        _INITS[key] = {k: np.asarray(v) for k, v in
                       tu.flatten_dict(params["params"], sep="/").items()}
    return dict(_INITS[key])


@functools.lru_cache(maxsize=None)  # cases shared by the tests below
def make_case(rcps=True, fused=True, n_layer=2, tie=True, strategy="add",
              bidirectional=True, kernel="xla", seed=0):
    tok = CaduceusTokenizer()
    cfg = JaxConfig(
        d_model=32, n_layer=n_layer, vocab_size=tok.vocab_size, rcps=rcps,
        complement_map=tok.complement_map if rcps else None,
        fused_add_norm=fused, bidirectional=bidirectional,
        bidirectional_weight_tie=tie, bidirectional_strategy=strategy,
        residual_in_fp32=False, dtype="float32", param_dtype="float32",
        # one chunk per grid step of the interpret-mode kernel (its chunk
        # loop is unrolled when traced)
        ssm_cfg=JaxSSM(version=2, d_state=16, headdim=16, ngroups=1,
                       ssd_chunk_size=16, use_kernel=kernel,
                       ssd_seg_chunks=8 if kernel == "xla" else 1))
    rng = np.random.default_rng(seed)
    ids = rng.integers(7, 12, size=(2, 50)).astype(np.int32)
    flat = _jax_init(cfg, ids, seed)
    # non-trivial norm weights and D (they init to ones)
    for k, v in flat.items():
        if "norm" in k or k.endswith("/D"):
            flat[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return cfg, ids, flat


def port_config(jax_cfg):
    return CaduceusConfig.from_dict(dataclasses.asdict(jax_cfg))


def _jax_logits_and_hidden(cfg, ids, flat):
    """The JAX logits and backbone hidden states from one compile of the
    LM: the backbone's output is captured and put in the reference
    convention, as JAX's `Caduceus` returns it."""
    def run(params, i):
        logits, state = JaxLM(cfg).apply(
            params, i, capture_intermediates=lambda m, _: m.name == "backbone")
        h = state["intermediates"]["backbone"]["__call__"][0][0]
        return logits, canonical_to_reference(h) if cfg.rcps else h

    out = jax.jit(run)({"params": tu.unflatten_dict(flat, sep="/")},
                       jnp.asarray(ids))
    return tuple(np.asarray(o) for o in out)


@functools.lru_cache(maxsize=None)
def jax_outputs(**case):
    """`_jax_logits_and_hidden` of a v2 case, shared by the tests."""
    return _jax_logits_and_hidden(*make_case(**case))


CASES = [
    dict(),                                           # main-path frame
    dict(fused=False),
    dict(rcps=False),
    dict(tie=False),
    dict(strategy="ew_multiply"),
    dict(tie=False, strategy="ew_multiply", n_layer=3),  # odd: final swap_rc
    dict(bidirectional=False),
    dict(kernel="pallas_batched_interpret"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()) or "default")
def test_masked_lm_logits_match_jax(case):
    cfg, ids, flat = make_case(**case)
    want = jax_outputs(**case)[0]
    model = CaduceusForMaskedLM(port_config(cfg), device="cpu")
    model.load_state_dict(from_jax_params(flat, port_config(cfg)))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[5]],
                         ids=["default", "rcps=False", "untied-ew-n_layer=3"])
def test_backbone_hidden_states_match_jax(case):
    """The port's `Caduceus` against the JAX backbone's output (as JAX's
    `Caduceus` gives it), taken from the logits test's compile."""
    cfg, ids, flat = make_case(**case)
    bflat = {k: v for k, v in flat.items() if k.startswith("backbone/")}
    want = jax_outputs(**case)[1]
    pc = port_config(cfg)
    model = Caduceus(pc, device="cpu")
    model.load_state_dict(from_jax_params(bflat, pc, backbone_only=True))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids).long())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_data_frame_equals_conj_frame():
    """The two realizations of the fused RCPS frame compute one function
    (odd n_layer: the conj frame owes the final swap_rc)."""
    cfg, ids, flat = make_case(**CASES[5])
    pc = port_config(cfg)
    sd = from_jax_params(flat, pc)
    out = []
    for frame in ("conj", "data"):
        m = CaduceusForMaskedLM(pc, device="cpu", fused_frame=frame)
        m.load_state_dict(sd)
        with torch.inference_mode():
            out.append(m(torch.from_numpy(ids).long()).numpy())
    np.testing.assert_allclose(out[0], out[1], rtol=0, atol=ATOL)


@pytest.mark.parametrize("ngroups", [1, 2])
def test_rms_norm_gated_matches_jax(ngroups):
    rng = np.random.default_rng(5)
    y, z = (rng.standard_normal((2, 7, 16)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal(16).astype(np.float32)
    got = rms_norm_gated(torch.from_numpy(y), torch.from_numpy(z),
                         torch.from_numpy(w), ngroups, 1e-5)
    want = jax_rms_norm_gated(jnp.asarray(y), jnp.asarray(z), jnp.asarray(w),
                              ngroups, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# --- the v1 (Mamba-1) model: BiMamba / MambaMixer over the selective scan


@functools.lru_cache(maxsize=None)
def make_v1_case(n_layer=2, tie=True, strategy="add", bidirectional=True,
                 fused=True, kernel="xla", seed=0):
    """A v1 config, ids, flat flax params, the JAX logits and backbone
    hidden states (`_jax_logits_and_hidden`). The weights
    come from the port's seeded init through `to_jax_params` (a JAX init
    costs a compile per case; the bridge from a JAX-made tree is held in
    tests/test_torch_train.py), with non-trivial norm weights and D."""
    tok = CaduceusTokenizer()
    cfg = JaxConfig(
        d_model=32, n_layer=n_layer, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, fused_add_norm=fused,
        bidirectional=bidirectional, bidirectional_weight_tie=tie,
        bidirectional_strategy=strategy, residual_in_fp32=False,
        dtype="float32", param_dtype="float32",
        ssm_cfg=JaxSSM(version=1, d_state=8, use_kernel=kernel))
    rng = np.random.default_rng(seed)
    ids = rng.integers(7, 12, size=(2, 50)).astype(np.int32)
    model = CaduceusForMaskedLM(port_config(cfg), device="cpu",
                                generator=torch.Generator().manual_seed(seed))
    flat = to_jax_params(model.state_dict())
    for k, v in flat.items():
        if "norm" in k or k.endswith("/D"):
            flat[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return (cfg, ids, flat) + _jax_logits_and_hidden(cfg, ids, flat)


V1_CASES = [
    dict(),                                              # hg38_mlm's mixer
    dict(frame="data"),
    dict(fused=False),
    dict(strategy="ew_multiply"),
    dict(tie=False, n_layer=3),                          # odd: final swap_rc
    dict(bidirectional=False),
    dict(kernel="pallas_interpret"),                     # JAX runs TPU #9
]


@pytest.mark.parametrize("case", V1_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()) or "default")
def test_v1_masked_lm_logits_match_jax(case):
    """The v1 `CaduceusForMaskedLM` against JAX's (SSMConfig(version=1)),
    fp32, 1e-5 on logits; the port runs the plain scan on the CPU. The
    "data" case realizes the RCPS frame by data swaps (JAX has only the
    function, which both frames compute)."""
    case = dict(case)
    frame = case.pop("frame", "conj")
    cfg, ids, flat, want, _ = make_v1_case(**case)
    pc = port_config(cfg)
    model = CaduceusForMaskedLM(pc, device="cpu", fused_frame=frame)
    model.load_state_dict(from_jax_params(flat, pc))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_v1_backbone_hidden_states_match_jax():
    cfg, ids, flat, _, want = make_v1_case()
    bflat = {k: v for k, v in flat.items() if k.startswith("backbone/")}
    pc = port_config(cfg)
    model = Caduceus(pc, device="cpu")
    model.load_state_dict(from_jax_params(bflat, pc, backbone_only=True))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kernel", ["xla", "auto", "pallas_batched"])
def test_fused_ssd_conv_weights_per_use_kernel(kernel, monkeypatch):
    """The conv weights the fused-conv SSD receives in a bf16 model, per
    ``use_kernel``: "xla" rounds conv_w / conv_b to bf16 first, as the JAX
    XLA form casts them to the compute dtype; "auto" and "pallas_batched"
    pass the fp32 parameters, as JAX's `ssd_pallas_batched_fused` takes
    them. Exact: the same values, bit for bit."""
    from caduceus_tpu_torch.config import SSMConfig
    from caduceus_tpu_torch.models import mamba2

    tok = CaduceusTokenizer()
    cfg = CaduceusConfig(
        d_model=32, n_layer=1, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, bidirectional=True,
        dtype="bfloat16", param_dtype="float32",
        ssm_cfg=SSMConfig(version=2, d_state=16, headdim=16, ngroups=1,
                          use_kernel=kernel))
    model = CaduceusForMaskedLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    params = [(m.conv_w, m.conv_b) for m in model.modules()
              if isinstance(m, mamba2._DirectionParamsV2)]
    seen = []
    real = mamba2.ssd_batched_fused

    def spy(*args, **kw):
        seen.append((args[3], kw["conv_b"]))
        return real(*args, **kw)

    monkeypatch.setattr(mamba2, "ssd_batched_fused", spy)
    with torch.inference_mode():
        model(torch.full((1, 24), 7, dtype=torch.long))
    assert seen
    for w, b in seen:
        assert w.dtype == torch.float32 and b.dtype == torch.float32
        if kernel == "xla":
            want = [(pw.to(torch.bfloat16).float(), pb.to(torch.bfloat16).float())
                    for pw, pb in params]
        else:
            want = params
        assert any(torch.equal(w, ww) and torch.equal(b, wb)
                   for ww, wb in want)
        if kernel == "xla":  # the fp32 parameters are not bf16 values
            assert not any(torch.equal(w, pw) for pw, _ in params)
