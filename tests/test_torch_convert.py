"""The port's reference-checkpoint import and export
(`caduceus_tpu_torch/convert.py`) against `caduceus_tpu.convert`, on the
CPU.

Hand-built state dicts with the reference's names and torch layouts (the
released checkpoints are not in the repository): the Caduceus MLM of
`tests/test_convert_reference.py` (RCPS and not, tied and untied BiMamba,
the non-fused ``.submodule`` norms, an untied head), a mamba-ssm
`MixerModel` backbone and a HyenaDNA `ConvLMHeadModel` (1 and 2 inner
filter MLPs, with and without a position embedding). Each port importer
gives the flat flax paths of the JAX importer's tree, bit for bit; the
export gives the JAX export's tensors and imports back to the same
state_dict; the port's forward of imported weights meets the reference
equations of `tests/test_convert_reference.py` within 2e-5 of max|logit|.
"""

import dataclasses

import flax.traverse_util as tu
import numpy as np
import pytest
import torch

from caduceus_tpu import convert as jconvert
from caduceus_tpu_torch import convert
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models.caduceus import Caduceus, CaduceusForMaskedLM
from caduceus_tpu_torch.models.hyena import HyenaLMHeadModel
from caduceus_tpu_torch.params import from_jax_params, to_jax_params
from test_convert_reference import (
    _build_reference_state,
    _cfg,
    _mamba_slow,
    _ref_forward_plain,
    _ref_forward_rcps,
    _rms_norm,
)

D, N_LAYER = 16, 2
HYENA = dict(d_model=D, n_layer=2, vocab_size=12, l_max=32,
             attn_layer_idx=(1,), num_heads=2)


def flat_of(tree):
    """A JAX importer's ``{'params': ...}`` tree as flat flax paths."""
    return tu.flatten_dict(tree.get("params", tree), sep="/")


def assert_same(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == np.asarray(w).dtype, k
        assert np.array_equal(g, np.asarray(w)), k


def port_cfg(jcfg):
    return CaduceusConfig.from_dict(dataclasses.asdict(jcfg))


def reference_state(rcps=True, tie=True, submodule=False, head=False,
                    seed=0):
    """The reference MLM state dict of `test_convert_reference.py` (fp32),
    with untied rev projections, ``.submodule`` norms (RCPS without fused
    add-norm) or a head that is not the embedding on request."""
    jcfg = _cfg(rcps=rcps, tie=tie)
    rng = np.random.default_rng(seed)
    state = {k: v.astype(np.float32)
             for k, v in _build_reference_state(jcfg, rng).items()}
    hop = "mixer.submodule" if rcps else "mixer"
    if not tie:
        for i in range(jcfg.n_layer):
            p = f"caduceus.backbone.layers.{i}.{hop}.mamba_rev"
            for w in ("in_proj.weight", "out_proj.weight"):
                state[f"{p}.{w}"] = (state[f"{p}.{w}"] + 0.05).astype(
                    np.float32)
    if submodule:
        state = {k.replace("norm.weight", "norm.submodule.weight")
                 .replace("norm_f.weight", "norm_f.submodule.weight"): v
                 for k, v in state.items()}
    if head:
        k = "lm_head.lm_head.weight" if rcps else "lm_head.weight"
        state[k] = (state[k] * 1.5).astype(np.float32)
    return jcfg, state


CASES = [dict(rcps=True, tie=True), dict(rcps=False, tie=True),
         dict(rcps=True, tie=False), dict(rcps=False, tie=False),
         dict(rcps=True, tie=True, submodule=True),
         dict(rcps=True, tie=False, submodule=True),
         dict(rcps=True, tie=True, head=True),
         dict(rcps=False, tie=True, head=True)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_import_reference_state_dict_matches_jax(case):
    """Flat paths and values of the port's import equal the JAX import's,
    bit for bit, also with torch tensors as values; the weights load into
    the port's model (an untied head as ``lm_head``)."""
    jcfg, state = reference_state(**case)
    want = flat_of(jconvert.import_reference_state_dict(state, jcfg))
    got = convert.import_reference_state_dict(state, port_cfg(jcfg))
    assert_same(got, want)
    assert_same(convert.import_reference_state_dict(
        {k: torch.from_numpy(v) for k, v in state.items()}, port_cfg(jcfg)),
        want)
    assert ("lm_head" in got) == bool(case.get("head"))
    cfg = port_cfg(jcfg)
    model = CaduceusForMaskedLM(cfg, device="cpu",
                                tie_word_embeddings="lm_head" not in got)
    model.load_state_dict(from_jax_params(
        got, cfg, tie_word_embeddings="lm_head" not in got))


def test_weight_tie_mismatch_raises_as_jax():
    jcfg, state = reference_state(rcps=True, tie=True)
    k = "caduceus.backbone.layers.0.mixer.submodule.mamba_rev.in_proj.weight"
    state[k] = state[k] + 1.0
    with pytest.raises(AssertionError, match="weight-tie"):
        jconvert.import_reference_state_dict(state, jcfg)
    with pytest.raises(AssertionError, match="weight-tie"):
        convert.import_reference_state_dict(state, port_cfg(jcfg))


@pytest.mark.parametrize("rcps", [True, False])
def test_imported_forward_meets_reference_equations(rcps):
    """The port's MLM on imported weights against the numpy executor of
    the reference call stack (`tests/test_convert_reference.py`), within
    2e-5 of max|logit| (the bound JAX is held to there)."""
    jcfg, state = reference_state(rcps=rcps)
    state64 = {k: v.astype(np.float64) for k, v in state.items()}
    ids = np.random.default_rng(0).integers(7, 11, (2, 24))
    want = (_ref_forward_rcps if rcps else _ref_forward_plain)(
        state64, jcfg, ids)
    cfg = port_cfg(jcfg)
    model = CaduceusForMaskedLM(cfg, device="cpu")
    model.load_state_dict(from_jax_params(
        convert.import_reference_state_dict(state, cfg), cfg))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids)).double().numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=2e-5)


@pytest.mark.parametrize("case", [
    dict(rcps=True), dict(rcps=True, fused=False), dict(rcps=False),
    dict(rcps=True, tie=False)], ids=["rcps", "rcps-nonfused", "plain",
                                      "untied"])
def test_export_matches_jax_and_round_trips(case):
    """The export of a seeded port model equals JAX's export of the same
    weights, bit for bit (reference names, torch layouts, the
    ``.submodule`` norms of the non-fused RCPS frame); importing it gives
    the state_dict back bit for bit."""
    jcfg = dataclasses.replace(
        _cfg(rcps=case["rcps"], tie=case.get("tie", True)),
        fused_add_norm=case.get("fused", True))
    cfg = port_cfg(jcfg)
    model = CaduceusForMaskedLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(3))
    sd = model.state_dict()
    got = convert.export_reference_state_dict(sd, cfg)
    tree = {"params": tu.unflatten_dict(to_jax_params(sd), sep="/")}
    assert_same(got, jconvert.export_reference_state_dict(tree, jcfg))
    norm = ("caduceus.backbone.layers.0.norm.submodule.weight"
            if not case.get("fused", True) else
            "caduceus.backbone.layers.0.norm.weight")
    assert norm in got
    back = from_jax_params(convert.import_reference_state_dict(got, cfg), cfg)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def mamba_backbone_state(n_layer, d, N, dt_rank, K, V, seed):
    """A mamba-ssm `MixerModel` state dict under ``backbone.`` (numpy)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    di = 2 * d
    state = {"backbone.embedding.weight": r(V, d),
             "backbone.norm_f.weight": 1.0 + r(d)}
    for i in range(n_layer):
        p = f"backbone.layers.{i}.mixer"
        state[f"backbone.layers.{i}.norm.weight"] = 1.0 + r(d)
        state.update({
            f"{p}.in_proj.weight": r(2 * di, d),
            f"{p}.out_proj.weight": r(d, di),
            f"{p}.conv1d.weight": r(di, 1, K), f"{p}.conv1d.bias": r(di),
            f"{p}.x_proj.weight": r(dt_rank + 2 * N, di),
            f"{p}.dt_proj.weight": r(di, dt_rank),
            f"{p}.dt_proj.bias": r(di),
            f"{p}.A_log": np.log(np.tile(np.arange(1, N + 1, dtype=np.float32),
                                         (di, 1))),
            f"{p}.D": 1.0 + r(di)})
    return state


def test_import_reference_mamba_backbone_matches_jax_and_equations():
    """`import_reference_mamba_backbone` against JAX's, bit for bit; the
    port's unidirectional non-RCPS backbone on those weights against
    mamba-ssm's `MixerModel` equations (prenorm residual blocks over the
    slow-path `Mamba`, final add + norm_f) within 2e-5 of max|h|."""
    jcfg = dataclasses.replace(_cfg(rcps=False), bidirectional=False,
                               complement_map=None, fused_add_norm=True)
    cfg = port_cfg(jcfg)
    state = mamba_backbone_state(N_LAYER, D, cfg.ssm_cfg.d_state, cfg.dt_rank,
                                 cfg.ssm_cfg.d_conv, cfg.padded_vocab_size, 1)
    want = flat_of(jconvert.import_reference_mamba_backbone(state, N_LAYER))
    got = convert.import_reference_mamba_backbone(state, N_LAYER)
    assert_same(got, want)
    model = Caduceus(cfg, device="cpu")
    model.load_state_dict(from_jax_params(got, cfg, backbone_only=True))
    ids = np.random.default_rng(2).integers(7, 11, (2, 20))
    with torch.inference_mode():
        h = model(torch.from_numpy(ids)).double().numpy()
    s64 = {k: v.astype(np.float64) for k, v in state.items()}
    x, res = s64["backbone.embedding.weight"][ids], None
    for i in range(N_LAYER):
        res = x if res is None else x + res
        x = _mamba_slow(s64, f"backbone.layers.{i}.mixer", _rms_norm(
            res, s64[f"backbone.layers.{i}.norm.weight"]))
    ref = _rms_norm(x + res, s64["backbone.norm_f.weight"])
    scale = np.abs(ref).max()
    np.testing.assert_allclose(h / scale, ref / scale, rtol=0, atol=2e-5)


def hyena_state(num_inner_mlps, pos, seed, d=D, n_layer=2, attn=(1,), V=12,
                l_max=32, order=64, K=3, emb_dim=3):
    """A HyenaDNA `ConvLMHeadModel` state dict (numpy, torch layouts)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    state = {"backbone.embeddings.word_embeddings.weight": r(V, d),
             "backbone.ln_f.weight": 1.0 + r(d), "backbone.ln_f.bias": r(d)}
    if pos:
        state["backbone.embeddings.position_embeddings.weight"] = r(l_max, d)
    for i in range(n_layer):
        p = f"backbone.layers.{i}"
        for n in ("norm1", "norm2"):
            state[f"{p}.{n}.weight"] = 1.0 + r(d)
            state[f"{p}.{n}.bias"] = r(d)
        for n, o, k in (("mlp.fc1", 4 * d, d), ("mlp.fc2", d, 4 * d)):
            state[f"{p}.{n}.weight"], state[f"{p}.{n}.bias"] = r(o, k), r(o)
        m = f"{p}.mixer"
        if i in attn:
            for n, o in (("Wqkv", 3 * d), ("out_proj", d)):
                state[f"{m}.{n}.weight"], state[f"{m}.{n}.bias"] = r(o, d), r(o)
            continue
        f = f"{m}.filter_fn"
        state.update({
            f"{m}.in_proj.weight": r(3 * d, d), f"{m}.in_proj.bias": r(3 * d),
            f"{m}.out_proj.weight": r(d, d), f"{m}.out_proj.bias": r(d),
            f"{m}.short_filter.weight": r(3 * d, 1, K),
            f"{m}.short_filter.bias": r(3 * d),
            f"{f}.pos_emb.z": r(1, l_max, emb_dim),
            f"{f}.implicit_filter.1.freq": 1.0 + r(1, order),
            f"{f}.bias": r(d),
            f"{f}.modulation.deltas": -np.abs(r(1, 1, d)) - 0.5,
            f"{f}.implicit_filter.0.weight": r(order, emb_dim),
            f"{f}.implicit_filter.0.bias": r(order),
            f"{f}.implicit_filter.{2 * (num_inner_mlps + 1)}.weight":
                r(d, order)})
        for j in range(num_inner_mlps):
            lin = f"{f}.implicit_filter.{2 * (j + 1)}"
            state[f"{lin}.weight"], state[f"{lin}.bias"] = r(order, order), \
                r(order)
    return state


@pytest.mark.parametrize("num_inner_mlps", [1, 2])
@pytest.mark.parametrize("pos", [False, True])
def test_import_reference_hyena_matches_jax(num_inner_mlps, pos):
    """`import_reference_hyena_lm` and `import_reference_hyena_operator`
    against JAX's, bit for bit; with 2 inner MLPs (the port's filter) the
    imported LM loads into `HyenaLMHeadModel` and runs."""
    state = hyena_state(num_inner_mlps, pos, seed=num_inner_mlps + 2 * pos)
    kw = dict(n_layer=2, attn_layer_idx=(1,), num_inner_mlps=num_inner_mlps)
    got = convert.import_reference_hyena_lm(state, **kw)
    assert_same(got, flat_of(jconvert.import_reference_hyena_lm(state, **kw)))
    op = dict(prefix="backbone.layers.0.mixer", num_inner_mlps=num_inner_mlps)
    assert_same(convert.import_reference_hyena_operator(state, **op),
                flat_of(jconvert.import_reference_hyena_operator(state, **op)))
    if num_inner_mlps != 2:
        return
    model = HyenaLMHeadModel(device="cpu", max_position_embeddings=(
        HYENA["l_max"] if pos else 0), **HYENA)
    model.load_state_dict(from_jax_params(got, None, model=model))
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 12, (2, 32)))
    with torch.inference_mode():
        logits = model(ids)
    assert logits.shape == (2, 32, 12) and bool(torch.isfinite(logits).all())


def test_load_torch_checkpoint_matches_jax(tmp_path):
    """A saved state dict (bare, and a Lightning ``{"state_dict": ...}``)
    reads back as JAX's reader reads it."""
    _, state = reference_state()
    sd = {k: torch.from_numpy(v) for k, v in state.items()}
    for obj, name in ((sd, "bare.bin"), ({"state_dict": sd}, "pl.ckpt")):
        path = str(tmp_path / name)
        torch.save(obj, path)
        assert_same(convert.load_torch_checkpoint(path),
                    jconvert.load_torch_checkpoint(path))
