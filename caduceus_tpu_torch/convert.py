"""Reference (Hugging Face / PyTorch) checkpoints into the port and back.

Port of `caduceus_tpu/convert.py`. The reference's released checkpoints
are PyTorch state dicts: `CaduceusForMaskedLM` (parameter names of
`caduceus/modeling_caduceus.py` / `modeling_rcps.py` over mamba-ssm's
`Mamba`), mamba-ssm's `MixerModel` backbone, and HyenaDNA's
`ConvLMHeadModel`. Each importer returns the flat flax paths of
`params.py` (``backbone/layers_0/mixer/in_proj/kernel``, no leading
``params/``): the one naming contract of the port, which
`params.py from_jax_params` maps onto the modules and ``np.savez`` writes
as a run dir's ``params.npz``. `export_reference_state_dict` goes the other
way, from the port's state_dict through `params.py to_jax_params`.

Naming (reference, rcps=True):
  caduceus.backbone.embeddings.word_embeddings.embedding.weight   (V, d)
  caduceus.backbone.layers.{i}.norm.weight                        (d,)
  caduceus.backbone.layers.{i}.mixer.submodule.mamba_{fwd,rev}.*  (RCPSWrapper)
  caduceus.backbone.norm_f.weight
  lm_head.lm_head.weight                                          (tied)
rcps=False drops the `.submodule` hop (`Block.mixer` is the BiMambaWrapper)
and uses plain `nn.Embedding` / `lm_head.weight`.

torch Linear weights are (out, in) and become flax (in, out) kernels;
Conv1d depthwise weights (d, 1, K) become (K, d). Values keep their dtype
(a bf16 tensor is read as fp32: numpy has no bf16).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from caduceus_tpu_torch.params import to_jax_params

Flat = Dict[str, np.ndarray]


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


_EMB_KEY = {
    True: "caduceus.backbone.embeddings.word_embeddings.embedding.weight",
    False: "caduceus.backbone.embeddings.word_embeddings.weight"}


def _mamba_prefix(i: int, rcps: bool, direction: str) -> str:
    hop = "mixer.submodule" if rcps else "mixer"
    return f"caduceus.backbone.layers.{i}.{hop}.mamba_{direction}"


def _direction(g, prefix: str, out: Flat, at: str) -> None:
    """One Mamba's inner parameters (`models/mamba.py _DirectionParams`)
    under the flax path ``at``."""
    out[f"{at}/conv_w"] = g(f"{prefix}.conv1d.weight")[:, 0, :].T
    out[f"{at}/conv_b"] = g(f"{prefix}.conv1d.bias")
    out[f"{at}/x_proj_w"] = g(f"{prefix}.x_proj.weight").T
    out[f"{at}/dt_proj_w"] = g(f"{prefix}.dt_proj.weight").T
    out[f"{at}/dt_proj_b"] = g(f"{prefix}.dt_proj.bias")
    out[f"{at}/A_log"] = g(f"{prefix}.A_log")
    out[f"{at}/D"] = g(f"{prefix}.D")


def import_reference_state_dict(state, cfg) -> Flat:
    """Reference `CaduceusForMaskedLM` state dict (numpy or torch values)
    -> flat flax paths of the port's `CaduceusForMaskedLM` for ``cfg``.

    Accepts tied or untied BiMamba; with ``cfg.bidirectional_weight_tie``
    the reference shares the tensors, so the rev projections either alias
    the fwd ones (asserted equal) or are absent. A head that differs from
    the embedding is imported as ``lm_head`` (load the model with
    ``tie_word_embeddings=False``, as `params.py load_run_dir` does)."""

    def g(k):
        # rcps + fused_add_norm=False wraps norms in RCPSAddNormWrapper,
        # nesting their params under `.submodule` (`modeling_rcps.py:100-104`,
        # `modeling_caduceus.py:214`); accept both namings
        if k not in state and k.endswith(".weight"):
            alt = k[: -len(".weight")] + ".submodule.weight"
            if alt in state:
                k = alt
        return _np(state[k])

    rcps = cfg.rcps
    out: Flat = {}
    emb_key = _EMB_KEY[rcps]
    out["backbone/embedding"] = g(emb_key)
    for i in range(cfg.n_layer):
        at = f"backbone/layers_{i}"
        out[f"{at}/norm_w"] = g(f"caduceus.backbone.layers.{i}.norm.weight")
        fwd_p = _mamba_prefix(i, rcps, "fwd")
        rev_p = _mamba_prefix(i, rcps, "rev")
        _direction(g, fwd_p, out, f"{at}/mixer/fwd")
        out[f"{at}/mixer/in_proj/kernel"] = g(f"{fwd_p}.in_proj.weight").T
        out[f"{at}/mixer/out_proj/kernel"] = g(f"{fwd_p}.out_proj.weight").T
        if not cfg.bidirectional:
            continue
        _direction(g, rev_p, out, f"{at}/mixer/rev")
        if cfg.bidirectional_weight_tie:
            # the reference ties by aliasing (`modeling_caduceus.py:114-118`)
            if f"{rev_p}.in_proj.weight" in state:
                np.testing.assert_allclose(
                    g(f"{rev_p}.in_proj.weight"), g(f"{fwd_p}.in_proj.weight"),
                    err_msg="weight-tie mismatch: in_proj")
        else:
            out[f"{at}/mixer/in_proj_rev/kernel"] = \
                g(f"{rev_p}.in_proj.weight").T
            out[f"{at}/mixer/out_proj_rev/kernel"] = \
                g(f"{rev_p}.out_proj.weight").T
    out["backbone/norm_f_w"] = g("caduceus.backbone.norm_f.weight")
    # the head is tied to the embedding in both frameworks; an untied
    # reference head maps to the 'lm_head' parameter
    head_key = "lm_head.lm_head.weight" if rcps else "lm_head.weight"
    if head_key in state and not np.allclose(_np(state[head_key]),
                                             out["backbone/embedding"]):
        out["lm_head"] = g(head_key)
    return out


def export_reference_state_dict(state_dict, cfg) -> Dict[str, np.ndarray]:
    """The port's `CaduceusForMaskedLM` state_dict -> reference-named
    numpy state dict, fp32.

    rcps with ``fused_add_norm=False`` targets the non-fused reference
    naming (norms wrapped in RCPSAddNormWrapper: ``.submodule.weight``).
    The head is written as the embedding, as the reference ties it."""
    flat = to_jax_params(state_dict)
    p = flat.__getitem__
    rcps = cfg.rcps
    norm_hop = (".submodule"
                if rcps and not getattr(cfg, "fused_add_norm", True) else "")
    out: Dict[str, np.ndarray] = {}
    emb = p("backbone/embedding")
    emb_key = _EMB_KEY[rcps]
    out[emb_key] = emb
    out["lm_head.lm_head.weight" if rcps else "lm_head.weight"] = emb
    for i in range(cfg.n_layer):
        at = f"backbone/layers_{i}"
        out[f"caduceus.backbone.layers.{i}.norm{norm_hop}.weight"] = \
            p(f"{at}/norm_w")
        fwd_p = _mamba_prefix(i, rcps, "fwd")
        rev_p = _mamba_prefix(i, rcps, "rev")

        def put(prefix, dp, in_proj, out_proj):
            out[f"{prefix}.conv1d.weight"] = p(f"{dp}/conv_w").T[:, None, :]
            out[f"{prefix}.conv1d.bias"] = p(f"{dp}/conv_b")
            out[f"{prefix}.x_proj.weight"] = p(f"{dp}/x_proj_w").T
            out[f"{prefix}.dt_proj.weight"] = p(f"{dp}/dt_proj_w").T
            out[f"{prefix}.dt_proj.bias"] = p(f"{dp}/dt_proj_b")
            out[f"{prefix}.A_log"] = p(f"{dp}/A_log")
            out[f"{prefix}.D"] = p(f"{dp}/D")
            out[f"{prefix}.in_proj.weight"] = p(f"{in_proj}/kernel").T
            out[f"{prefix}.out_proj.weight"] = p(f"{out_proj}/kernel").T

        m = f"{at}/mixer"
        put(fwd_p, f"{m}/fwd", f"{m}/in_proj", f"{m}/out_proj")
        if cfg.bidirectional:
            tied = f"{m}/in_proj_rev/kernel" not in flat
            put(rev_p, f"{m}/rev",
                f"{m}/in_proj" if tied else f"{m}/in_proj_rev",
                f"{m}/out_proj" if tied else f"{m}/out_proj_rev")
    out[f"caduceus.backbone.norm_f{norm_hop}.weight"] = p("backbone/norm_f_w")
    return out


def import_reference_mamba_backbone(state, n_layer: int,
                                    prefix: str = "backbone") -> Flat:
    """mamba-ssm `MixerModel` state dict (the reference's
    `DNAEmbeddingModelMamba.backbone`, `dna_embedding.py:99-153`) -> flat
    flax paths of the port's non-rcps unidirectional model (``backbone/``,
    which `Caduceus` and the tied `CaduceusForMaskedLM` take)."""
    g = lambda k: _np(state[f"{prefix}.{k}"])
    out: Flat = {"backbone/embedding": g("embedding.weight")}
    for i in range(n_layer):
        p = f"layers.{i}.mixer"
        at = f"backbone/layers_{i}"
        out[f"{at}/norm_w"] = g(f"layers.{i}.norm.weight")
        # the unidirectional BiMamba scopes its single MambaMixer under
        # "mamba_fwd" (`models/mamba.py BiMamba`)
        m = f"{at}/mixer/mamba_fwd"
        out[f"{m}/in_proj/kernel"] = g(f"{p}.in_proj.weight").T
        out[f"{m}/out_proj/kernel"] = g(f"{p}.out_proj.weight").T
        _direction(g, p, out, f"{m}/fwd")
    out["backbone/norm_f_w"] = g("norm_f.weight")
    return out


def import_reference_hyena_operator(state, prefix: str = "",
                                    num_inner_mlps: int = 2) -> Flat:
    """Reference `HyenaOperator` state dict -> flat flax paths of one
    `models/hyena.py HyenaOperator` (relative to it: ``in_proj/kernel``,
    ``filter_fn/mlp_0/bias``, ...).

    Naming source: `src/models/sequence/hyena.py` (`in_proj` / `out_proj`
    Linears, depthwise `short_filter` Conv1d, `filter_fn` = HyenaFilter with
    `pos_emb.z`, the shared `Sin` freq, `implicit_filter.{0,2,4,...}`
    Linears and `modulation.deltas`)."""
    p = (prefix + ".") if prefix and not prefix.endswith(".") else prefix
    g = lambda k: _np(state[p + k])
    f = "filter_fn"
    out: Flat = {
        "in_proj/kernel": g("in_proj.weight").T,
        "in_proj/bias": g("in_proj.bias"),
        "out_proj/kernel": g("out_proj.weight").T,
        "out_proj/bias": g("out_proj.bias"),
        "short_filter_w": g("short_filter.weight")[:, 0, :].T,  # -> (K, C)
        "short_filter_b": g("short_filter.bias"),
        f"{f}/pos_emb_z": g("filter_fn.pos_emb.z")[0],          # -> (L, e)
        f"{f}/sin_freq": g("filter_fn.implicit_filter.1.freq")[0],
        f"{f}/bias": g("filter_fn.bias"),
        f"{f}/deltas": g("filter_fn.modulation.deltas")[0],     # -> (1, d)
        f"{f}/mlp_in/kernel": g("filter_fn.implicit_filter.0.weight").T,
        f"{f}/mlp_in/bias": g("filter_fn.implicit_filter.0.bias"),
        f"{f}/mlp_out/kernel": g(
            f"filter_fn.implicit_filter.{2 * (num_inner_mlps + 1)}.weight").T,
    }
    for i in range(num_inner_mlps):
        lin = f"filter_fn.implicit_filter.{2 * (i + 1)}"
        out[f"{f}/mlp_{i}/kernel"] = g(f"{lin}.weight").T
        out[f"{f}/mlp_{i}/bias"] = g(f"{lin}.bias")
    return out


def import_reference_hyena_lm(state, n_layer: int, attn_layer_idx=(),
                              num_inner_mlps: int = 2) -> Flat:
    """Reference `ConvLMHeadModel` state dict -> flat flax paths of
    `models/hyena.py HyenaLMHeadModel` (``backbone/...``; the head is tied
    to the embedding). A position embedding is imported when the state dict
    has one (build the model with ``max_position_embeddings`` of its rows).

    Naming source: `src/models/sequence/long_conv_lm.py` (GPT2Embeddings,
    flash-attn Block norm1 / norm2 / mixer / mlp, tied lm_head)."""
    g = lambda k: _np(state[k])
    out: Flat = {"backbone/embedding":
                 g("backbone.embeddings.word_embeddings.weight")}
    if "backbone.embeddings.position_embeddings.weight" in state:
        out["backbone/pos_embedding"] = g(
            "backbone.embeddings.position_embeddings.weight")

    def ln(at, p):
        out[f"{at}/scale"] = g(f"{p}.weight")
        out[f"{at}/bias"] = g(f"{p}.bias")

    def dense(at, p):
        out[f"{at}/kernel"] = g(f"{p}.weight").T
        out[f"{at}/bias"] = g(f"{p}.bias")

    for i in range(n_layer):
        p = f"backbone.layers.{i}"
        ln(f"backbone/ln1_{i}", f"{p}.norm1")
        ln(f"backbone/ln2_{i}", f"{p}.norm2")
        if i in attn_layer_idx:
            dense(f"backbone/mixer_{i}/Wqkv", f"{p}.mixer.Wqkv")
            dense(f"backbone/mixer_{i}/out_proj", f"{p}.mixer.out_proj")
        else:
            op = import_reference_hyena_operator(
                state, prefix=f"{p}.mixer", num_inner_mlps=num_inner_mlps)
            out.update({f"backbone/mixer_{i}/{k}": v for k, v in op.items()})
        dense(f"backbone/mlp_{i}/fc1", f"{p}.mlp.fc1")
        dense(f"backbone/mlp_{i}/fc2", f"{p}.mlp.fc2")
    ln("backbone/ln_f", "backbone.ln_f")
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A torch ``.bin`` / ``.pt`` state dict as numpy (on the CPU; a
    Lightning checkpoint's ``"state_dict"`` unwrapped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: _np(v) for k, v in sd.items()}
