"""The port's fine-tuning stack against `caduceus_tpu`, on the CPU.

Heads (`models/heads.py`), encoders (`models/encoders.py`), the classifier
of `finetune.py` (forward and gradients, every problem type's loss), one
`finetune_one` trajectory per family from the JAX init, `load_backbone`,
layer-wise lr decay and the weight-decay mask on the classifier tree, the
numpy classification metrics against scikit-learn, the classification
data (batches bit for bit) and the synthetic suite, the export and
/classify (the port's and the JAX package's exports), the
RC-invariance of the RCPS classifiers, and the Hyena and CNN classifiers
(`finetune_one` against JAX's, `cli.py finetune` and /classify of their
exports). Both sides get the same weights
through the bridge (`params.py`) and the same inputs from a seeded numpy
generator; the JAX side runs ``use_kernel="xla"``. The backbones are 2
layers, d_model 32, at the odd length 41 (one ragged chunk of the SSD,
one of the scan).
"""

import contextlib
import io
import json
import os
import sys
import types
import urllib.error
import urllib.request

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from caduceus_tpu import finetune as jax_finetune
from caduceus_tpu.config import CaduceusConfig as JaxConfig
from caduceus_tpu.config import SSMConfig as JaxSSM
from caduceus_tpu.data.classification import (
    ClassificationDataModule as JaxDM,
)
from caduceus_tpu.data.synthetic import (
    make_structured_classification_suite as jax_suite,
)
from caduceus_tpu.models import encoders as jax_encoders
from caduceus_tpu.models.caduceus import (
    CaduceusForSequenceClassification as JaxSeqCls,
)
from caduceus_tpu.models.heads import SequenceDecoder as JaxDecoder
from caduceus_tpu.models.heads import restrict_sequence as jax_restrict
from caduceus_tpu.serve import InferenceServer as JaxServer
from caduceus_tpu.serve import InferenceService as JaxService
from caduceus_tpu.tokenization import CaduceusTokenizer
from caduceus_tpu.train.checkpoint import load_backbone as jax_load_backbone
from caduceus_tpu.train.optim import (
    layer_decay_multipliers as jax_layer_decay,
)
from caduceus_tpu.train.optim import weight_decay_mask as jax_wd_mask
from caduceus_tpu_torch import finetune
from caduceus_tpu_torch.cli import main as cli_main
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.data.classification import (
    ClassificationDataModule,
    make_synthetic_classification_task,
)
from caduceus_tpu_torch.data.fasta import write_fasta
from caduceus_tpu_torch.data.synthetic import (
    make_structured_classification_suite,
    make_synthetic_genome,
)
from caduceus_tpu_torch.models import encoders
from caduceus_tpu_torch.models.caduceus import (
    CaduceusForMaskedLM,
    CaduceusForSequenceClassification,
)
from caduceus_tpu_torch.models.heads import SequenceDecoder, restrict_sequence
from caduceus_tpu_torch.params import (
    flax_path,
    from_jax_params,
    to_jax_params,
)
from caduceus_tpu_torch.serve import InferenceServer, InferenceService
from caduceus_tpu_torch.train import metrics
from caduceus_tpu_torch.train.checkpoint import load_backbone
from caduceus_tpu_torch.train.optim import (
    layer_decay_multipliers,
    weight_decay_mask,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 41          # odd: one ragged SSD chunk (16 rows) and one ragged scan chunk
SEQ_LEN = 37    # task sequences, left-padded to L
TASK = "human_nontata_promoters"   # the name the GB preset carries


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are tiny, and the other test
    workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_config(version=2, rcps=True):
    tok = CaduceusTokenizer()
    ssm = (JaxSSM(version=2, d_state=16, headdim=16, ngroups=1,
                  ssd_chunk_size=16, use_kernel="xla") if version == 2
           else JaxSSM(version=1, d_state=8, use_kernel="xla"))
    return JaxConfig(
        d_model=32, n_layer=2, vocab_size=tok.vocab_size, rcps=rcps,
        complement_map=tok.complement_map, residual_in_fp32=False,
        dtype="float32", param_dtype="float32", ssm_cfg=ssm)


def port_config(jcfg):
    return CaduceusConfig.from_dict(json.loads(json.dumps(jcfg.to_dict())))


def to_flax(state_dict):
    """A port state_dict as a flax variables tree ``{"params": ...}``."""
    flat = to_jax_params(state_dict)
    return {"params": tu.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}


def flatten(tree):
    return {k: np.asarray(v)
            for k, v in tu.flatten_dict(tree["params"], sep="/").items()}


def assert_tree_close(got, want, tol, label="", tols=None):
    """Each tensor within ``tol`` of its largest element (``tols``: a
    bound of its own for the keys ending in one of its names)."""
    assert got.keys() == want.keys(), label
    for k in want:
        w, g = np.asarray(want[k], np.float64), np.asarray(got[k], np.float64)
        assert g.shape == w.shape, (label, k)
        err = np.abs(g - w).max() / (np.abs(w).max() + 1e-30)
        bound = next((t for end, t in (tols or {}).items()
                      if k.endswith(end)), tol)
        assert err <= bound, f"{label} {k}: {err:.2e} of its max"


def padded_ids(rng, B, lengths, conjoin=False, pad_left=True):
    """Random ACGT ids (B, L), each row's pads (id 4) on the padding side;
    ``conjoin`` stacks a second strand on a last axis."""
    ids = rng.integers(7, 11, (B, L, 2) if conjoin else (B, L))
    for i, n in enumerate(lengths):
        if pad_left:
            ids[i, :L - n] = 4
        else:
            ids[i, n:] = 4
    return ids.astype(np.int32)


# --- heads and encoders ------------------------------------------------

@pytest.mark.parametrize("padding_side", ["left", "right"])
@pytest.mark.parametrize("mode", ["last", "first", "sum", "pool", "mean",
                                  "ragged", "max"])
def test_restrict_sequence_matches_jax(mode, padding_side):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, L, 8)).astype(np.float32)
    for lengths in (None, np.array([L, 20, 1, 9], np.int32)):
        want = np.asarray(jax_restrict(
            jnp.asarray(x), mode,
            None if lengths is None else jnp.asarray(lengths), padding_side))
        got = restrict_sequence(
            torch.from_numpy(x), mode,
            None if lengths is None else torch.from_numpy(lengths),
            padding_side).numpy()
        # 1e-6 of the largest value (sums of 41 rows differ in their order)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("mode,padding_side", [("pool", "left"),
                                               ("last", "right")])
def test_decoder_conjoin_matches_jax(mode, padding_side):
    """The shared head over both strands of a (B, L, d, 2) input, averaged,
    and over a plain (B, L, d) input."""
    rng = np.random.default_rng(1)
    lengths = np.array([L, 3, 17], np.int32)
    dec = JaxDecoder(3, mode=mode, use_lengths=True, padding_side=padding_side)
    port = SequenceDecoder(8, 3, mode=mode, use_lengths=True,
                           padding_side=padding_side)
    for shape in ((3, L, 8, 2), (3, L, 8)):
        x = rng.normal(size=shape).astype(np.float32)
        variables = dec.init(jax.random.PRNGKey(0), jnp.asarray(x),
                             jnp.asarray(lengths))
        port.load_state_dict(from_jax_params(flatten(variables), None,
                                             model=port))
        want = np.asarray(dec.apply(variables, jnp.asarray(x),
                                    jnp.asarray(lengths)))
        got = port(torch.from_numpy(x), torch.from_numpy(lengths))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("kind,kw", [
    ("id", {}), ("embedding", {"n_tokens": 16, "d_model": 8}),
    ("linear", {"d_input": 5, "d_model": 8}), ("onehot", {"n_tokens": 16}),
    ("onehot", {"n_tokens": 16, "d_model": 8})])
def test_encoder_matches_jax(kind, kw):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, L, 5)).astype(np.float32) if kind == "linear"
         else rng.integers(0, 12, (2, L)).astype(np.int32))
    enc = jax_encoders.make_encoder(kind, **kw)
    port = encoders.make_encoder(kind, **kw)
    variables = enc.init(jax.random.PRNGKey(3), jnp.asarray(x))
    if "params" in variables:
        port.load_state_dict(from_jax_params(flatten(variables), None,
                                             model=port))
    want = np.asarray(enc.apply(variables, jnp.asarray(x)))
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --- the classifier: forward and gradients -----------------------------

CLASSIFIER_CASES = {
    # name: (version, rcps, pooling, use_lengths, encoder, conjoin)
    "v2_rcps_last": (2, True, "last", False, "id", False),
    "v2_conjoin": (2, False, "mean", True, "id", True),
    "v2_onehot": (2, False, "ragged", True, "onehot", False),
    "v1_rcps_first_lengths_left": (1, True, "first", True, "id", False),
}


# The gradient of the first layer's A_log adds many terms that cancel. For
# "v2_rcps_last" under the multi-label loss, an evaluation of the same
# function in float64 (the port's model with float64 weights and
# activations) puts the JAX fp32 gradient 8.4e-5 of its max away from it and
# the port's 3.9e-5, so the two fp32 gradients differ by 1.2e-4 there: A_log
# is held to 2e-4, every other tensor to 1e-4.
A_LOG_TOL = {"A_log": 2e-4}


def jax_losses(logits, labels_int, labels_multi, labels_reg):
    """(loss, d loss / d logits) of each problem type on JAX logits."""
    fns = {
        "single_label_classification": lambda z: (
            optax.softmax_cross_entropy_with_integer_labels(
                z, labels_int).mean()),
        "multi_label_classification": lambda z: (
            optax.sigmoid_binary_cross_entropy(z, labels_multi).mean()),
        "regression": lambda z: jnp.mean(jnp.square(z[..., 0] - labels_reg)),
    }
    return {k: jax.value_and_grad(f)(logits) for k, f in fns.items()}


@pytest.mark.parametrize("case", sorted(CLASSIFIER_CASES))
def test_classifier_matches_jax(case):
    """Forward and every parameter's gradient of `finetune._make_classifier`
    against `jax.vjp` of `caduceus_tpu.finetune._make_classifier(...).apply`,
    for the loss of each problem type, within 1e-4 of each tensor's max."""
    version, rcps, pooling, use_lengths, encoder, conjoin = (
        CLASSIFIER_CASES[case])
    jcfg = jax_config(version, rcps)
    cfg = port_config(jcfg)
    model = finetune._make_classifier(
        cfg, 3, pooling, use_lengths, "left", encoder=encoder, device="cpu",
        generator=torch.Generator().manual_seed(5))
    variables = to_flax(model.state_dict())
    jmodel = jax_finetune._make_classifier(jcfg, 3, pooling, use_lengths,
                                           "left", encoder=encoder)
    rng = np.random.default_rng(6)
    lengths = np.array([L, 30, 7, 1], np.int32)
    ids = padded_ids(rng, 4, lengths, conjoin=conjoin)
    labels_int = rng.integers(0, 3, 4).astype(np.int32)
    labels_multi = rng.integers(0, 2, (4, 3)).astype(np.float32)
    labels_reg = rng.normal(size=4).astype(np.float32)

    apply = jax.jit(jmodel.apply)
    logits, vjp = jax.vjp(lambda p: apply(p, ids, lengths), variables)
    torch_labels = {"single_label_classification": labels_int,
                    "multi_label_classification": labels_multi,
                    "regression": labels_reg}
    for pt, (loss, g_logits) in jax_losses(
            logits, labels_int, labels_multi, labels_reg).items():
        (g_jax,) = vjp(g_logits)
        model.zero_grad(set_to_none=True)
        out = model(torch.from_numpy(ids), torch.from_numpy(lengths))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits),
                                   rtol=0, atol=1e-5 * float(
                                       np.abs(logits).max()))
        got = finetune.classification_loss(
            out, torch.from_numpy(torch_labels[pt]), pt)
        np.testing.assert_allclose(float(got.detach()), float(loss),
                                   rtol=1e-5)
        got.backward()
        grads = to_jax_params({n: (p.grad if p.grad is not None
                                   else torch.zeros_like(p))
                               for n, p in model.named_parameters()})
        assert_tree_close(grads, flatten(g_jax), 1e-4, f"{case} {pt}",
                          tols=A_LOG_TOL)


def test_backbone_inputs_embeds_matches_jax():
    """A non-RCPS backbone fed precomputed embeddings; RCPS refuses them."""
    from caduceus_tpu.models.caduceus import CaduceusBackbone as JaxBackbone

    jcfg = jax_config(2, rcps=False)
    cfg = port_config(jcfg)
    model = CaduceusForMaskedLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(7))
    emb = np.random.default_rng(8).normal(size=(2, L, 32)).astype(np.float32)
    variables = to_flax({k: v for k, v in model.state_dict().items()
                         if k.startswith("backbone.")})["params"]["backbone"]
    want, _ = jax.jit(lambda p, e: JaxBackbone(jcfg).apply(
        {"params": p}, None, inputs_embeds=e))(variables, emb)
    with torch.inference_mode():
        got, _ = model.backbone(None, inputs_embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    rc = CaduceusForMaskedLM(port_config(jax_config(2)), device="cpu")
    with pytest.raises(ValueError, match="RCPS"):
        rc.backbone(None, inputs_embeds=torch.from_numpy(emb))


@pytest.mark.parametrize("pooling", ["mean", "max", "first", "last"])
def test_sequence_classification_model(pooling):
    """`CaduceusForSequenceClassification` (RCPS) against the JAX module's
    logits (pooling mean runs the JAX side; the others the port's own
    definitions of the strategy), and its RC-invariance under mean pooling:
    the same scores for a sequence and its reverse complement within
    1e-5."""
    jcfg = jax_config(2)
    cfg = port_config(jcfg)
    model = CaduceusForSequenceClassification(
        cfg, num_labels=3, pooling_strategy=pooling, device="cpu",
        generator=torch.Generator().manual_seed(9))
    rng = np.random.default_rng(10)
    ids = rng.integers(7, 11, (2, L)).astype(np.int32)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids)).numpy()
        h = model.backbone(torch.from_numpy(ids))[0]
        pooled = {"mean": h.mean(-2), "max": h.max(-2).values,
                  "first": h[..., 0, :], "last": h[..., -1, :]}[pooling]
        want = ((pooled[0] @ model.score.weight.t()
                 + pooled[1] @ model.score.weight.t()) / 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if pooling != "mean":
        return
    jax_logits = jax.jit(JaxSeqCls(jcfg, num_labels=3).apply)(
        to_flax(model.state_dict()), ids)
    np.testing.assert_allclose(got, np.asarray(jax_logits), rtol=0,
                               atol=1e-5)
    comp = CaduceusTokenizer().complement_array()
    rc = comp[np.flip(ids, -1)].copy()
    with torch.inference_mode():
        got_rc = model(torch.from_numpy(rc)).numpy()
    np.testing.assert_allclose(got_rc, got, rtol=0, atol=1e-5)


def test_finetune_classifier_is_rc_invariant():
    """`_make_classifier` over an RCPS backbone with mean pooling scores a
    sequence and its reverse complement alike, within 1e-5."""
    cfg = port_config(jax_config(1))
    model = finetune._make_classifier(cfg, 2, "mean", False, "left",
                                      device="cpu")
    ids = np.random.default_rng(11).integers(7, 12, (3, L))
    comp = CaduceusTokenizer().complement_array()
    rc = comp[np.flip(ids, -1)].copy()
    with torch.inference_mode():
        a = model(torch.from_numpy(ids))
        b = model(torch.from_numpy(rc))
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5)


# --- load_backbone, layer decay, the weight-decay mask -----------------

def test_load_backbone_layer_decay_and_mask_match_jax():
    cfg = port_config(jax_config(2, rcps=False))
    model = finetune._make_classifier(cfg, 2, "mean", False, "left",
                                      encoder="onehot", device="cpu")
    pre = CaduceusForMaskedLM(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(12))
    pre_sd = {k: v + 0.5 for k, v in pre.state_dict().items()}
    pre_sd["backbone.norm_f_w"] = torch.zeros(7)   # a shape that differs
    merged = load_backbone(pre_sd, model.state_dict())
    want = flatten(jax_load_backbone(to_flax(pre_sd),
                                     to_flax(model.state_dict())))
    got = to_jax_params(merged)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert torch.equal(merged["backbone.norm_f_w"],
                       model.state_dict()["backbone.norm_f_w"])
    assert torch.equal(merged["backbone.layers.1.mixer.in_proj.weight"],
                       pre_sd["backbone.layers.1.mixer.in_proj.weight"])

    tree = to_flax(model.state_dict())
    named = list(model.named_parameters())
    for decay in (0.8, 1.0):
        want = {"/".join(k): v for k, v in tu.flatten_dict(
            jax_layer_decay(tree, decay)["params"]).items()}
        got = {flax_path(n): f
               for n, f in layer_decay_multipliers(named, decay).items()}
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
    want = {"/".join(k): bool(v) for k, v in tu.flatten_dict(
        jax_wd_mask(tree)["params"]).items()}
    got = {flax_path(n): m for n, m in weight_decay_mask(named).items()}
    assert got == want
    assert got["decoder/output_transform/kernel"]
    assert not got["decoder/output_transform/bias"]
    assert got["encoder/proj/kernel"]


# --- finetune_one trajectories -----------------------------------------

def _task(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("task"))
    make_synthetic_classification_task(d, task=TASK, n_train=48, n_test=16,
                                       seq_len=SEQ_LEN, num_classes=2,
                                       seed=3)
    return d


@pytest.fixture(scope="module")
def task_dir(tmp_path_factory):
    return _task(tmp_path_factory)


TRAJECTORIES = {
    # family: finetune_one keywords beyond the shared ones
    "v2": dict(layer_decay=0.9, use_lengths=True, pooling="mean",
               pretrained=True, batch_size=16),
    # one step an epoch: the v1 plain scan costs ~2 s a step on the CPU
    "v1": dict(layer_decay=0.8, freeze_backbone=True, pooling="last",
               pretrained=False, batch_size=32),
}


class _Initialised:
    """A flax module whose ``init`` returns variables computed beforehand
    (the same call, jitted); ``apply`` is the module's."""

    def __init__(self, module, variables):
        self.module, self.variables = module, variables

    def init(self, *args, **kw):
        return self.variables

    def apply(self, *args, **kw):
        return self.module.apply(*args, **kw)


@pytest.fixture(scope="module")
def trajectories(task_dir):
    """{family: (JAX logs, JAX result, JAX best params, port logs, port
    result, port best state_dict)}: 2 epochs, metric all, seed 2, rc_aug,
    both started from the JAX init (recomputed the way JAX's
    `finetune_one` does and handed to the port's classifier)."""
    seed, out = 2, {}
    for family, kw in TRAJECTORIES.items():
        kw = dict(kw)
        jcfg = jax_config(1 if family == "v1" else 2)
        cfg = port_config(jcfg)
        dm_kw = dict(max_length=L, batch_size=kw.pop("batch_size"),
                     rc_aug=True,
                     train_val_split_seed=seed, seed=seed)
        jdm = JaxDM(task_dir, TASK, **dm_kw)
        pdm = ClassificationDataModule(task_dir, TASK, **dm_kw)
        common = dict(epochs=2, seed=seed, metric="all",
                      pooling=kw.pop("pooling"), **kw)
        pretrained = common.pop("pretrained")
        jmodel = jax_finetune._make_classifier(
            jcfg, 2, common["pooling"], common.get("use_lengths", False),
            "left")
        example = next(jdm.batches("train", seed=seed))
        # `finetune_one`'s init (`model.init(PRNGKey(seed), example)`),
        # jitted: JAX's own eager init of it costs seconds a family
        init = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                    jnp.asarray(example["input_ids"]),
                                    jnp.asarray(example["lengths"]))
        jax_pre = port_pre = None
        if pretrained:
            jax_pre = {"params": {"backbone": jax.tree_util.tree_map(
                lambda x: x * 0.9 + 0.01, init["params"]["backbone"])}}
            port_pre = from_jax_params(flatten(jax_pre), cfg,
                                       backbone_only=True)
        jlogs = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_finetune, "_make_classifier",
                       lambda *a, **k: _Initialised(jmodel, init))
            jres, (jbest, _) = jax_finetune.finetune_one(
                jcfg, jdm, 2, pretrained_params=jax_pre, log_fn=jlogs.append,
                return_state=True, **common)

        make = finetune._make_classifier

        def from_jax_init(*a, **k):
            model = make(*a, **k)
            model.load_state_dict(from_jax_params(flatten(init), cfg,
                                                  model=model))
            return model

        plogs = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(finetune, "_make_classifier", from_jax_init)
            pres, pbest = finetune.finetune_one(
                cfg, pdm, 2, pretrained_params=port_pre, log_fn=plogs.append,
                return_state=True, device="cpu", **common)
        out[family] = (jlogs, jres, flatten(jbest), plogs, pres,
                       to_jax_params(pbest))
    return out


@pytest.mark.parametrize("family", sorted(TRAJECTORIES))
def test_finetune_one_matches_jax(trajectories, family):
    """The logged per-epoch loss and val metrics, best_val, the test
    metrics and the best-val params of `finetune_one` against JAX's, from
    the same init (v2: a pretrained backbone grafted, layer decay 0.9,
    length-masked mean pooling; v1: the backbone frozen, layer decay 0.8,
    last-position pooling)."""
    jlogs, jres, jbest, plogs, pres, pbest = trajectories[family]
    assert len(plogs) == len(jlogs) == 3
    for got, want in zip(plogs, jlogs):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{family} {k}")
    assert {"val/accuracy", "val/mcc", "val/f1", "val/roc_auc"} <= set(
        plogs[0])
    assert pres.keys() == jres.keys()
    for k in jres:
        np.testing.assert_allclose(pres[k], jres[k], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{family} {k}")
    assert_tree_close(pbest, jbest, 1e-4, family)


def test_frozen_backbone_still_decays(trajectories):
    """With ``freeze_backbone`` the backbone's gradients are zero but AdamW
    still runs over them: its decayed kernels shrink and its undecayed
    weights hold, in the port as in JAX."""
    *_, jbest, _, _, pbest = trajectories["v1"]
    k = "backbone/layers_0/mixer/in_proj/kernel"
    norm = "backbone/layers_0/norm_w"
    assert np.allclose(pbest[norm], jbest[norm])
    assert np.abs(pbest[k]).sum() < np.abs(jbest[k]).sum() * 1.0001


def test_jax_cnn_export_served_by_port(tmp_path):
    """A JAX CNN export (its Orbax ``params/`` holds the BatchNorm
    ``batch_stats`` root beside ``params``, `caduceus_tpu/finetune.py
    _export_finetuned`) served by the port: /classify gives the JAX
    server's scores (the JAX model's eval forward, running statistics)
    within 1e-5. The statistics are moved off their init (mean 0, var 1),
    so an export read without them would score otherwise."""
    jmodel = jax_finetune._make_classifier(None, 2, "mean", False, "left",
                                           model_kind="cnn")
    ids = np.zeros((2, L_CNN), np.int32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(3), ids)
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.uniform(0.5, 1.5, x.shape)
                              .astype(np.float32)), variables["batch_stats"])
    args = types.SimpleNamespace(
        task="toy", pooling="mean", problem_type="single_label_classification",
        use_lengths=False, conjoin_train=False, conjoin_test=False,
        encoder="id", max_length=L_CNN, save_dir=str(tmp_path / "cnn_export"))
    dm = types.SimpleNamespace(
        tokenizer=types.SimpleNamespace(padding_side="left"),
        train_ds=types.SimpleNamespace(add_eos=False))
    with contextlib.redirect_stdout(io.StringIO()):
        jax_finetune._export_finetuned(
            args, None, "cnn", "accuracy",
            (0.5, 3, ({"params": variables["params"]},
                      {"batch_stats": stats}), 2, dm))
    kw = dict(max_batch=4, linger_ms=30.0)
    jax_server = JaxServer(JaxService.from_run_dir(args.save_dir, **kw),
                           port=0).start()
    port_server = InferenceServer(InferenceService.from_run_dir(
        args.save_dir, device="cpu", **kw), port=0).start()
    try:
        want = _post(jax_server.port, "/classify",
                     {"sequences": CLASSIFY_SEQS})["classify"]
        got = _post(port_server.port, "/classify",
                    {"sequences": CLASSIFY_SEQS})["classify"]
    finally:
        jax_server.stop()
        port_server.stop()
    for g, w in zip(got, want, strict=True):
        assert g["label"] == w["label"]
        np.testing.assert_allclose(g["probs"], w["probs"], rtol=0,
                                   atol=1e-5)


# --- the Hyena and CNN classifiers ---------------------------------------

L_CNN = 64      # the CNN's three conv + pool stages need 57 positions or more
HYENA = dict(d_model=32, n_layer=2, vocab_size=12, l_max=L,
             attn_layer_idx=(1,), num_heads=2, embed_dropout=0.0)


def _all_variables(tree):
    """Flat params and batch statistics of a flax variables tree."""
    out = {}
    for coll in tree.values():
        out.update({k: np.asarray(v) for k, v in
                    tu.flatten_dict(coll, sep="/").items()})
    return out


@pytest.fixture(scope="module")
def kind_trajectories(task_dir):
    """{kind: (JAX logs, result, best variables, port logs, result, best
    state_dict)} of `finetune_one` for ``model_kind`` "hyena" (a JAX
    Hyena LM's backbone grafted, dropout off: its bits cannot match) and
    "cnn" (from scratch, at length 64), 2 epochs, both from the JAX init."""
    from caduceus_tpu.models.hyena import HyenaLMHeadModel as JaxHyenaLM
    from caduceus_tpu_torch.models.hyena import HyenaLMHeadModel

    seed, out = 4, {}
    for kind, length in (("hyena", L), ("cnn", L_CNN)):
        jcfg = dict(HYENA) if kind == "hyena" else None
        dm_kw = dict(max_length=length, batch_size=16,
                     train_val_split_seed=seed, seed=seed)
        jdm = JaxDM(task_dir, TASK, **dm_kw)
        pdm = ClassificationDataModule(task_dir, TASK, **dm_kw)
        common = dict(epochs=2, seed=seed, metric="all", pooling="mean",
                      model_kind=kind)
        jmodel = jax_finetune._make_classifier(jcfg, 2, "mean", False,
                                               "left", model_kind=kind)
        example = next(jdm.batches("train", seed=seed))
        init = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                    jnp.asarray(example["input_ids"]),
                                    jnp.asarray(example["lengths"]))
        jax_pre = port_pre = None
        if kind == "hyena":
            lm = JaxHyenaLM(**{k: v for k, v in HYENA.items()})
            lm_init = jax.jit(lm.init)(jax.random.PRNGKey(9),
                                       np.zeros((1, 8), np.int32))
            jax_pre = {"params": {"backbone": lm_init["params"]["backbone"]}}
            shape = HyenaLMHeadModel(device="cpu", **HYENA)
            port_pre = from_jax_params(flatten(jax_pre), None, model=shape)
        jlogs = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_finetune, "_make_classifier",
                       lambda *a, **k: _Initialised(jmodel, init))
            jres, (jbest, jextra) = jax_finetune.finetune_one(
                jcfg, jdm, 2, pretrained_params=jax_pre, log_fn=jlogs.append,
                return_state=True, **common)
        make = finetune._make_classifier

        def from_jax_init(*a, **k):
            model = make(*a, **k)
            model.load_state_dict(from_jax_params(_all_variables(init), None,
                                                  model=model))
            return model

        plogs = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(finetune, "_make_classifier", from_jax_init)
            pres, pbest = finetune.finetune_one(
                jcfg, pdm, 2, pretrained_params=port_pre,
                log_fn=plogs.append, return_state=True, device="cpu",
                **common)
        out[kind] = (jlogs, jres, _all_variables({**jbest, **jextra}),
                     plogs, pres, to_jax_params(pbest))
    return out


@pytest.mark.parametrize("kind", ["hyena", "cnn"])
def test_finetune_one_hyena_and_cnn_match_jax(kind_trajectories, kind):
    """`finetune_one` of the Hyena classifier (a pretrained backbone
    grafted; its MHA layer at the ragged length 41) and of the CNN (its
    BatchNorm on batch statistics in training, running ones in eval)
    against JAX's, from the same init: the logged training loss within
    1e-4, the best-val parameters (and the CNN's running statistics)
    within 1e-4 of each one's largest element; for Hyena also the val
    and test metrics within 1e-4.

    Four of the CNN's parameters have a gradient of 0 in exact
    arithmetic: each conv bias feeds a BatchNorm, which subtracts its
    batch mean, and bn_1's bias reaches bn_2 as a per-channel constant
    (max-pool and conv_2 carry a constant as a constant). Their gradients
    are rounding noise of either sign in both programs, and AdamW moves
    each by up to lr a step on that sign (here ~1.5e-4 apart after 6
    steps), so they are held to 2·lr·steps; through the running
    statistics that noise moves the
    eval scores by ~5e-4, enough to reorder near-equal scores of the 5
    val sequences, so the CNN's val / test metrics are not compared."""
    jlogs, jres, jbest, plogs, pres, pbest = kind_trajectories[kind]
    assert len(plogs) == len(jlogs) == 3
    for got, want in zip(plogs, jlogs):
        assert got.keys() == want.keys()
        for k in want:
            if kind == "hyena" or k == "loss":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=1e-6, err_msg=f"{kind} {k}")
    assert pres.keys() == jres.keys()
    if kind == "hyena":
        for k in jres:
            np.testing.assert_allclose(pres[k], jres[k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{kind} {k}")
        assert_tree_close(pbest, jbest, 1e-4, kind)
        return
    biases = [k for k in jbest if k.endswith("/bias") and (
        k.startswith("cnn/conv_") or k == "cnn/bn_1/bias")]
    steps = 6   # 3 steps of 16 an epoch (48 train sequences), 2 epochs
    for k in biases:
        np.testing.assert_allclose(pbest.pop(k), jbest.pop(k), rtol=0,
                                   atol=2 * 1e-3 * steps, err_msg=k)
    assert_tree_close(pbest, jbest, 1e-4, kind)
    assert not np.allclose(pbest["cnn/bn_0/var"], 1.0)


# --- metrics -----------------------------------------------------------

METRIC_CASES = [
    ([0, 1, 1, 0, 1, 1], [0, 1, 0, 0, 1, 1], [0.1, 0.9, 0.9, 0.2, 0.9, 0.6]),
    ([1, 1, 1, 1], [0, 1, 1, 0], [0.5, 0.5, 0.5, 0.5]),         # all ties
    ([0, 0, 0, 0], [0, 1, 0, 1], [0.3, 0.3, 0.1, 0.7]),         # one class
    ([2, 0, 1, 1, 2, 0, 0], [2, 0, 2, 1, 1, 0, 2], None),       # 3 classes
]


@pytest.mark.parametrize("preds,targets,scores", METRIC_CASES)
def test_metrics_match_sklearn(preds, targets, scores):
    from sklearn.metrics import (
        f1_score,
        matthews_corrcoef,
        roc_auc_score,
    )

    p, t = np.asarray(preds), np.asarray(targets)
    assert metrics.mcc(p, t) == pytest.approx(matthews_corrcoef(t, p),
                                              abs=1e-12)
    assert metrics.f1(p, t, "macro") == pytest.approx(
        f1_score(t, p, average="macro", zero_division=0), abs=1e-12)
    if scores is None:
        return
    assert metrics.f1(p, t) == pytest.approx(
        f1_score(t, p, zero_division=0), abs=1e-12)
    assert metrics.roc_auc(np.asarray(scores), t) == pytest.approx(
        roc_auc_score(t, scores), abs=1e-12)


def test_metrics_match_sklearn_at_random():
    from sklearn.metrics import (
        f1_score,
        matthews_corrcoef,
        roc_auc_score,
    )

    rng = np.random.default_rng(13)
    for _ in range(50):
        n = int(rng.integers(4, 60))
        t, p = rng.integers(0, 2, n), rng.integers(0, 2, n)
        if len(np.unique(t)) < 2:
            continue
        s = np.round(rng.normal(size=n), 1)   # ties
        assert metrics.roc_auc(s, t) == pytest.approx(roc_auc_score(t, s))
        assert metrics.mcc(p, t) == pytest.approx(matthews_corrcoef(t, p))
        assert metrics.f1(p, t) == pytest.approx(
            f1_score(t, p, zero_division=0))
    with pytest.raises(ValueError, match="two classes"):
        metrics.roc_auc(np.ones(3), np.zeros(3))


def test_finetune_needs_no_sklearn(task_dir, monkeypatch):
    """With scikit-learn blocked, `finetune_one(metric="all")` runs to its
    end and reports mcc, f1 and roc_auc."""
    for name in [m for m in sys.modules if m.split(".")[0] == "sklearn"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError):
        import sklearn  # noqa: F401
    cfg = port_config(jax_config(2))
    dm = ClassificationDataModule(task_dir, TASK, max_length=L, batch_size=16,
                                  train_val_split_seed=1, seed=1)
    res = finetune.finetune_one(cfg, dm, 2, epochs=1, seed=1, metric="all",
                                log_fn=lambda m: None, device="cpu")
    assert {"best_val", "test_accuracy", "test_mcc", "test_f1",
            "test_roc_auc"} <= set(res)
    assert all(np.isfinite(v) for v in res.values())


# --- data --------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(rc_aug=True), dict(conjoin_train=True), dict(conjoin_test=True),
    dict(add_eos=True, rc_aug=True)], ids=["rc_aug", "conjoin_train",
                                           "conjoin_test", "add_eos"])
def test_batches_equal_jax(task_dir, kw):
    """Every split's batches (ids, labels, lengths) over two epochs equal
    the JAX datamodule's bit for bit."""
    args = dict(max_length=L, batch_size=5, train_val_split_seed=4, seed=4,
                **kw)
    jdm, pdm = JaxDM(task_dir, TASK, **args), ClassificationDataModule(
        task_dir, TASK, **args)
    assert pdm.num_classes == jdm.num_classes
    n = 0
    for split in ("train", "val", "test"):
        for epoch in (0, 1):
            for a, b in zip(pdm.batches(split, epoch=epoch, seed=4),
                            jdm.batches(split, epoch=epoch, seed=4),
                            strict=True):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                n += 1
    assert n > 10


def test_structured_suite_matches_jax(tmp_path):
    """`make_structured_classification_suite` writes the JAX function's
    files over a genome whose contigs are all long enough; a contig shorter
    than seq_len is skipped, not raised on; none long enough raises."""
    fa, _ = make_synthetic_genome(str(tmp_path / "g"), n_chromosomes=2,
                                  chrom_len=4096, window=1024)
    tasks = {"a": (2, 251), "b": (3, 200)}
    for fn, d in ((make_structured_classification_suite, "port"),
                  (jax_suite, "jax")):
        fn(str(tmp_path / d), fa, tasks=tasks, n_train=12, n_test=4, seed=5)
    for t in tasks:
        for split in ("train", "test"):
            with open(tmp_path / "port" / t / f"{split}.tsv") as f:
                got = f.read()
            with open(tmp_path / "jax" / t / f"{split}.tsv") as f:
                assert got == f.read()
    short = str(tmp_path / "short.fa")
    write_fasta(short, {"chrS": "ACGT" * 25, "chrL": "ACGTTGCA" * 100})
    make_structured_classification_suite(str(tmp_path / "s"), short,
                                         tasks={"a": (2, 251)}, n_train=20,
                                         n_test=2)
    with open(tmp_path / "s" / "a" / "train.tsv") as f:
        rows = [r.split("\t")[0] for r in f.read().splitlines()]
    assert len(rows) == 20 and all(len(r) == 251 for r in rows)
    with pytest.raises(ValueError, match="seq_len=1000"):
        make_structured_classification_suite(
            str(tmp_path / "t"), short, tasks={"a": (2, 1000)})


# --- export and /classify -------------------------------------------------

def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


CLASSIFY_SEQS = ["ACGTACGTACGTAAGT", "TTGGCCTTGG" * 3, "GATTACA",
                 "A" * 60]   # the last longer than the task's length


def test_cli_finetune_exports_and_serves_classify(task_dir, tmp_path):
    """`cli.py finetune --preset` from a pretraining run dir, 2 seeds and
    ``--save-dir`` on the CPU; the export served: /classify equals a direct
    forward of the exported classifier, the other endpoints answer 400; a
    run dir without parameters raises."""
    cfg = port_config(jax_config(2))
    run = tmp_path / "run"
    run.mkdir()
    cfg.save(str(run / "model_config.json"))
    pre = CaduceusForMaskedLM(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(14))
    np.savez(run / "params.npz", **to_jax_params(pre.state_dict()))
    save = tmp_path / "export"
    argv = ["finetune", "--preset",
            os.path.join(REPO, "configs/downstream/gb", f"{TASK}.yaml"),
            "--data-dir", task_dir, "--pretrained-run-dir", str(run),
            "--max-length", str(L), "--batch-size", "16", "--epochs", "1",
            "--seeds", "1", "2", "--save-dir", str(save), "--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(argv)
    lines = [json.loads(x) for x in out.getvalue().splitlines()
             if x.startswith("{")]
    results = [r for r in lines if "seed" in r and "best_val" in r]
    assert [r["seed"] for r in results] == [1, 2]
    assert "mean_test_accuracy" in lines[-1]
    tc = json.load(open(save / "task_config.json"))
    best = max(results, key=lambda r: r["best_val"])
    assert tc["seed"] == best["seed"] and tc["max_length"] == L
    assert tc["select_metric"] == "accuracy"

    svc = InferenceService.from_run_dir(str(save), device="cpu", max_batch=4)
    assert svc.warmup() == 3
    server = InferenceServer(svc, port=0).start()
    try:
        got = _post(server.port, "/classify",
                    {"sequences": CLASSIFY_SEQS})["classify"]
        for path in ("/logits", "/generate"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server.port, path, {"sequences": ["ACGT"],
                                          "prompt": "ACGT"})
            assert e.value.code == 400
    finally:
        server.stop()
    model = finetune._make_classifier(cfg, 2, "mean", False, "left",
                                      device="cpu")
    flat = dict(np.load(save / "params.npz"))
    model.load_state_dict(from_jax_params(flat, cfg, model=model))
    tok = svc.tok
    ids = np.stack([tok.encode_padded(s, L, add_sep=False)
                    for s in CLASSIFY_SEQS])
    with torch.inference_mode():
        direct = model(torch.from_numpy(ids.astype(np.int64))).numpy()
    for r, s in zip(got, direct):
        e = np.exp(s - s.max())
        np.testing.assert_allclose(r["probs"], e / e.sum(), rtol=0,
                                   atol=1e-6)
        assert r["label"] == int(np.argmax(s))

    empty = tmp_path / "empty"
    empty.mkdir()
    cfg.save(str(empty / "model_config.json"))
    with pytest.raises(FileNotFoundError):
        cli_main(argv[:5] + ["--pretrained-run-dir", str(empty)] + argv[7:])
    for refused in (["--model", "cnn"], ["--model", "hyena"]):
        with pytest.raises(SystemExit):
            cli_main(argv + refused)


def _classify_direct(save, seqs, length):
    """/classify of an export through the server and a direct forward of
    the exported classifier on the same encoded batch."""
    svc = InferenceService.from_run_dir(str(save), device="cpu", max_batch=4)
    tc = svc.task_cfg
    server = InferenceServer(svc, port=0).start()
    try:
        got = _post(server.port, "/classify", {"sequences": seqs})["classify"]
    finally:
        server.stop()
    cfg = (None if tc["model_kind"] == "cnn" else
           dict(tc["model_cfg"], attn_layer_idx=tuple(
               tc["model_cfg"]["attn_layer_idx"])))
    model = finetune._make_classifier(cfg, 2, tc["pooling"], False, "left",
                                      model_kind=tc["model_kind"],
                                      device="cpu", seq_len=length)
    flat = dict(np.load(save / "params.npz"))
    model.load_state_dict(from_jax_params(flat, None, model=model))
    model.eval()
    ids = np.stack([svc.tok.encode_padded(x, length, add_sep=False)
                    for x in seqs])
    with torch.inference_mode():
        direct = model(torch.from_numpy(ids.astype(np.int64))).numpy()
    return tc, got, direct


def test_cli_finetune_hyena_and_cnn_export_and_classify(task_dir, tmp_path):
    """`cli.py finetune` from a Hyena pretraining run dir (the backbone
    family taken from its model_config.json) and ``--model cnn`` from
    scratch, each with ``--save-dir``; /classify of each export equals a
    direct forward of the exported classifier (the CNN in eval mode: its
    running statistics, which the export carries)."""
    from caduceus_tpu_torch.models.hyena import HyenaLMHeadModel

    run = tmp_path / "hyena_run"
    run.mkdir()
    kw = {k: v for k, v in HYENA.items() if k != "embed_dropout"}
    with open(run / "model_config.json", "w") as f:
        json.dump({"model_type": "hyena", "objective": "ntp", "lr": 6e-4,
                   **kw, "attn_layer_idx": [1]}, f)
    pre = HyenaLMHeadModel(device="cpu",
                           generator=torch.Generator().manual_seed(5), **kw)
    np.savez(run / "params.npz", **to_jax_params(pre.state_dict()))
    base = ["finetune", "--data-dir", task_dir, "--task", TASK,
            "--batch-size", "16", "--epochs", "1", "--seeds", "1",
            "--device", "cpu"]
    for name, extra, length in (
            ("hyena", ["--pretrained-run-dir", str(run)], L),
            ("cnn", ["--model", "cnn"], L_CNN)):
        save = tmp_path / f"export_{name}"
        with contextlib.redirect_stdout(io.StringIO()):
            cli_main(base + extra + ["--max-length", str(length),
                                     "--save-dir", str(save)])
        tc, got, direct = _classify_direct(save, CLASSIFY_SEQS, length)
        assert tc["model_kind"] == name and tc["max_length"] == length
        assert (tc["model_cfg"] is None) == (name == "cnn")
        for r, sc in zip(got, direct, strict=True):
            e = np.exp(sc - sc.max())
            np.testing.assert_allclose(r["probs"], e / e.sum(), rtol=0,
                                       atol=1e-6)
            assert r["label"] == int(np.argmax(sc))
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        cli_main(base + ["--model", "cnn", "--pretrained-run-dir", str(run)])


def test_jax_export_served_by_port(tmp_path):
    """A JAX `finetune --save-dir` export (Orbax ``params/`` +
    ``task_config.json``, written by `caduceus_tpu.finetune
    _export_finetuned`) served by the port: /classify gives the JAX
    server's scores within 1e-5 (a non-RCPS model, conjoined strands,
    length-masked pooling, an EOS appended)."""
    jcfg = jax_config(2, rcps=False)
    cfg = port_config(jcfg)
    model = finetune._make_classifier(
        cfg, 3, "ragged", True, "left", device="cpu",
        generator=torch.Generator().manual_seed(15))
    variables = to_flax(model.state_dict())
    args = types.SimpleNamespace(
        task="toy", pooling="ragged", problem_type="single_label_classification",
        use_lengths=True, conjoin_train=True, conjoin_test=False,
        encoder="id", max_length=L, save_dir=str(tmp_path / "jax_export"))
    dm = types.SimpleNamespace(
        tokenizer=types.SimpleNamespace(padding_side="left"),
        train_ds=types.SimpleNamespace(add_eos=True))
    with contextlib.redirect_stdout(io.StringIO()):
        jax_finetune._export_finetuned(args, jcfg, "caduceus", "accuracy",
                                       (0.5, 3, (variables, {}), 3, dm))
    kw = dict(max_batch=4, linger_ms=30.0)
    jax_server = JaxServer(JaxService.from_run_dir(args.save_dir, **kw),
                           port=0).start()
    port_server = InferenceServer(InferenceService.from_run_dir(
        args.save_dir, device="cpu", **kw), port=0).start()
    try:
        want = _post(jax_server.port, "/classify",
                     {"sequences": CLASSIFY_SEQS})["classify"]
        got = _post(port_server.port, "/classify",
                    {"sequences": CLASSIFY_SEQS})["classify"]
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port_server.port}/healthz").read())
    finally:
        jax_server.stop()
        port_server.stop()
    assert health["model"] == {"task": "toy", "num_classes": 3,
                               "model_kind": "caduceus"}
    for g, w in zip(got, want, strict=True):
        assert g["label"] == w["label"]
        np.testing.assert_allclose(g["probs"], w["probs"], rtol=0,
                                   atol=1e-5)
