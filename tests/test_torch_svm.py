"""VEP's classifier without scikit-learn (`caduceus_tpu_torch/svm.py`, the
port's `vep.svm_eval`) and the port's metric registry, on the CPU.

- `StandardScaler` against scikit-learn's (a constant and a near-constant
  feature among them): mean, scale and the transform within 1e-12.
- `SVC` against scikit-learn's `SVC` (libsvm) on seeded overlapping
  classes, labels 2 and 5, with free and bounded support vectors at each C
  of {1, 5, 10}: ``gamma="scale"`` within 1e-12 relative; at tol 1e-8 on
  both sides the decision values of the training and of held-out points
  within 1e-6 of their largest magnitude (libsvm keeps its kernel cache in
  float32, so its stop is tol-close to a slightly other problem); at the
  default tol 1e-3 within 2 tol absolute: each solver stops once its
  maximal violating pair's gap is <= tol, on its own path (libsvm shrinks
  its working set and breaks ties the other way), and the two stopping
  points' decision values measure 3.4e-4 to 5.1e-4 apart here.
  The kernel rows computed on demand (`GRAM_BUDGET_BYTES` 0) give the same
  decision values within 1e-9 of their largest magnitude.
- `vep.svm_eval` on a seeded embeddings file against
  `caduceus_tpu.vep.svm_eval` (scikit-learn): ``selected_C`` and ``n``
  equal, every AUROC within one discordant pair's weight 1 / (n_pos n_neg)
  of its split (the two solvers' tol-close scores may order one pair
  differently) where that weight is below 1/4, equal (1e-9) where it is
  not (`auroc_tol`).
- `accuracy_at_k`, `per_class_accuracy`, the `output_metric_fns` keys and
  `make_mlm_eligible_replacements` against the JAX package's.
"""

import numpy as np
import pytest
import torch
from sklearn.preprocessing import StandardScaler as SkScaler
from sklearn.svm import SVC as SkSVC

from caduceus_tpu import tokenization as jax_tok
from caduceus_tpu import vep as jax_vep
from caduceus_tpu.train import metrics as jax_metrics
from caduceus_tpu_torch import svm, tokenization, vep
from caduceus_tpu_torch.svm import SVC, StandardScaler
from caduceus_tpu_torch.train import metrics

CS = (1, 5, 10)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=240, d=16, shift=0.3, seed=0):
    """Two overlapping Gaussian classes (labels 2 and 5) differing in 4 of
    d features, float32 as VEP's features are, and held-out points."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.integers(0, 2, n) == 1, 5, 2)
    X = rng.normal(size=(n, d)) + shift * np.where(y == 5, 1.0, -1.0)[
        :, None] * (np.arange(d) < 4)
    return X.astype(np.float32), y, rng.normal(size=(100, d))


@pytest.fixture(scope="module")
def scaled():
    X, y, Xt = _data()
    Xs = StandardScaler("cpu").fit(X).transform(X).numpy()
    return Xs, y, np.concatenate([Xs, Xt])


def test_scaler_matches_sklearn():
    X, _, _ = _data(n=64)
    X[:, 3] = 1.5                       # constant
    X[:, 5] = 1e-3 + 1e-12 * np.arange(64)   # constant within float32
    mine, sk = StandardScaler("cpu").fit(X), SkScaler().fit(X)
    np.testing.assert_allclose(mine.mean_.numpy(), sk.mean_, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(mine.scale_.numpy(), sk.scale_, rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(mine.transform(X).numpy(), sk.transform(
        X.astype(np.float64)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("C", CS)
def test_svc_matches_sklearn(scaled, C):
    Xs, y, pts = scaled
    for tol in (1e-8, 1e-3):
        sk = SkSVC(C=C, tol=tol).fit(Xs, y)
        mine = SVC(C=C, tol=tol, device="cpu").fit(Xs, y)
        assert list(mine.classes_) == list(sk.classes_) == [2, 5]
        assert mine.gamma_ == pytest.approx(sk._gamma, rel=1e-12)
        a = mine.alpha_.numpy()
        assert ((a > 0) & (a < C)).any() and (a >= C).any(), "free, bounded"
        want, got = sk.decision_function(pts), mine.decision_function(pts)
        if tol == 1e-8:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * tol)
        # positive for classes_[1], as scikit-learn's binary SVC
        assert ((got > 0) == (sk.predict(pts) == 5)).mean() > 0.99


def test_svc_kernel_rows_on_demand_match_the_gram(scaled, monkeypatch):
    Xs, y, pts = scaled
    whole = SVC(C=5, device="cpu").fit(Xs, y).decision_function(pts)
    monkeypatch.setattr(svm, "GRAM_BUDGET_BYTES", 0)
    rows = SVC(C=5, device="cpu").fit(Xs, y).decision_function(pts)
    np.testing.assert_allclose(rows, whole, rtol=0,
                               atol=1e-9 * np.abs(whole).max())


def _pair_weights(path, seeds=(0, 1, 2, 3, 4), train_frac=0.8,
                  val_frac=0.25):
    """The largest 1 / (n_pos n_neg) over the test splits of the seeds
    `vep.svm_eval` scores, and over each TSS bucket of them."""
    d = np.load(path)
    y, tss = d["labels"], d["tss_distance"]
    w = {"overall": 0.0, **{f"{lo}-{hi}": 0.0 for lo, hi in vep.TSS_BUCKETS}}
    for seed in seeds:
        perm = np.random.default_rng(seed).permutation(len(y))
        tr, te = perm[:int(len(y) * train_frac)], perm[int(len(y) *
                                                          train_frac):]
        fit = tr[:-max(1, int(len(tr) * val_frac))]
        if min(len(np.unique(y[s])) for s in (tr, te, fit)) < 2:
            continue                  # the seeds svm_eval skips
        pos = (y[te] == 1).sum()
        w["overall"] = max(w["overall"], 1 / (pos * (len(te) - pos)))
        for lo, hi in vep.TSS_BUCKETS:
            m = (np.abs(tss[te]) >= lo) & (np.abs(tss[te]) < hi)
            p = (y[te][m] == 1).sum()
            if 0 < p < m.sum():
                k = f"{lo}-{hi}"
                w[k] = max(w[k], 1 / (p * (m.sum() - p)))
    return w


def auroc_tol(weight):
    """How far the port's AUROC may be from JAX's on a split whose largest
    pair weight is ``weight``: one discordant pair where a pair weighs less
    than 1/4, else none (1e-9): a split of at most 4 pairs, where one pair
    is a quarter of the AUROC or more, is held to equality."""
    return weight if weight < 0.25 else 1e-9


def test_svm_eval_matches_jax(tmp_path):
    """The whole protocol on a seeded embeddings file of 200 variants (64
    features, the label in a few of them, TSS distances in all three
    buckets): the port on the CPU against the JAX module's scikit-learn
    run."""
    rng = np.random.default_rng(11)
    n = 200
    labels = rng.integers(0, 2, n).astype(np.int32)
    feats = (rng.normal(size=(n, 64))
             + 0.5 * (2 * labels[:, None] - 1) * (np.arange(64) < 6)
             ).astype(np.float32)
    tss = rng.choice([1_000, 50_000, 200_000], n) * rng.choice([-1, 1], n)
    path = str(tmp_path / "emb.npz")
    np.savez(path, features=feats, labels=labels, tss_distance=tss)
    want, got = jax_vep.svm_eval(path), vep.svm_eval(path, device="cpu")
    assert got.keys() == want.keys()
    assert got["selected_C"] == want["selected_C"] and got["n"] == n
    w = {k: auroc_tol(v) for k, v in _pair_weights(path).items()}
    for k in ("auroc_mean", "auroc_std"):
        assert abs(got[k] - want[k]) <= w["overall"], k
    for C in want["per_C"]:
        assert abs(got["per_C"][C] - want["per_C"][C]) <= w["overall"], C
    for b in want["buckets"]:
        assert (got["buckets"][b] is None) == (want["buckets"][b] is None)
        if want["buckets"][b] is not None:
            assert abs(got["buckets"][b] - want["buckets"][b]) <= w[b], b


# -- the metric registry ----------------------------------------------------------

def test_metric_registry_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 40, 16)).astype(np.float32)
    targets = rng.integers(0, 16, (3, 40))
    targets[:, ::7] = 4
    for k in (1, 5, 10):
        assert float(metrics.accuracy_at_k(
            torch.from_numpy(logits), torch.from_numpy(targets), k)) == \
            pytest.approx(float(jax_metrics.accuracy_at_k(logits, targets, k)),
                          abs=1e-7)
    preds, tgt = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    tgt[tgt == 3] = 2                          # class 3: no member
    want = jax_metrics.per_class_accuracy(preds, tgt, 4)
    got = metrics.per_class_accuracy(preds, tgt, 4)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(list(got.values()), list(want.values()))
    assert list(metrics.output_metric_fns) == list(
        jax_metrics.output_metric_fns)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    for name in ("accuracy", "accuracy_ignore_index", "accuracy@5",
                 "accuracy@10"):
        assert float(metrics.output_metric_fns[name](lt, tt)) == \
            pytest.approx(float(jax_metrics.output_metric_fns[name](
                logits, targets)), abs=1e-7), name
    for name in ("mcc", "f1_macro", "f1_micro"):
        assert metrics.output_metric_fns[name](preds, tgt) == pytest.approx(
            jax_metrics.output_metric_fns[name](preds, tgt), abs=1e-12), name
    b_pred, b_tgt = rng.integers(0, 2, 50), rng.integers(0, 2, 50)
    scores = rng.normal(size=50)
    assert metrics.output_metric_fns["f1_binary"](b_pred, b_tgt) == \
        pytest.approx(jax_metrics.output_metric_fns["f1_binary"](
            b_pred, b_tgt), abs=1e-12)
    assert metrics.output_metric_fns["roc_auc"](scores, b_tgt) == \
        pytest.approx(jax_metrics.output_metric_fns["roc_auc"](
            scores, b_tgt), abs=1e-12)


def test_mlm_eligible_replacements_match_jax():
    got = tokenization.make_mlm_eligible_replacements(
        tokenization.CaduceusTokenizer())
    want = jax_tok.make_mlm_eligible_replacements(jax_tok.CaduceusTokenizer())
    assert got.dtype == want.dtype and got.tolist() == want.tolist()
