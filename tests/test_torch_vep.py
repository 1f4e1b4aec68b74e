"""The port's VEP pipeline (`caduceus_tpu_torch/vep.py`) against
`caduceus_tpu.vep`, on the CPU.

A synthetic genome (the port's `make_synthetic_genome`, 2 contigs of 4,096
bases) and 17 variants, one of them with a reference base that does not
match (skipped by both), some near a contig's ends (clamped windows).
`dump_embeddings` at seq_len 256 for an RCPS model (strand-mean collapse)
and a non-RCPS one (reverse-complement forwards averaged in): features
within 1e-5 of their max, labels and TSS distances equal; `svm_eval` on the
port's file against JAX's on JAX's: ``selected_C`` equal, every AUROC
equal (1e-9), since each test split here has 4 rows and one pair weighs 1/4
or more (the port's solver is not libsvm: tests/test_torch_svm.py
`auroc_tol`); ``cli.py vep --svm`` on the CPU, also
with scikit-learn blocked. Both sides get the
same 2-layer, d_model 32 weights through the bridge; the JAX side runs
``use_kernel="xla"``.
"""

import contextlib
import io
import json
import sys

import flax.traverse_util as tu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caduceus_tpu import vep as jax_vep
from caduceus_tpu.config import CaduceusConfig as JaxConfig
from caduceus_tpu.config import SSMConfig as JaxSSM
from caduceus_tpu.tokenization import CaduceusTokenizer
from caduceus_tpu_torch import vep
from caduceus_tpu_torch.cli import main as cli_main
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.data.fasta import FastaFile
from caduceus_tpu_torch.data.synthetic import make_synthetic_genome
from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
from caduceus_tpu_torch.params import to_jax_params
from test_torch_svm import _pair_weights, auroc_tol

SEQ_LEN, BATCH = 256, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are tiny, and the other test
    workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_config(rcps):
    tok = CaduceusTokenizer()
    return JaxConfig(
        d_model=32, n_layer=2, vocab_size=tok.vocab_size, rcps=rcps,
        complement_map=tok.complement_map, residual_in_fp32=False,
        dtype="float32", param_dtype="float32",
        ssm_cfg=JaxSSM(version=2, d_state=16, headdim=16, ngroups=1,
                       ssd_chunk_size=16, use_kernel="xla"))


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """(fasta, variants TSV): 16 variants whose reference base matches and
    one whose does not (the 5th row)."""
    d = tmp_path_factory.mktemp("vep")
    fa, _ = make_synthetic_genome(str(d / "g"), n_chromosomes=2,
                                  chrom_len=4096, window=1024, n_frac=0.0)
    fasta = FastaFile(fa)
    rng = np.random.default_rng(0)
    rows = []
    positions = [5, 4090, 200, 3000] + [int(p) for p in
                                        rng.integers(300, 3800, 13)]
    for i, pos in enumerate(positions):
        chrom = f"chr{1 + i % 2}"
        ref = fasta.fetch(chrom, pos, pos + 1)
        alt = "ACGT"[("ACGT".index(ref) + 1 + i % 3) % 4]
        if i == 4:   # a record whose reference base does not match
            ref, alt = alt, ref
        tss = [1_000, 50_000, 200_000][i % 3] * (-1 if i % 4 == 0 else 1)
        rows.append(f"{chrom}\t{pos}\t{ref}\t{alt}\t{i % 2}\t{tss}")
    fasta.close()
    variants = str(d / "variants.tsv")
    with open(variants, "w") as f:
        f.write("# chrom\tpos\tref\talt\tlabel\ttss_distance\n")
        f.write("\n".join(rows) + "\n")
    return fa, variants


def _model(rcps, seed):
    jcfg = jax_config(rcps)
    cfg = CaduceusConfig.from_dict(json.loads(json.dumps(jcfg.to_dict())))
    model = CaduceusForMaskedLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(seed))
    flat = to_jax_params({k: v for k, v in model.state_dict().items()
                          if k.startswith("backbone.")})
    jparams = {"params": tu.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    return jcfg, cfg, model.state_dict(), jparams


@pytest.mark.parametrize("rcps", [True, False], ids=["rcps", "rc_forwards"])
def test_dump_embeddings_matches_jax(genome, tmp_path, rcps):
    fa, variants = genome
    jcfg, cfg, params, jparams = _model(rcps, seed=1 + rcps)
    jout = jax_vep.dump_embeddings(jcfg, jparams, fa, variants,
                                   str(tmp_path / "jax"), seq_len=SEQ_LEN,
                                   batch_size=BATCH)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pout = vep.dump_embeddings(cfg, params, fa, variants,
                                   str(tmp_path / "port"), seq_len=SEQ_LEN,
                                   batch_size=BATCH, device="cpu")
    assert out.getvalue() == ""   # the peak-memory line is the card's
    j, p = np.load(jout), np.load(pout)
    assert p["features"].shape == j["features"].shape == (16, 64)
    np.testing.assert_array_equal(p["labels"], j["labels"])
    np.testing.assert_array_equal(p["tss_distance"], j["tss_distance"])
    scale = np.abs(j["features"]).max()
    np.testing.assert_allclose(p["features"], j["features"], rtol=0,
                               atol=1e-5 * scale)
    jpath = jax_vep.combine_embeddings(str(tmp_path / "jax"), 1)
    ppath = vep.combine_embeddings(str(tmp_path / "port"), 1)
    want, got = jax_vep.svm_eval(jpath), vep.svm_eval(ppath, device="cpu")
    assert got.keys() == want.keys()
    assert got["selected_C"] == want["selected_C"] and got["n"] == 16
    w = {k: auroc_tol(v) for k, v in _pair_weights(ppath).items()}
    for k in ("auroc_mean", "auroc_std"):
        assert got[k] == pytest.approx(want[k], abs=w["overall"])
    for k in ("buckets", "per_C"):
        assert got[k].keys() == want[k].keys()
        for b in want[k]:
            assert (got[k][b] is None) == (want[k][b] is None), (k, b)
            if want[k][b] is not None:
                assert got[k][b] == pytest.approx(
                    want[k][b], abs=w["overall" if k == "per_C" else b])


def test_extract_embeddings_matches_jax():
    h = np.random.default_rng(3).normal(size=(3, 2000, 4)).astype(np.float32)
    idx = np.array([10, 1000, 1990])
    np.testing.assert_array_equal(vep.extract_embeddings(h, idx),
                                  jax_vep.extract_embeddings(h, idx))


def test_cli_vep_svm_on_cpu(genome, tmp_path, monkeypatch):
    """``cli.py vep --svm --device cpu`` on a run dir (``params.npz``):
    the embeddings equal a direct `dump_embeddings`, the SVM summary is
    printed last; with scikit-learn blocked, ``--svm`` scores the same
    (the port's SVM does not import it)."""
    fa, variants = genome
    _, cfg, params, _ = _model(True, seed=4)
    run = tmp_path / "run"
    run.mkdir()
    cfg.save(str(run / "model_config.json"))
    np.savez(run / "params.npz", **to_jax_params(params))
    argv = ["vep", "--fasta", fa, "--variants", variants, "--run-dir",
            str(run), "--out", str(tmp_path / "cli"), "--seq-len",
            str(SEQ_LEN), "--batch-size", str(BATCH), "--svm", "--device",
            "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(argv)
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert lines[0] == {"embeddings": str(tmp_path / "cli") + ".npz"}
    assert lines[-1]["n"] == 16 and "auroc_mean" in lines[-1]
    direct = vep.dump_embeddings(cfg, params, fa, variants,
                                 str(tmp_path / "direct"), seq_len=SEQ_LEN,
                                 batch_size=BATCH, device="cpu")
    np.testing.assert_array_equal(np.load(direct)["features"],
                                  np.load(lines[0]["embeddings"])["features"])

    monkeypatch.setitem(sys.modules, "sklearn", None)
    blocked = argv[:argv.index("--out") + 1] + [str(tmp_path / "blocked")] + \
        argv[argv.index("--out") + 2:]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(blocked)
    assert json.loads(out.getvalue().splitlines()[-1]) == lines[-1]
