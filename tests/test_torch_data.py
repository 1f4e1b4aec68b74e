"""The port's data pipeline (`caduceus_tpu_torch/data`) against
`caduceus_tpu.data`, on the CPU.

One FASTA written in the test (two contigs of uneven length, lines of 73
bases, an N run near a contig's end) and its BED of 2^12-base rows; windows
of 256 tokens. The port's loader gives the JAX loader's batches bit for bit
(MLM, NTP with and without EOS, rc-aug, each rank of a world of 2; the
window clamped at a contig's end and the window over the N run by index);
the native loader, built here from `native/dataloader.cc` with g++, gives
the port's Python batches; a sampler restored from its state continues the
same stream; the FASTA index written by one package is read by the other;
the masking and the synthetic genomes equal the JAX package's.
"""

import os

import numpy as np
import pytest

from caduceus_tpu.data import fasta as jax_fasta
from caduceus_tpu.data import hg38 as jax_hg38
from caduceus_tpu.data import mlm as jax_mlm
from caduceus_tpu.data import sampler as jax_sampler
from caduceus_tpu.data import synthetic as jax_synthetic
from caduceus_tpu_torch.data import fasta, hg38, mlm, native, sampler, synthetic

L = 256
N_RUN = (5000, 5200)   # [start, end) of chr2's N run


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("genome")
    rng = np.random.default_rng(11)
    acgt = np.array(list("ACGT"))
    chr1 = "".join(acgt[rng.integers(0, 4, 3 * 4096 + 100)])
    chr2 = list(acgt[rng.integers(0, 4, 5300)])
    chr2[N_RUN[0]:N_RUN[1]] = "N" * (N_RUN[1] - N_RUN[0])
    path = str(d / "genome.fa")
    fasta.write_fasta(path, {"chr1": chr1, "chr2": "".join(chr2)},
                      line_width=73)
    splits = ["train", "valid", "train", "test"]
    rows = [("chr1", s, splits[i]) for i, s in enumerate(range(0, 3 * 4096, 4096))]
    rows += [("chr2", 0, "train"), ("chr2", 4096, "test")]
    bed = str(d / "intervals.bed")
    with open(bed, "w") as f:
        for c, s, split in rows:
            f.write(f"{c}\t{s}\t{s + 4096}\t{split}\n")
    return path, bed


CASES = {
    "mlm": {},
    "ntp": dict(mlm=False),
    "ntp_eos": dict(mlm=False, add_eos=True),
    "rc_aug": dict(rc_aug=True),
    "rank0_of_2": dict(rank=0, world_size=2),
    "rank1_of_2": dict(rank=1, world_size=2),
}


def _batches(loader, n):
    out = []
    for b in loader:
        out.append(b)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("case", CASES)
def test_loader_batches_match_jax(genome, case):
    """Six train batches (shuffled over all 2^20 / 256 shifts of every
    row), the first valid batch, and by index the window clamped at chr1's
    end and the window over chr2's N run: every array bit-equal."""
    fa, bed = genome
    kw = dict(max_length=L, batch_size=4, seed=5, **CASES[case])
    want = jax_hg38.HG38DataModule(bed, fa, **kw)
    got = hg38.HG38DataModule(bed, fa, **kw)
    for a, b in zip(_batches(want.train_loader(), 6) +
                    _batches(want.eval_loader("valid"), 1),
                    _batches(got.train_loader(), 6) +
                    _batches(got.eval_loader("valid"), 1)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    ds, jds = got.train_ds, want.train_ds
    # row 1 (chr1 at 8192): its last shifts pass chr1's end (12388) and
    # are shifted back inside it
    clamp = 1 * ds.shifts + ds.shifts - 1
    assert ds._window(1, ds.shifts - 1) == ("chr1", 12388 - L, 12388)
    # row 2 (chr2 at 0): shift 20 passes chr2's end too; shifted back, it
    # ends in the N run
    n_run = 2 * ds.shifts + 20
    window = ds._window(2, 20)
    assert window == ("chr2", 5300 - L, 5300)
    ids = ds.fasta.fetch_ids(*window, ds._byte_table)
    assert (ids == 11).sum() == N_RUN[1] - (5300 - L)
    for idx in (clamp, n_run):
        for epoch in (0, 3):
            for x, y in zip(ds.get(idx, epoch), jds.get(idx, epoch)):
                np.testing.assert_array_equal(x, y)


def test_sampler_resumes_from_its_state():
    s = sampler.ShardedShuffleSampler(37, seed=4, rank=1, world_size=2)
    j = jax_sampler.ShardedShuffleSampler(37, seed=4, rank=1, world_size=2)
    it = iter(s)
    head = [next(it) for _ in range(7)]
    state = s.state_dict()
    assert state == {"epoch": 0, "counter": 14}
    rest = list(it) + list(s)   # the end of epoch 0, then epoch 1
    back = sampler.ShardedShuffleSampler(37, seed=4, rank=1, world_size=2)
    back.load_state_dict(state)
    assert list(back) + list(back) == rest
    assert head + rest == list(j) + list(j)


def test_native_loader_matches_python(genome):
    """The port's native loader (g++ at first use, into build/native/,
    never the prebuilt native/libcaduceus_data.so) against its Python
    loader and the JAX loader, MLM with rc-aug and NTP."""
    fa, bed = genome
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path) != "libcaduceus_data.so"
    nf, py_fa = native.NativeFasta(fa), fasta.FastaFile(fa)
    table = hg38.CaduceusTokenizer()._byte_table
    assert nf.chr_lens == py_fa.chr_lens
    for name, s, e in (("chr1", 0, 12388), ("chr2", 4990, 5300)):
        np.testing.assert_array_equal(nf.fetch_ids(name, s, e),
                                      py_fa.fetch_ids(name, s, e, table))
    nf.close()
    py_fa.close()
    for kw in (dict(rc_aug=True), dict(mlm=False)):
        kw.update(max_length=L, batch_size=4, seed=9)
        nat = hg38.HG38DataModule(bed, fa, use_native=True, **kw)
        py = hg38.HG38DataModule(bed, fa, **kw)
        ref = jax_hg38.HG38DataModule(bed, fa, **kw)
        loader = nat.train_loader()
        try:
            for a, b, c in zip(_batches(loader, 8), _batches(py.train_loader(), 8),
                               _batches(ref.train_loader(), 8)):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
                    np.testing.assert_array_equal(a[k], c[k])
        finally:
            loader.close()


def test_native_loader_raises_when_it_cannot_build(genome, tmp_path,
                                                   monkeypatch):
    fa, bed = genome
    bad = tmp_path / "dataloader.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native loader"):
        hg38.HG38DataModule(bed, fa, max_length=L, batch_size=4,
                            use_native=True).train_loader()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fasta_index_is_shared(genome, tmp_path, writer):
    """An index written by one package is read, not rebuilt, by the
    other, and gives the same windows."""
    src, _ = genome
    path = str(tmp_path / "g.fa")
    with open(src) as f, open(path, "w") as g:
        g.write(f.read())
    first, second = ((jax_fasta, fasta) if writer == "jax"
                     else (fasta, jax_fasta))
    a = first.FastaFile(path)
    idx = path + ".ctpu_idx.npz"
    stamp = os.stat(idx).st_mtime_ns
    b = second.FastaFile(path)
    assert os.stat(idx).st_mtime_ns == stamp
    assert a.chr_lens == b.chr_lens == {"chr1": 12388, "chr2": 5300}
    table = np.arange(256, dtype=np.int32)
    for name, s, e in (("chr1", 0, 12388), ("chr1", 70, 300),
                       ("chr2", 4990, 5300)):
        np.testing.assert_array_equal(a.fetch_ids(name, s, e, table),
                                      b.fetch_ids(name, s, e, table))
    a.close()
    b.close()


def test_masking_matches_jax():
    rng_seq = np.random.default_rng(0).integers(4, 12, 999).astype(np.int32)
    for seed in (0, 7):
        a = mlm.mlm_mask(rng_seq, np.random.default_rng(seed))
        b = jax_mlm.mlm_mask(rng_seq, np.random.default_rng(seed))
        base = mlm.splitmix_base(seed, 2, 12345)
        assert base == jax_mlm.splitmix_base(seed, 2, 12345)
        c = mlm.mlm_mask_splitmix(rng_seq, base, mlm_probability=0.3)
        d = jax_mlm.mlm_mask_splitmix(rng_seq, base, mlm_probability=0.3)
        for x, y in zip(a + c, b + d):
            np.testing.assert_array_equal(x, y)


def test_synthetic_genomes_match_jax(tmp_path):
    for name, kw in (("make_synthetic_genome", dict(chrom_len=1 << 13,
                                                    window=1 << 11)),
                     ("make_structured_genome", dict(
                         n_chromosomes=2, chrom_len=1 << 13, window=1 << 11,
                         repeat_span=1 << 12, repeat_len=1 << 8,
                         n_run_rate=5e-4))):
        paths = []
        for pkg, sub in ((synthetic, "port"), (jax_synthetic, "jax")):
            paths.append(getattr(pkg, name)(str(tmp_path / name / sub), **kw))
        for a, b in zip(*paths):
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), (name, a)
