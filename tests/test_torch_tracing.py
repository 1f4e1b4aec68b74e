"""The port's spans (`caduceus_tpu_torch/utils/tracing.py`) on the CPU.

`span` under a CPU `torch.profiler`: the ``caduceus.*`` host intervals
nest, ``totals`` adds up, a span entered while no profiler records leaves
nothing. `Trainer.fit` (a 1-layer, d_model 16 model, 2 micro-batches a
step, the prefetch thread) puts one ``train.next_batch``, ``train.step``
and ``train.optimizer`` and two ``train.forward`` and ``train.backward``
in each step and one ``train.close_stream`` at the end, and logs
``input_wait_s``. A tiny `dump_embeddings` gives one ``vep.build``, a
``vep.read`` per variant (the skipped one too) and a ``vep.forward`` and
``vep.readout`` per batch.
"""

import json

import numpy as np
import pytest
import torch

from caduceus_tpu_torch import vep
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.data.fasta import FastaFile
from caduceus_tpu_torch.data.synthetic import make_synthetic_genome
from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
from caduceus_tpu_torch.tokenization import CaduceusTokenizer
from caduceus_tpu_torch.train.trainer import Trainer, TrainerConfig
from caduceus_tpu_torch.utils.tracing import span


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are tiny, and the other test
    workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traced(fn, path):
    """Run ``fn`` under a CPU profiler; returns (its result, the
    ``caduceus.*`` spans of the exported trace as (name, start, end), in
    order of start)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("caduceus."))
    return out, [(n, a, b) for a, b, n in spans]


def names(spans):
    return [n for n, _, _ in spans]


def inside(spans, outer):
    """The spans that lie within ``outer``'s interval."""
    _, a, b = outer
    return [s for s in spans if s is not outer and a <= s[1] and s[2] <= b]


def tiny_model(seed=1):
    tok = CaduceusTokenizer()
    cfg = CaduceusConfig.from_dict(dict(
        d_model=16, n_layer=1, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, dtype="float32",
        ssm_cfg=dict(version=1, d_state=4)))
    return cfg, CaduceusForMaskedLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def test_span_nests_and_adds_up(tmp_path):
    totals = {}
    with span("outside", totals):   # no profiler records
        pass

    def work():
        with span("outer", totals):
            for _ in range(2):
                with span("inner", totals):
                    torch.ones(4).sum()

    _, spans = traced(work, tmp_path / "t.json")
    assert names(spans) == ["caduceus.outer", "caduceus.inner",
                            "caduceus.inner"]
    assert names(inside(spans, spans[0])) == ["caduceus.inner"] * 2
    assert inside(spans, spans[1]) == []
    assert set(totals) == {"outside", "outer", "inner"}
    assert 0 < totals["inner"] <= totals["outer"]
    # the span's own host time on the trace's clock (us) is within its total
    assert sum(b - a for n, a, b in spans if n == "caduceus.inner") \
        <= totals["inner"] * 1e6


class _Batches:
    """Seeded MLM-shaped batches of 4 rows of 32 tokens, without end."""

    def __iter__(self):
        rng = np.random.default_rng(0)
        while True:
            yield {"input_ids": rng.integers(7, 11, (4, 32)).astype(np.int32),
                   "targets": rng.integers(0, 12, (4, 32)).astype(np.int32)}


def test_fit_spans_each_step(tmp_path):
    _, model = tiny_model()
    records = []
    t = Trainer(model, TrainerConfig(max_steps=3, log_every=1,
                                     checkpoint_every=100, accum_steps=2,
                                     prefetch=2, run_dir=str(tmp_path / "r")),
                _Batches(), log_fn=records.append)
    t.init_state()
    _, spans = traced(lambda: t.fit(3), tmp_path / "fit.json")
    steps = [s for s in spans if s[0] == "caduceus.train.step"]
    assert len(steps) == 3
    for s in steps:
        assert names(inside(spans, s)) == [
            "caduceus.train.forward", "caduceus.train.backward",
            "caduceus.train.forward", "caduceus.train.backward",
            "caduceus.train.optimizer"]
    # outside the steps: each step's wait for its batch, then its log; at
    # the end the prefetch thread's stop
    nested = [s for st in steps for s in inside(spans, st)]
    assert names(s for s in spans if s not in nested) == [
        "caduceus.train.next_batch", "caduceus.train.step",
        "caduceus.train.log"] * 3 + ["caduceus.train.close_stream"]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(r["input_wait_s"] >= 0 for r in records)


def test_dump_embeddings_spans(tmp_path):
    cfg, model = tiny_model(seed=2)
    fa, _ = make_synthetic_genome(str(tmp_path / "g"), n_chromosomes=1,
                                  chrom_len=1024, window=512, n_frac=0.0)
    fasta = FastaFile(fa)
    rows = []
    for i, pos in enumerate((100, 400, 700, 900)):
        ref = fasta.fetch("chr1", pos, pos + 1)
        alt = "ACGT"[("ACGT".index(ref) + 1) % 4]
        if i == 1:   # a reference base that does not match: skipped
            ref, alt = alt, ref
        rows.append(f"chr1\t{pos}\t{ref}\t{alt}\t{i % 2}\t0")
    fasta.close()
    variants = tmp_path / "variants.tsv"
    variants.write_text("\n".join(rows) + "\n")
    out, spans = traced(lambda: vep.dump_embeddings(
        cfg, model.state_dict(), fa, str(variants), str(tmp_path / "e"),
        seq_len=64, batch_size=2, device="cpu"), tmp_path / "vep.json")
    assert np.load(out)["features"].shape == (3, 32)
    got = names(spans)
    assert got.count("caduceus.vep.build") == 1
    assert got.count("caduceus.vep.read") == 4
    # 3 matching variants in batches of 2: two batches, the second of one
    assert got.count("caduceus.vep.forward") == 2
    assert got.count("caduceus.vep.readout") == 2
    assert got[-1] == "caduceus.vep.write"
    assert [n for n in got if n != "caduceus.vep.read"] == [
        "caduceus.vep.build", "caduceus.vep.forward", "caduceus.vep.readout",
        "caduceus.vep.forward", "caduceus.vep.readout", "caduceus.vep.write"]
