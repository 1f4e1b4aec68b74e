"""Variant effect prediction through the port's `vep.dump_embeddings`.

Set-up builds the scan kernels, writes a seeded genome FASTA and variant
file under TMPDIR, makes the backbone's weights, and warms the path with
one call over one batch of variants. The window is one
`dump_embeddings` call over as many variants as the warm-up's rate fits
into ``--seconds`` (a whole number of batches). The reference then
recomputes the features of a seeded sample of the window's variants.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import flops as flops_mod
from benchmark.generate import write_genome, write_variants
from benchmark.harness import Context, release
from benchmark.weights import make_weights

POOL_BP = 1536          # the window `dump_embeddings` pools around a variant
BASE_ID = np.zeros(256, np.int64)
BASE_ID[np.frombuffer(b"ACGT", np.uint8)] = (7, 8, 9, 10)


class Entry:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        t = ctx.cell.traffic
        self.L, self.batch = t["seq_len"], t["batch"]

    def setup(self) -> dict:
        from caduceus_tpu_torch.config import CaduceusConfig
        from caduceus_tpu_torch.models.caduceus import Caduceus

        ctx, t = self.ctx, self.ctx.cell.traffic
        parts = {}
        t0 = time.perf_counter()
        if ctx.device.type == "cuda":
            from caduceus_tpu_torch.ops import scan
            scan.build()
        parts["kernels_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mc = ctx.cell.model_cfg
        self.cfg = CaduceusConfig(**mc)
        shapes = [(n, p.shape) for n, p in
                  Caduceus(self.cfg, device="meta").named_parameters()]
        self.w0 = make_weights(shapes, mc, ctx.seed, ctx.device)
        parts["model_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.fasta = os.path.join(ctx.tmp, "genome.fa")
        self.contigs = write_genome(self.fasta, ctx.seed, t["contigs"],
                                    t["contig_len"])
        self.variants = write_variants(
            os.path.join(ctx.tmp, "all_variants.tsv"), ctx.seed,
            self.contigs, t["max_variants"], self.L)
        parts["inputs_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # a cold call over one batch, then a warm one over two: the
        # window's size comes from the warm call's time a batch
        self._dump(self.variants[:self.batch], "warm")
        t1 = time.perf_counter()
        self._dump(self.variants[:2 * self.batch], "warm")
        ctx.sync()
        t2 = time.perf_counter()
        self.batch_s = (t2 - t1) / 2
        parts["warmup_s"] = t2 - t0
        return parts

    def _dump(self, rows, tag: str) -> np.ndarray:
        from caduceus_tpu_torch.vep import dump_embeddings

        path = os.path.join(self.ctx.tmp, f"{tag}.tsv")
        with open(path, "w") as f:
            for r in rows:
                f.write("\t".join(map(str, r)) + "\n")
        out = dump_embeddings(self.cfg, self.w0, self.fasta, path,
                              os.path.join(self.ctx.tmp, tag),
                              seq_len=self.L, batch_size=self.batch,
                              device=self.ctx.device)
        with np.load(out) as z:
            return z["features"]

    def _run(self, n: int) -> dict:
        n = min(n, len(self.variants) - self.batch)
        rows = self.variants[self.batch:self.batch + n]
        t0 = time.perf_counter()
        self.features = self._dump(rows, "window")
        self.ctx.sync()
        elapsed = time.perf_counter() - t0
        self.window_rows = rows
        done = int(self.features.shape[0]) if self.features.ndim == 2 else 0
        bad = int((~np.isfinite(self.features)).any(axis=1).sum()) if done \
            else 0
        return {"variants": done, "elapsed_s": elapsed, "attempted": n,
                "failed": n - done + bad, "batch_s_setup": self.batch_s}

    def window(self, seconds: float) -> dict:
        batches = max(1, round(seconds / self.batch_s))
        return self._run(batches * self.batch)

    def traced(self) -> dict:
        return self._run(self.ctx.cell.settings["trace_variants"])

    def finish(self, work: dict) -> dict:
        return work

    def end_to_end(self, work: dict) -> dict:
        return {"vep_variants_per_s": work["variants"] / work["elapsed_s"]}

    def shapes(self) -> dict:
        return {"G": 2 * 2 * self.batch, "L": self.L}

    def flops(self, work: dict) -> float:
        return work["variants"] * flops_mod.forward_flops(
            self.ctx.cell.model_cfg, 2, self.L, "none")

    def release(self) -> None:
        release()

    # -- comparison --------------------------------------------------------------
    def sample(self) -> list:
        n = len(self.window_rows)
        k = min(self.ctx.cell.settings["reference_variants"], n)
        rng = np.random.default_rng([self.ctx.seed % 2 ** 64, 4])
        return sorted(rng.choice(n, size=k, replace=False).tolist())

    def window_ids(self, chrom: str, pos: int, alt: str):
        start = pos - self.L // 2
        seq = self.contigs[chrom][start:start + self.L]
        ids = BASE_ID[seq]
        alt_ids = ids.copy()
        alt_ids[pos - start] = BASE_ID[ord(alt)]
        return np.stack([ids, alt_ids]), pos - start

    def reference(self, lowp: bool = False) -> np.ndarray:
        from benchmark.reference.model import Model, set_fp32_math

        set_fp32_math()
        model = Model(self.ctx.cell.model_cfg, self.w0, lowp)
        feats = []
        with torch.no_grad():
            for i in self.sample():
                chrom, pos, _, alt = self.window_rows[i][:4]
                ids, idx = self.window_ids(chrom, pos, alt)
                h = model.strand_mean_hidden(
                    torch.from_numpy(ids).to(self.ctx.device))
                lo = max(0, idx - POOL_BP // 2)
                hi = min(self.L, idx + POOL_BP // 2)
                emb = h[:, lo:hi].mean(1)
                feats.append(torch.cat([emb[0], emb[1]]).cpu())
        return torch.stack(feats)

    def check(self) -> dict:
        from benchmark.compare import feature_gap

        idx = self.sample()
        prog = torch.from_numpy(self.features[idx])
        return {"feature_gap": feature_gap(prog, self.reference())}
