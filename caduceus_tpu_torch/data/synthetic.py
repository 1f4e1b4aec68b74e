"""Synthetic genome generator for tests and benchmarks.

An owned copy of `make_synthetic_genome` and `make_structured_genome` of
`caduceus_tpu/data/synthetic.py`: the same genome for the same arguments.

Produces a random FASTA + BED pair with the same window contract as the
hg38 assets the reference trains on (BED rows spanning 2^20-base intervals
tagged with train/valid/test splits).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from caduceus_tpu_torch.data.fasta import write_fasta


def make_structured_genome(
    out_dir: str,
    n_chromosomes: int = 6,
    chrom_len: int = 1 << 23,
    window: int = 1 << 20,
    seed: int = 0,
    seg_len: int = 64,
    n_segment_types: int = 256,
    branching: int = 8,
    mutation_rate: float = 0.03,
    repeat_span: int = 1 << 17,
    repeat_len: int = 1 << 13,
    repeats_per_span: int = 4,
    n_run_rate: float = 2e-5,
) -> Tuple[str, str]:
    """Synthetic genome with *learnable*, genome-like structure.

    `make_synthetic_genome` emits i.i.d. uniform bases — fine for
    throughput benches, but a model's loss on it only measures window
    memorization. Architecture-quality comparisons (e.g. the r5
    Mamba-1 vs Mamba-2 matched-token arms) need held-out loss to reflect
    actual sequence-modeling ability, so this generator plants the three
    statistical regimes real genomes have (hg38 itself is unavailable in
    this environment — no egress):

    1. **Local grammar**: chromosomes are concatenations of `seg_len`-base
       segments drawn from a shared library of `n_segment_types` types,
       chained by a sparse first-order Markov process (each type has
       `branching` allowed successors). A model that learns the library
       predicts within-segment bases nearly perfectly and faces ~log
       (branching) nats only at segment boundaries.
    2. **Long-range repeats**: inside every `repeat_span` block (default
       2^17 = the production training seqlen, so the copies land in the
       *same* training sample), `repeats_per_span` spans of `repeat_len`
       bases are copied forward to a uniform position in the block's
       second half. Predicting the mutated copy from its distant source
       requires carrying tens-of-kb of context — the state-capacity axis
       that separates d_state widths.
    3. **Noise floor**: i.i.d. point mutations at `mutation_rate` (plus
       short N-runs at assembly-gap rate) bound achievable loss away from
       zero: the Bayes cross-entropy of the mutation channel is
       ~0.13 nats at the 3% default, vs ln4 = 1.386 for random guessing.

    BED rows are `window`-sized (2^20 = MAX_ALLOWED_LENGTH in production)
    with the same deterministic train/valid/test split pattern as
    `make_synthetic_genome`; the whole genome is a pure function of
    `seed`. Reference anchor: the hg38 window/split contract this feeds is
    `src/dataloaders/datasets/hg38_dataset.py:130-144`.
    """
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    S = n_segment_types
    lib = rng.integers(0, 4, size=(S, seg_len), dtype=np.uint8)
    succ = np.stack(
        [rng.choice(S, size=branching, replace=False) for _ in range(S)]
    )  # (S, branching)

    contigs = {}
    bed_rows = []
    splits = ["train", "train", "train", "valid", "test"]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for c in range(n_chromosomes):
        name = f"chr{c + 1}"
        n_seg = -(-chrom_len // seg_len)
        ids = np.empty(n_seg, np.int64)
        ids[0] = rng.integers(0, S)
        picks = rng.integers(0, branching, size=n_seg)
        row = succ[:, :]  # local alias for the loop
        prev = int(ids[0])
        for i in range(1, n_seg):
            prev = int(row[prev, picks[i]])
            ids[i] = prev
        bases = lib[ids].reshape(-1)[:chrom_len].copy()

        # long-range repeats: src from the block's first half, pasted into
        # its second half (always >= repeat_len downstream, < repeat_span)
        for blk in range(0, chrom_len - repeat_span + 1, repeat_span):
            half = repeat_span // 2
            for _ in range(repeats_per_span):
                src = int(rng.integers(0, half - repeat_len))
                dst = int(rng.integers(half, repeat_span - repeat_len))
                bases[blk + dst : blk + dst + repeat_len] = bases[
                    blk + src : blk + src + repeat_len
                ]

        # i.i.d. point mutations (uniform replacement, so the effective
        # flip rate is 3/4 * mutation_rate)
        mut = rng.random(chrom_len) < mutation_rate
        bases[mut] = rng.integers(0, 4, size=int(mut.sum()), dtype=np.uint8)

        chars = acgt[bases]
        # assembly-gap N runs (ignored by the loss via N->PAD)
        n_runs = rng.poisson(n_run_rate * chrom_len)
        for _ in range(n_runs):
            start = int(rng.integers(0, chrom_len - 512))
            length = int(rng.integers(32, 512))
            chars[start : start + length] = ord("N")
        contigs[name] = chars.tobytes().decode()
        for w, start in enumerate(range(0, chrom_len - window + 1, window)):
            bed_rows.append(
                (name, start, start + window, splits[(c * 7 + w) % len(splits)])
            )

    fasta_path = os.path.join(out_dir, "genome.fa")
    bed_path = os.path.join(out_dir, "intervals.bed")
    write_fasta(fasta_path, contigs)
    with open(bed_path, "w") as f:
        for chr_name, s, e, split in bed_rows:
            f.write(f"{chr_name}\t{s}\t{e}\t{split}\n")
    return fasta_path, bed_path


def make_synthetic_genome(
    out_dir: str,
    n_chromosomes: int = 2,
    chrom_len: int = 1 << 16,
    window: int = 1 << 14,
    seed: int = 0,
    n_frac: float = 0.01,
) -> Tuple[str, str]:
    """Write `genome.fa` + `intervals.bed`; returns (fasta_path, bed_path).

    `window` plays the role of MAX_ALLOWED_LENGTH (2^20 in production); use a
    smaller power of two for fast tests.
    """
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    probs = np.array([0.25, 0.25, 0.25, 0.25, 0.0])
    probs = probs * (1 - n_frac)
    probs[4] = n_frac
    contigs = {}
    bed_rows = []
    splits = ["train", "train", "train", "valid", "test"]
    for c in range(n_chromosomes):
        name = f"chr{c + 1}"
        seq = alphabet[rng.choice(5, size=chrom_len, p=probs)].tobytes().decode()
        contigs[name] = seq
        for w, start in enumerate(range(0, chrom_len - window + 1, window)):
            bed_rows.append((name, start, start + window, splits[(c * 7 + w) % len(splits)]))
    fasta_path = os.path.join(out_dir, "genome.fa")
    bed_path = os.path.join(out_dir, "intervals.bed")
    write_fasta(fasta_path, contigs)
    with open(bed_path, "w") as f:
        for chr_name, s, e, split in bed_rows:
            f.write(f"{chr_name}\t{s}\t{e}\t{split}\n")
    return fasta_path, bed_path
