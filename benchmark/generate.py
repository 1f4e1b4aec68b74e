"""Traffic made from the seed: the one generator every traffic mix's data
file (`traffic/<mix>.json`) is read by.

- `mlm_batch`: MLM pretraining rows as the port's hg38 loader yields them
  (int32 ``input_ids`` / ``targets``): uniform random bases, 15% of the
  positions chosen, of those 80% [MASK], 10% a random base, 10% kept
  (`caduceus_tpu_torch/data/mlm.py mlm_mask`, with the replacement drawn
  from the four bases); the targets are the chosen positions' bases, the
  ignore id elsewhere.
- `classify_batch`: GenomicBenchmarks-shaped rows (random bases of one
  length) and labels, made on the device.
- `write_genome` / `write_variants`: a genome FASTA of random bases and a
  VEP variant file of single-base substitutions on it (after
  `caduceus_tpu_torch/data/synthetic.py make_synthetic_genome`), each
  variant far enough from the contig ends for a centred window.

Every draw takes (seed, index) as its generator's key, so batch i is the
same whatever came before it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

MASK_ID, PAD_ID = 3, 4
BASE_IDS = np.array([7, 8, 9, 10])      # A, C, G, T
BASES = np.frombuffer(b"ACGT", np.uint8)


def _rng(seed: int, *index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 64), *index])


def mlm_batch(seed: int, index: int, rows: int, length: int,
              mask_prob: float = 0.15) -> Dict[str, np.ndarray]:
    rng = _rng(seed, 1, index)
    seq = BASE_IDS[rng.integers(0, 4, (rows, length))].astype(np.int32)
    chosen = rng.random(seq.shape) < mask_prob
    targets = np.where(chosen, seq, PAD_ID).astype(np.int32)
    replaced = chosen & (rng.random(seq.shape) < 0.8)
    randomized = chosen & ~replaced & (rng.random(seq.shape) < 0.5)
    data = np.where(replaced, MASK_ID, seq)
    words = BASE_IDS[rng.integers(0, 4, seq.shape)]
    data = np.where(randomized, words, data).astype(np.int32)
    return {"input_ids": data, "targets": targets}


def classify_batch(seed: int, index: int, rows: int, length: int,
                   num_labels: int, device) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * (index + 1)) % (2 ** 63))
    ids = torch.randint(7, 11, (rows, length), generator=g, device=device)
    labels = torch.randint(0, num_labels, (rows,), generator=g,
                           device=device)
    lengths = torch.full((rows,), length, dtype=torch.long, device=device)
    return {"input_ids": ids, "labels": labels, "lengths": lengths}


def write_genome(path: str, seed: int, n_contigs: int, contig_len: int,
                 line_width: int = 60) -> Dict[str, np.ndarray]:
    """Write the FASTA; returns {contig name: uint8 bases}."""
    contigs = {}
    with open(path, "wb") as f:
        for c in range(n_contigs):
            seq = BASES[_rng(seed, 2, c).integers(0, 4, contig_len)]
            name = f"chr{c + 1}"
            contigs[name] = seq
            f.write(f">{name}\n".encode())
            body = seq.tobytes()
            for i in range(0, contig_len, line_width):
                f.write(body[i:i + line_width] + b"\n")
    return contigs


def write_variants(path: str, seed: int, contigs: Dict[str, np.ndarray],
                   n: int, window: int) -> list:
    """Write ``n`` variants ``chrom pos ref alt label tss_distance`` (pos
    0-based, a window of ``window`` centred on it inside the contig);
    returns them as tuples."""
    rng = _rng(seed, 3)
    names = sorted(contigs)
    rows = []
    for _ in range(n):
        chrom = names[int(rng.integers(0, len(names)))]
        seq = contigs[chrom]
        pos = int(rng.integers(window // 2, len(seq) - window // 2))
        ref = chr(seq[pos])
        alt = "ACGT".replace(ref, "")[int(rng.integers(0, 3))]
        rows.append((chrom, pos, ref, alt, int(rng.integers(0, 2)),
                     int(rng.integers(0, 200_000))))
    with open(path, "w") as f:
        for r in rows:
            f.write("\t".join(map(str, r)) + "\n")
    return rows
