"""Downstream classification datasets: GenomicBenchmarks and Nucleotide
Transformer tasks.

An owned copy of `caduceus_tpu/data/classification.py` (no JAX there, but
the port imports nothing of the JAX package): the same task catalogs and
`NT_TASK_METRICS` (`:33-62`), `load_tsv`, `multi_hot`, `train_val_split`,
`SeqClassificationDataset` (rc_aug drawn from (seed, epoch, idx), the
conjoin rules of `:134-137`), `ClassificationDataModule.batches` (`:251`)
and `make_synthetic_classification_task` (`:277`). Its batches equal the
JAX module's bit for bit (tests/test_torch_finetune.py).

- char tokenization, fixed-length padding (left side by default);
- optional SEP append (`add_eos`);
- `conjoin` mode returns (L, 2) int ids: forward and reverse-complement
  strands stacked on the last axis;
- a seeded 90/10 train/val split.

Tasks are read from local files, ``<data_dir>/<task>/{train,test}.tsv``
(``sequence<TAB>label``).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from caduceus_tpu_torch.tokenization import (
    CharacterTokenizer,
    string_reverse_complement,
)

# Task catalogs (names from the reference configs,
# `configs/dataset/genomic_benchmark.yaml` / `nucleotide_transformer.yaml`).
GENOMIC_BENCHMARK_TASKS = {
    "dummy_mouse_enhancers_ensembl": 2,
    "demo_coding_vs_intergenomic_seqs": 2,
    "demo_human_or_worm": 2,
    "human_enhancers_cohn": 2,
    "human_enhancers_ensembl": 2,
    "human_ensembl_regulatory": 3,
    "human_nontata_promoters": 2,
    "human_ocr_ensembl": 2,
}

NUCLEOTIDE_TRANSFORMER_TASKS = {
    "enhancers": 2,
    "enhancers_types": 3,
    "H3": 2, "H3K4me1": 2, "H3K4me2": 2, "H3K4me3": 2,
    "H3K9ac": 2, "H3K14ac": 2, "H3K36me3": 2, "H3K79me3": 2,
    "H4": 2, "H4ac": 2,
    "promoter_all": 2, "promoter_no_tata": 2, "promoter_tata": 2,
    "splice_sites_acceptors": 2, "splice_sites_all": 3, "splice_sites_donors": 2,
}

# per-task metric, `configs/dataset/nucleotide_transformer.yaml` /
# `slurm_scripts/run_nucleotide_transformer.sh:33-60`
NT_TASK_METRICS = {
    "enhancers": "mcc", "enhancers_types": "mcc",
    "splice_sites_acceptors": "f1", "splice_sites_all": "accuracy",
    "splice_sites_donors": "f1",
    "promoter_all": "f1", "promoter_no_tata": "f1", "promoter_tata": "f1",
}  # histone tasks default to mcc


def load_tsv(path: str, regression: bool = False, multi_label: bool = False):
    """Load `sequence<TAB>label` records.

    Label field: an int class id; a float target when ``regression``; or a
    comma-separated list of active class indices (e.g. ``0,3``) when
    ``multi_label`` (returned as a list of index tuples — the datamodule
    multi-hots them with a split-consistent class count).
    """
    seqs, labels = [], []
    with open(path) as f:
        for rec in csv.reader(f, delimiter="\t"):
            if not rec or rec[0].startswith("#"):
                continue
            seqs.append(rec[0])
            if multi_label:
                labels.append(tuple(int(t) for t in rec[1].split(",") if t))
            elif regression:
                labels.append(float(rec[1]))
            else:
                labels.append(int(rec[1]))
    if multi_label:
        return seqs, labels
    return seqs, np.asarray(labels, np.float32 if regression else np.int32)


def multi_hot(index_tuples, num_classes: int) -> np.ndarray:
    out = np.zeros((len(index_tuples), num_classes), np.float32)
    for r, t in enumerate(index_tuples):
        out[r, list(t)] = 1.0
    return out


def train_val_split(n: int, val_frac: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded 90/10 split (reference `genomics.py:294-305`)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = int(round(n * val_frac))
    return perm[n_val:], perm[:n_val]


class SeqClassificationDataset:
    """Fixed-length tokenized classification items."""

    def __init__(
        self,
        sequences: Sequence[str],
        labels: np.ndarray,
        max_length: int,
        tokenizer: Optional[CharacterTokenizer] = None,
        add_eos: bool = False,
        rc_aug: bool = False,
        conjoin_train: bool = False,
        conjoin_test: bool = False,
        split: str = "train",
        seed: int = 0,
    ):
        self.sequences = list(sequences)
        # dtype preserved: float regression targets / multi-hot vectors stay
        # float32; class ids stay int32
        labels = np.asarray(labels)
        self.labels = (labels.astype(np.float32)
                       if np.issubdtype(labels.dtype, np.floating)
                       else labels.astype(np.int32))
        assert len(self.sequences) == len(self.labels)
        self.max_length = max_length
        self.tokenizer = tokenizer or CharacterTokenizer(model_max_length=max_length)
        self.add_eos = add_eos
        self.rc_aug = rc_aug
        self.split = split
        self.seed = seed
        # conjoin semantics from `genomic_bench_dataset.py:87,104-118`:
        # train split conjoins when conjoin_train; eval conjoins when either
        # flag is set (post-hoc conjoining at test time). conjoin_test alone
        # makes the TRAIN split behave like rc_aug (`:87`).
        self.conjoin = conjoin_train if split == "train" else (conjoin_train or conjoin_test)
        self.rc_flip = (rc_aug or (conjoin_test and split == "train")) and not self.conjoin

    def __len__(self) -> int:
        return len(self.sequences)

    def seq_length(self, idx: int) -> int:
        """Valid (unpadded) token count after truncation."""
        return min(len(self.sequences[idx]) + int(self.add_eos), self.max_length)

    def get(self, idx: int, epoch: int = 0) -> Tuple[np.ndarray, np.int32]:
        # RC operates on the RAW sequence before tokenize/pad/truncate
        # (`genomic_bench_dataset.py:86-118`): both conjoined channels are
        # padded on the same side, and an rc-flipped item keeps its padding
        # side (reversing the padded array would move pads to the other side
        # and silently break length-masked pooling).
        seq = self.sequences[idx]
        if self.conjoin:
            ids = self.tokenizer.encode_padded(seq, self.max_length,
                                               add_sep=self.add_eos)
            rc = self.tokenizer.encode_padded(
                string_reverse_complement(seq), self.max_length,
                add_sep=self.add_eos,
            )
            x = np.stack([ids, rc], axis=-1)  # (L, 2)
        else:
            if self.rc_flip:
                rng = np.random.default_rng((self.seed, epoch, idx))
                if rng.random() < 0.5:
                    seq = string_reverse_complement(seq)
            x = self.tokenizer.encode_padded(seq, self.max_length,
                                             add_sep=self.add_eos)
        return x.astype(np.int32), self.labels[idx]

    def __getitem__(self, idx: int):
        return self.get(idx)


class ClassificationDataModule:
    """Train/val(/test) datamodule over local task files.

    Expects `<data_dir>/<task>/{train,test}.tsv`; the val split is carved
    from train with `train_val_split_seed` (90/10, reference semantics).
    """

    def __init__(
        self,
        data_dir: str,
        task: str,
        max_length: int,
        batch_size: int,
        add_eos: bool = False,
        rc_aug: bool = False,
        conjoin_train: bool = False,
        conjoin_test: bool = False,
        val_frac: float = 0.1,
        train_val_split_seed: int = 0,
        seed: int = 0,
        regression: bool = False,
        multi_label: bool = False,
    ):
        assert not (regression and multi_label)
        self.batch_size = batch_size
        self.regression = regression
        train_path = os.path.join(data_dir, task, "train.tsv")
        test_path = os.path.join(data_dir, task, "test.tsv")
        seqs, labels = load_tsv(train_path, regression=regression,
                                multi_label=multi_label)
        if os.path.exists(test_path):
            tseqs, tlabels = load_tsv(test_path, regression=regression,
                                      multi_label=multi_label)
        else:
            tseqs, tlabels = None, None
        if multi_label:
            # class count consistent across splits (multi-hot width)
            all_t = list(labels) + (list(tlabels) if tlabels else [])
            C = max((max(t) for t in all_t if t), default=0) + 1
            labels = multi_hot(labels, C)
            if tlabels is not None:
                tlabels = multi_hot(tlabels, C)
        tr_idx, va_idx = train_val_split(len(seqs), val_frac, train_val_split_seed)
        common = dict(
            max_length=max_length,
            add_eos=add_eos,
            rc_aug=rc_aug,
            conjoin_train=conjoin_train,
            conjoin_test=conjoin_test,
            seed=seed,
        )
        self.train_ds = SeqClassificationDataset(
            [seqs[i] for i in tr_idx], labels[tr_idx], split="train", **common
        )
        self.val_ds = SeqClassificationDataset(
            [seqs[i] for i in va_idx], labels[va_idx], split="val", **common
        )
        if tseqs is not None:
            self.test_ds = SeqClassificationDataset(
                tseqs, tlabels, split="test", **common
            )
        else:
            self.test_ds = self.val_ds
        self.tokenizer = self.train_ds.tokenizer
        # regression heads emit one scalar (reference
        # `configs/task/regression.yaml`: d_output 1)
        if regression:
            self.num_classes = 1
        elif multi_label:
            self.num_classes = labels.shape[1]
        else:
            self.num_classes = int(labels.max()) + 1

    def batches(self, split: str = "train", epoch: int = 0, shuffle: Optional[bool] = None,
                seed: int = 0, drop_last: Optional[bool] = None) -> Iterator[Dict[str, np.ndarray]]:
        ds = {"train": self.train_ds, "val": self.val_ds, "test": self.test_ds}[split]
        shuffle = (split == "train") if shuffle is None else shuffle
        drop_last = (split == "train") if drop_last is None else drop_last
        idx = np.arange(len(ds))
        if shuffle:
            np.random.default_rng((seed, epoch)).shuffle(idx)
        for s in range(0, len(idx) - (self.batch_size - 1 if drop_last else 0), self.batch_size):
            chunk = idx[s : s + self.batch_size]
            xs, ys = zip(*(ds.get(int(i), epoch) for i in chunk))
            yield {
                "input_ids": np.stack(xs),
                # float for regression targets / multi-hot label vectors,
                # int class ids otherwise (ds.labels dtype is authoritative)
                "labels": np.asarray(
                    ys,
                    np.float32
                    if np.issubdtype(ds.labels.dtype, np.floating)
                    else np.int32),
                "lengths": np.asarray(
                    [ds.seq_length(int(i)) for i in chunk], np.int32
                ),
            }


def make_synthetic_classification_task(
    out_dir: str, task: str = "dummy_task", n_train: int = 256, n_test: int = 64,
    seq_len: int = 128, num_classes: int = 2, seed: int = 0,
) -> str:
    """Write a synthetic task (motif-planted) for tests; returns data_dir.

    Class c sequences contain a class-distinct motif at a random position —
    learnable but not trivial. Motifs are mutually non-overlapping strings
    (a shared prefix would make classes nested and the task near-margin).
    """
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, task), exist_ok=True)
    alphabet = np.array(list("ACGT"))
    motifs = ["ACGTACGTAC", "TTGGCCTTGG", "GAGAGATCTC", "CCATTACGGT"]
    assert num_classes <= len(motifs)

    def gen(n):
        rows = []
        for _ in range(n):
            c = int(rng.integers(num_classes))
            seq = alphabet[rng.integers(0, 4, seq_len)]
            motif = list(motifs[c])
            p = int(rng.integers(0, seq_len - len(motif)))
            seq[p : p + len(motif)] = motif
            rows.append(("".join(seq), c))
        return rows

    for split, n in (("train", n_train), ("test", n_test)):
        with open(os.path.join(out_dir, task, f"{split}.tsv"), "w") as f:
            for seq, c in gen(n):
                f.write(f"{seq}\t{c}\n")
    return out_dir
