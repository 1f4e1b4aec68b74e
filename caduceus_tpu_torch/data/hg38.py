"""HG38 (human genome) MLM / NTP pretraining dataset and datamodule.

An owned copy of `caduceus_tpu/data/hg38.py`, batch for batch the same
(parity with `src/dataloaders/datasets/hg38_dataset.py` and the `HG38`
datamodule, `src/dataloaders/genomics.py:29-205`):

- every BED interval is normalized to ``MAX_ALLOWED_LENGTH = 2**20`` bases
  and subdivided into ``2**20 / max_length`` shifted windows;
- a window past a chromosome's end is shifted back inside it;
- N bases become PAD, so the loss ignores them;
- targets: MLM (80/10/10) or next-token prediction, with optional EOS;
- an optional reverse-complement coin flip (rc-aug).

Every random decision derives from ``(seed, epoch, index)`` through the
counter-based splitmix stream (`data/mlm.py`), so a batch is a function of
the sampler state alone and the Python and native loaders give the same
bits.
"""

from __future__ import annotations

import csv
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from caduceus_tpu_torch.data.fasta import FastaFile
from caduceus_tpu_torch.data.mlm import (
    mlm_mask_splitmix,
    splitmix_base,
    splitmix_draws,
    splitmix_u01,
)
from caduceus_tpu_torch.data.sampler import ShardedShuffleSampler
from caduceus_tpu_torch.tokenization import PAD_ID, SEP_ID, CaduceusTokenizer

MAX_ALLOWED_LENGTH = 2**20  # `hg38_dataset.py:15`


def read_bed(bed_file: str, split: str):
    """BED rows (chr, start, end) of one split; ends normalized to
    start + 2^20 (`hg38_dataset.py:140-144`)."""
    rows = []
    with open(bed_file) as f:
        for rec in csv.reader(f, delimiter="\t"):
            if not rec or rec[0].startswith("#"):
                continue
            chr_name, start = rec[0], int(rec[1])
            row_split = rec[3] if len(rec) > 3 else "train"
            if row_split == split:
                rows.append((chr_name, start, start + MAX_ALLOWED_LENGTH))
    return rows


class HG38Dataset:
    """Map-style dataset of (data, target) windows over a genome."""

    def __init__(
        self,
        split: str,
        bed_file: str,
        fasta_file: str,
        max_length: int,
        tokenizer: Optional[CaduceusTokenizer] = None,
        mlm: bool = True,
        mlm_probability: float = 0.15,
        add_eos: bool = False,
        rc_aug: bool = False,
        seed: int = 0,
        max_allowed_length: int = MAX_ALLOWED_LENGTH,
    ):
        if mlm and mlm_probability <= 0.0:
            raise ValueError("mlm_probability must be > 0 when mlm=True")
        if max_length > max_allowed_length or max_allowed_length % max_length:
            raise ValueError(f"max_length {max_length} must divide the "
                             f"window of {max_allowed_length}")
        self.split = split
        self.max_length = max_length
        self.mlm = mlm
        self.mlm_probability = mlm_probability
        self.add_eos = add_eos
        self.rc_aug = rc_aug
        self.seed = seed
        self.tokenizer = tokenizer or CaduceusTokenizer(model_max_length=max_length)
        self.max_allowed_length = max_allowed_length
        self.shifts = max_allowed_length // max_length

        self.rows = read_bed(bed_file, split)
        self.fasta = FastaFile(fasta_file)
        self._byte_table = self.tokenizer._byte_table
        self._complement = self.tokenizer.complement_array()
        self._n_id = self.tokenizer.get_vocab()["N"]

    def __len__(self) -> int:
        return len(self.rows) * self.shifts

    # -- window geometry (FastaInterval, `hg38_dataset.py:40-81`) -----------
    def _window(self, row_idx: int, shift_idx: int) -> Tuple[str, int, int]:
        chr_name, start, end = self.rows[row_idx]
        L = self.max_length
        if L < self.max_allowed_length:
            start, end = start + shift_idx * L, start + (shift_idx + 1) * L
        chrom_len = self.fasta.length(chr_name)
        if end > chrom_len:
            start, end = start - (end - chrom_len), chrom_len
        if start < 0:
            start, end = 0, end - start
        if end > chrom_len:
            start, end = chrom_len - L, chrom_len
        return chr_name, start, end

    def get(self, idx: int, epoch: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        row_idx, shift_idx = idx // self.shifts, idx % self.shifts
        chr_name, start, end = self._window(row_idx, shift_idx)
        ids = self.fasta.fetch_ids(chr_name, start, end, self._byte_table)

        base = splitmix_base(self.seed, epoch, idx)
        if self.rc_aug and splitmix_u01(splitmix_draws(base, 0, 1))[0] < 0.5:
            ids = self._complement[ids[::-1]]

        ids = np.where(ids == self._n_id, PAD_ID, ids)

        if self.add_eos:
            ids = np.concatenate([ids, np.array([SEP_ID], np.int32)])

        if self.mlm:
            core = ids[:-1] if self.add_eos else ids
            return mlm_mask_splitmix(
                core,
                base,
                mlm_probability=self.mlm_probability,
                vocab_size=self.tokenizer.vocab_size,
            )
        data = ids[:-1].astype(np.int32)
        target = ids[1:].astype(np.int32)
        return data, target

    def __getitem__(self, idx: int):
        return self.get(idx, epoch=0)


class DataLoaderIterator:
    """Batched, resumable iterator over a dataset and a sampler.

    Its state is the sampler's; batches are host-local (the global batch is
    ``batch_size * world_size``). ``use_native=True`` runs the per-item
    work in the C++ worker pool (`data/native.py`), built from the repo's
    source at first use; a failed build raises. Both loaders draw from the
    same splitmix stream, so their batches are bit-identical and a resumed
    run may switch loaders."""

    def __init__(self, dataset: HG38Dataset, sampler: ShardedShuffleSampler,
                 batch_size: int, drop_last: bool = True,
                 use_native: bool = False, n_threads: int = 8):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._native = None
        if use_native:
            from caduceus_tpu_torch.data import native

            if dataset.mlm and dataset.add_eos:
                raise ValueError("the native loader does not build MLM "
                                 "with add_eos; use the Python loader")
            nf = native.NativeFasta(dataset.fasta.path)
            geo = [dataset._window(i // dataset.shifts, i % dataset.shifts)
                   for i in range(len(dataset))]
            contigs = np.array([nf.index[c] for c, _, _ in geo], np.int32)
            starts = np.array([s for _, s, _ in geo], np.int64)
            ends = np.array([e for _, _, e in geo], np.int64)
            self._native = native.NativeHG38Loader(
                nf, contigs, starts, ends, seq_len=dataset.max_length,
                batch_size=batch_size, mlm=dataset.mlm,
                mlm_probability=dataset.mlm_probability,
                add_eos=dataset.add_eos,
                rc_aug=dataset.rc_aug, seed=dataset.seed,
                vocab_size=dataset.tokenizer.vocab_size, n_threads=n_threads,
            )

    def state_dict(self) -> Dict:
        return {"sampler": self.sampler.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.sampler.load_state_dict(state["sampler"])

    def close(self) -> None:
        """Stop the native loader's worker threads."""
        if self._native is not None:
            self._native.close()
            self._native.fasta.close()

    def _python_batch(self, indices, epoch) -> Dict[str, np.ndarray]:
        xs, ys = zip(*(self.dataset.get(int(i), epoch) for i in indices))
        return {"input_ids": np.stack(xs), "targets": np.stack(ys)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = self.sampler.epoch
        batch_idx = []
        for idx in self.sampler:
            batch_idx.append(idx)
            if len(batch_idx) == self.batch_size:
                if self._native is not None:
                    yield self._native.fill(np.asarray(batch_idx, np.int64),
                                            epoch)
                else:
                    yield self._python_batch(batch_idx, epoch)
                batch_idx = []
        if batch_idx and not self.drop_last:
            # the tail batch through the Python path (the same stream)
            yield self._python_batch(batch_idx, epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)


class HG38DataModule:
    """Three-split datamodule (`src/dataloaders/genomics.py:29-205`)."""

    def __init__(
        self,
        bed_file: str,
        fasta_file: str,
        max_length: int,
        batch_size: int,
        max_length_val: Optional[int] = None,
        max_length_test: Optional[int] = None,
        mlm: bool = True,
        mlm_probability: float = 0.15,
        add_eos: bool = False,
        rc_aug: bool = False,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        use_native: bool = False,
    ):
        self.batch_size = batch_size
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.use_native = use_native
        common = dict(
            bed_file=bed_file,
            fasta_file=fasta_file,
            mlm=mlm,
            mlm_probability=mlm_probability,
            add_eos=add_eos,
            seed=seed,
        )
        self.train_ds = HG38Dataset(
            "train", max_length=max_length, rc_aug=rc_aug, **common
        )
        self.val_ds = HG38Dataset(
            "valid", max_length=max_length_val or max_length, **common
        )
        self.test_ds = HG38Dataset(
            "test", max_length=max_length_test or max_length, **common
        )
        self.tokenizer = self.train_ds.tokenizer
        self.train_sampler = ShardedShuffleSampler(
            len(self.train_ds), seed=seed, shuffle=True, rank=rank,
            world_size=world_size, drop_last=True,
        )

    def train_loader(self) -> DataLoaderIterator:
        return DataLoaderIterator(self.train_ds, self.train_sampler,
                                  self.batch_size, use_native=self.use_native)

    def eval_loader(self, split: str = "valid") -> DataLoaderIterator:
        ds = self.val_ds if split == "valid" else self.test_ds
        sampler = ShardedShuffleSampler(
            len(ds), seed=self.seed, shuffle=False, rank=self.rank,
            world_size=self.world_size,
        )
        return DataLoaderIterator(ds, sampler, self.batch_size, drop_last=False)
