"""Memory-mapped FASTA access without pyfaidx.

An owned copy of `caduceus_tpu/data/fasta.py`: the same index, the same
window extraction and the same sidecar index, ``<fasta>.ctpu_idx.npz``
(name / length / offset / line geometry per contig), so an index written by
either package is read by the other. Windows come back directly as token
ids through a 256-entry byte table, with no per-base Python loop.
"""

from __future__ import annotations

import mmap
import os
from typing import Dict, Tuple

import numpy as np

_NEWLINES = (10, 13)  # \n, \r


class FastaFile:
    """Indexed read-only FASTA with O(span) window extraction."""

    def __init__(self, path: str):
        self.path = str(path)
        if not os.path.exists(self.path):
            raise FileNotFoundError(f"FASTA not found: {path}")
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        idx = self._load_or_build_index()
        self.names = list(idx["names"])
        self._meta: Dict[str, Tuple[int, int, int, int]] = {
            n: (
                int(idx["lengths"][i]),
                int(idx["offsets"][i]),
                int(idx["line_bases"][i]),
                int(idx["line_bytes"][i]),
            )
            for i, n in enumerate(self.names)
        }

    # -- index -------------------------------------------------------------
    def _index_path(self) -> str:
        return self.path + ".ctpu_idx.npz"

    def _load_or_build_index(self):
        ipath = self._index_path()
        if os.path.exists(ipath) and os.path.getmtime(ipath) >= os.path.getmtime(self.path):
            with np.load(ipath, allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
        names, lengths, offsets, line_bases, line_bytes = [], [], [], [], []
        mm = self._mm
        pos = 0
        n = len(mm)
        while pos < n:
            if mm[pos] != ord(">"):
                raise ValueError(f"malformed FASTA at byte {pos}")
            eol = mm.find(b"\n", pos)
            header = mm[pos + 1 : eol].split()[0].decode()
            seq_start = eol + 1
            # line geometry from the first sequence line
            next_eol = mm.find(b"\n", seq_start)
            if next_eol == -1:
                next_eol = n
            lb = next_eol - seq_start
            lw = next_eol - seq_start + 1
            if lb > 0 and mm[next_eol - 1] == 13:  # CRLF
                lb -= 1
            # scan to the end of this record
            p = seq_start
            total = 0
            while p < n and mm[p] != ord(">"):
                e = mm.find(b"\n", p)
                if e == -1:
                    e = n
                bases = e - p
                if bases > 0 and mm[e - 1 : e] == b"\r":
                    bases -= 1
                total += bases
                p = e + 1
            names.append(header)
            lengths.append(total)
            offsets.append(seq_start)
            line_bases.append(max(lb, 1))
            line_bytes.append(lw)
            pos = p
        arrs = dict(
            names=np.array(names),
            lengths=np.array(lengths, np.int64),
            offsets=np.array(offsets, np.int64),
            line_bases=np.array(line_bases, np.int64),
            line_bytes=np.array(line_bytes, np.int64),
        )
        try:
            np.savez(ipath, **arrs)
        except OSError:
            pass  # read-only location; the index stays in memory
        return arrs

    # -- access ------------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._meta

    def length(self, name: str) -> int:
        return self._meta[name][0]

    @property
    def chr_lens(self) -> Dict[str, int]:
        return {n: self._meta[n][0] for n in self.names}

    def fetch_bytes(self, name: str, start: int, end: int) -> np.ndarray:
        """Raw sequence bytes (uint8, newline-free) for [start, end)."""
        length, offset, lb, lw = self._meta[name]
        start = max(0, start)
        end = min(length, end)
        if end <= start:
            return np.zeros(0, np.uint8)
        b0 = offset + (start // lb) * lw + (start % lb)
        b1 = offset + ((end - 1) // lb) * lw + ((end - 1) % lb) + 1
        raw = np.frombuffer(self._mm, dtype=np.uint8, count=b1 - b0, offset=b0)
        if lw > lb:  # strip newlines
            keep = (raw != _NEWLINES[0]) & (raw != _NEWLINES[1])
            raw = raw[keep]
        if raw.shape[0] != end - start:
            raise ValueError(f"{self.path}: {name}[{start}:{end}] has "
                             f"{raw.shape[0]} bases; the index is stale")
        return raw

    def fetch_ids(
        self, name: str, start: int, end: int, byte_table: np.ndarray
    ) -> np.ndarray:
        """Window as int32 token ids via a 256-entry byte lookup table."""
        return byte_table[self.fetch_bytes(name, start, end)].astype(np.int32)

    def fetch(self, name: str, start: int, end: int) -> str:
        return self.fetch_bytes(name, start, end).tobytes().decode("ascii")

    def close(self):
        self._mm.close()
        self._f.close()


def write_fasta(path: str, contigs: Dict[str, str], line_width: int = 60) -> None:
    """Write a FASTA file (used by tests and the synthetic-data generator)."""
    with open(path, "w") as f:
        for name, seq in contigs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                f.write(seq[i : i + line_width] + "\n")
