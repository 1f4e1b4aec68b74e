"""ctypes bindings for the native (C++) data loader.

The port's counterpart of `caduceus_tpu/data/native.py`, over the same C
interface (`native/dataloader.cc`): mmap'd FASTA indexing, tokenization,
deterministic MLM masking on the shared splitmix stream (`data/mlm.py`),
and a pthread worker pool that fills a batch with no Python per item.

The library is built from the checkout's `native/dataloader.cc` at first
use, ``g++ -O3 -std=c++17 -shared -fPIC -pthread``, into `build/native/`
at the root of the checkout (listed in `.gitignore`), under a file name
keyed by a hash of the source and the flags, as `_build.py` keys the CUDA
kernels. The prebuilt `native/libcaduceus_data.so` beside the source is
never loaded: what runs is built from the repo's source on the machine
that runs it. A failed build raises; nothing falls back to the Python
loader behind the caller's back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "dataloader.cc")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lock = threading.Lock()


def library_path() -> str:
    """Path of the built library (hash-keyed by the source and flags)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcaduceus_data-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile `native/dataloader.cc` unless its hash-keyed library exists;
    returns the library's path. Raises if the source or `g++` is missing
    or the compile fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native loader is built from "
                           "native/dataloader.cc (set CXX)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native loader failed:\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.fasta_open.restype = ctypes.c_void_p
        lib.fasta_open.argtypes = [ctypes.c_char_p]
        lib.fasta_num_contigs.restype = ctypes.c_int
        lib.fasta_num_contigs.argtypes = [ctypes.c_void_p]
        lib.fasta_contig_name.restype = ctypes.c_char_p
        lib.fasta_contig_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fasta_contig_length.restype = ctypes.c_int64
        lib.fasta_contig_length.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fasta_fetch_ids.restype = ctypes.c_int64
        lib.fasta_fetch_ids.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.fasta_close.restype = None
        lib.fasta_close.argtypes = [ctypes.c_void_p]
        lib.hg38_item.restype = ctypes.c_int64
        lib.hg38_item.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int32, ctypes.c_int,
        ]
        lib.loader_fill_batch.restype = None
        lib.loader_fill_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeFasta:
    """mmap'd FASTA via the native indexer."""

    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        self.path = path
        self._h = lib.fasta_open(path.encode())
        if not self._h:
            raise OSError(f"failed to open FASTA: {path}")
        n = lib.fasta_num_contigs(self._h)
        self.names = [lib.fasta_contig_name(self._h, i).decode() for i in range(n)]
        self.index = {name: i for i, name in enumerate(self.names)}
        self.chr_lens = {
            name: int(lib.fasta_contig_length(self._h, i))
            for i, name in enumerate(self.names)
        }

    def fetch_ids(self, name: str, start: int, end: int) -> np.ndarray:
        out = np.empty(max(0, end - start), np.int32)
        n = self._lib.fasta_fetch_ids(
            self._h, self.index[name], start, end, _i32p(out)
        )
        return out[: max(0, n)]

    def close(self):
        if getattr(self, "_h", None):
            self._lib.fasta_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        self.close()


class NativeHG38Loader:
    """Batched, multithreaded item producer over precomputed windows.

    Windows (contig_idx, start, end) are computed in Python (BED parsing
    and boundary clamping stay in `HG38Dataset`); the native side does
    extraction, tokenization, N → PAD, rc-aug and the MLM / NTP targets in
    a worker pool, straight into the output buffers."""

    def __init__(
        self,
        fasta: NativeFasta,
        contigs: np.ndarray,  # (n,) int32 contig indices
        starts: np.ndarray,   # (n,) int64
        ends: np.ndarray,     # (n,) int64
        seq_len: int,
        batch_size: int,
        mlm: bool = True,
        mlm_probability: float = 0.15,
        add_eos: bool = False,
        rc_aug: bool = False,
        seed: int = 0,
        vocab_size: int = 12,
        n_threads: int = 8,
    ):
        lib = _load()
        self._lib = lib
        self.fasta = fasta
        # output row length: NTP without eos yields seq_len - 1 items
        # (data = ids[:-1]); MLM and eos-NTP yield seq_len
        self.out_len = seq_len if (mlm or add_eos) else seq_len - 1
        self.seq_len = seq_len
        self.batch_size = batch_size
        contigs = np.ascontiguousarray(contigs, np.int32)
        starts = np.ascontiguousarray(starts, np.int64)
        ends = np.ascontiguousarray(ends, np.int64)
        if not (len(contigs) == len(starts) == len(ends)):
            raise ValueError("contigs, starts and ends differ in length")
        if ((ends - starts) != seq_len).any():
            raise ValueError(f"every window must span seq_len={seq_len}")
        if ((contigs < 0) | (contigs >= len(fasta.names))).any():
            raise ValueError("contig index outside the FASTA")
        self.n_windows = len(contigs)
        self._h = lib.loader_create(
            fasta._h, _i32p(contigs), _i64p(starts), _i64p(ends),
            len(contigs), self.out_len, batch_size, int(mlm), mlm_probability,
            int(add_eos), int(rc_aug), seed, vocab_size, n_threads,
        )
        self._x = np.empty((batch_size, self.out_len), np.int32)
        self._y = np.empty((batch_size, self.out_len), np.int32)

    def fill(self, indices: np.ndarray, epoch: int) -> Dict[str, np.ndarray]:
        indices = np.ascontiguousarray(indices, np.int64)
        if len(indices) != self.batch_size:
            raise ValueError(f"{len(indices)} indices for a batch of "
                             f"{self.batch_size}")
        if ((indices < 0) | (indices >= self.n_windows)).any():
            raise IndexError("window index outside the dataset")
        self._lib.loader_fill_batch(
            self._h, _i64p(indices), len(indices), epoch,
            _i32p(self._x), _i32p(self._y),
        )
        return {"input_ids": self._x.copy(), "targets": self._y.copy()}

    def close(self):
        if getattr(self, "_h", None):
            self._lib.loader_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        self.close()
