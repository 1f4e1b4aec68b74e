"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
`build/kernels/` at the root of the checkout (listed in `.gitignore`),
under a file name keyed by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The
`-Xptxas -v` report (registers, shared memory, spills) is kept beside the
library as `<name>-<hash>.log`. ``defines`` (``NAME=value`` strings, passed
as ``-D`` flags) build a variant library of the same source beside it: the
checks build their planted faults so (`csrc/scan_common.cuh` SCAN_DROP).

Nothing here runs at import time: the CPU tests import every module of the
port, and this machine may have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines=()) -> str:
    """Path of the built library for `csrc/<name>.cu` (hash-keyed by the
    source, the shared headers `csrc/*.cuh` and the flags)."""
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(SRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    key = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{key}.so")


def build(name: str, defines=()) -> tuple:
    """Compile `csrc/<name>.cu` (with ``-D`` ``defines``) unless its
    hash-keyed library exists. Returns (path, seconds spent compiling — 0.0
    if it was already built)."""
    out = library_path(name, defines)
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_flags(defines), "-o", tmp, os.path.join(SRC_DIR, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    with open(out[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out, seconds


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` (with ``defines``), built on
    first use."""
    key = (name, tuple(defines))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            path, _ = build(name, defines)
            lib = _loaded[key] = ctypes.CDLL(path)
        return lib
