"""Checkpoints of the port's `Trainer`, and reading the JAX package's.

The port's format, one directory per step under ``<run_dir>/checkpoints``:

- ``<step>/params.npz``: the parameters as flat flax paths in fp32, the
  `params.py` contract, so `serve` / `generate` / `eval` read a step as
  they read a ``params.npz`` export;
- ``<step>/ema_params.npz`` when the run keeps an EMA of the weights;
- ``<step>/optimizer.pt``: `train/optim.py Optimizer.state_dict()` (the
  update count, i.e. the lr schedule's step, and AdamW's moments);
- ``<step>/meta.json``: the step and the format tag `FORMAT`;
- ``loader_state_<step>.json`` beside the step dirs, as
  `caduceus_tpu/train/checkpoint.py` writes it (`:47-49`).

A step is written into a temporary directory and moved into place with
one `os.replace`, after its loader state: a process killed mid-write
leaves no step directory that `latest_step` would pick. The newest
`MAX_TO_KEEP` steps are kept, as the JAX package's Orbax manager does
(`:24-27`).

`load_run_params` reads the parameters of a run dir that the JAX package
wrote (Orbax `StandardSave` of its `TrainState`: an OCDBT key-value store
of zarr arrays under ``<step>/state``) with `tensorstore` alone, which is
not JAX; it takes the latest complete step and prefers the EMA weights,
with no template (`caduceus_tpu/train/checkpoint.py:142`).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from caduceus_tpu_torch.params import (
    from_jax_params,
    load_npz_params,
    to_jax_params,
)

FORMAT = "caduceus_tpu_torch.checkpoint/1"
MAX_TO_KEEP = 2
_TMP = ".tmp-"


def _steps(path: str, marker: str) -> Dict[int, str]:
    """{step: dir} of the complete step dirs under ``path`` that hold
    ``marker``; temporary dirs (the port's ``.tmp-*``, Orbax's
    ``<step>.orbax-checkpoint-tmp-*``) are not digit-named and never
    count."""
    if not os.path.isdir(path):
        return {}
    out = {}
    for name in os.listdir(path):
        d = os.path.join(path, name)
        if name.isdigit() and os.path.exists(os.path.join(d, marker)):
            out[int(name)] = d
    return out


def latest_step(path: str) -> Optional[int]:
    """The newest complete port checkpoint under ``path``, or None."""
    steps = _steps(path, "meta.json")
    return max(steps) if steps else None


def _write_json(path: str, obj) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def save_checkpoint(path: str, state, loader_state: Optional[dict] = None
                    ) -> str:
    """Write ``state`` (a `train/trainer.py TrainState`) as step
    ``state.step`` under ``path``; returns the step's directory."""
    step = int(state.step)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, str(step))
    tmp = os.path.join(path, f"{_TMP}{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "params.npz"),
             **to_jax_params(state.model.state_dict()))
    if state.ema_params is not None:
        np.savez(os.path.join(tmp, "ema_params.npz"),
                 **to_jax_params(state.ema_params))
    torch.save(state.optimizer.state_dict(),
               os.path.join(tmp, "optimizer.pt"))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"format": FORMAT, "step": step,
                   "ema": state.ema_params is not None}, f)
    if loader_state is not None:
        _write_json(os.path.join(path, f"loader_state_{step}.json"),
                    loader_state)
    if os.path.exists(final):   # the same step saved again: replace it
        old = os.path.join(path, f"{_TMP}old-{step}-{os.getpid()}")
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old)
    else:
        os.replace(tmp, final)
    for s in sorted(_steps(path, "meta.json"))[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(path, str(s)))
        lpath = os.path.join(path, f"loader_state_{s}.json")
        if os.path.exists(lpath):
            os.remove(lpath)
    for name in os.listdir(path):   # what killed writers left behind
        if name.startswith(_TMP):
            shutil.rmtree(os.path.join(path, name), ignore_errors=True)
    return final


def _load_into(model, flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return from_jax_params(flat, model.cfg,
                           tie_word_embeddings=model.lm_head is None)


def restore_checkpoint(path: str, state) -> Optional[dict]:
    """Load the latest step under ``path`` into ``state`` in place: the
    model's parameters, the optimizer, the step and the EMA; returns the
    loader state saved with it (None if there is none).

    EMA follows the caller, as in the JAX package (`:110-140`): a state
    with EMA takes the checkpoint's, or starts it from the restored
    parameters when the run kept none; a state without EMA drops the
    checkpoint's."""
    step = latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, str(step))
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{d}: format {meta.get('format')!r}, "
                         f"expected {FORMAT!r}")
    model = state.model
    model.load_state_dict(
        _load_into(model, load_npz_params(os.path.join(d, "params.npz"))))
    state.optimizer.load_state_dict(torch.load(
        os.path.join(d, "optimizer.pt"), map_location="cpu",
        weights_only=True))
    state.step = int(meta["step"])
    if state.ema_params is not None:
        ema_path = os.path.join(d, "ema_params.npz")
        src = (_load_into(model, load_npz_params(ema_path))
               if os.path.exists(ema_path) else model.state_dict())
        with torch.no_grad():
            for n, e in state.ema_params.items():
                e.copy_(src[n])
    lpath = os.path.join(path, f"loader_state_{step}.json")
    if os.path.exists(lpath):
        with open(lpath) as f:
            return json.load(f)
    return None


def read_latest_params(run_dir: str, prefer_ema: bool = True
                       ) -> Tuple[Dict[str, np.ndarray], int]:
    """(flat params, step) of the port's latest checkpoint in ``run_dir``,
    the EMA weights when kept and ``prefer_ema``."""
    path = os.path.join(run_dir, "checkpoints")
    step = latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, str(step))
    ema = os.path.join(d, "ema_params.npz")
    if prefer_ema and os.path.exists(ema):
        return load_npz_params(ema), step
    return load_npz_params(os.path.join(d, "params.npz")), step


def jax_latest_step(path: str) -> Optional[int]:
    """The newest complete Orbax step under ``path`` (it holds
    ``_CHECKPOINT_METADATA``), or None."""
    steps = _steps(path, "_CHECKPOINT_METADATA")
    return max(steps) if steps else None


def load_run_params(run_dir: str, prefer_ema: bool = True
                    ) -> Tuple[Dict[str, np.ndarray], int]:
    """(flat params, step) of the latest Orbax checkpoint a JAX run wrote
    into ``run_dir``: ``ema_params`` when the run kept them and
    ``prefer_ema``, else ``params``; flat flax paths under ``params/``, as
    `params.py from_jax_params` takes them."""
    path = os.path.join(run_dir, "checkpoints")
    step = jax_latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no Orbax checkpoint under {path}")
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"reading the JAX run dir {run_dir} needs the tensorstore "
            "package; without it, export the parameters as params.npz "
            "(flat flax paths, caduceus_tpu_torch/params.py) into the run "
            "dir") from e
    state_dir = os.path.join(path, str(step), "state")
    with open(os.path.join(state_dir, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise NotImplementedError(
            f"{state_dir}: only OCDBT-backed zarr (v2) checkpoints are "
            f"read (use_ocdbt={meta.get('use_ocdbt')}, "
            f"use_zarr3={meta.get('use_zarr3')})")
    keys = [tuple(k["key"] for k in v["key_metadata"])
            for v in meta["tree_metadata"].values()]
    root = "params"
    if prefer_ema and any(k[0] == "ema_params" for k in keys):
        root = "ema_params"
    ctx = ts.Context()
    base = "file://" + os.path.abspath(state_dir)
    flat = {}
    for k in keys:
        if k[0] != root:
            continue
        spec = {"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": base, "path": ".".join(k) + "/"}}
        flat["/".join(k[1:])] = np.asarray(
            ts.open(spec, context=ctx).result().read().result())
    if not flat:
        raise ValueError(f"{state_dir}: no '{root}' arrays")
    return flat, step
