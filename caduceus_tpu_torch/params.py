"""Bridge from the JAX package's flax parameters to the port's state_dict.

A flax parameter tree (the ``params`` collection of `CaduceusForMaskedLM`
or `Caduceus`) is flattened to ``{"backbone/layers_0/mixer/in_proj/kernel":
array, ...}`` — paths joined with ``/``, an optional leading ``params/``
is dropped — and saved as ``params.npz`` with
``np.savez(path, **flax.traverse_util.flatten_dict(params["params"],
sep="/"))``. The port's modules carry the flax names, so the mapping is:

- ``layers_<i>`` → ``layers.<i>``, ``/`` → ``.``;
- a Dense ``kernel`` (in, out) → ``weight`` (out, in): TRANSPOSED, the
  `nn.Linear` layout `models/mamba.py FrameDense` uses;
- everything else (embedding, lm_head, norm weights, conv_w (K, Wc),
  conv_b, dt_bias, A_log, D) keeps its name and layout.

`from_jax_params` consumes every key exactly once and raises on missing
keys, leftover keys and shape mismatches; `to_jax_params` goes the other
way (`flax_path` inverts `torch_key`).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Tuple

import numpy as np
import torch

from caduceus_tpu_torch.config import CaduceusConfig


def torch_key(flax_path: str) -> str:
    """The port's state_dict key for a flax parameter path."""
    out = []
    for part in flax_path.split("/"):
        m = re.fullmatch(r"layers_(\d+)", part)
        if m:
            out += ["layers", m.group(1)]
        else:
            out.append("weight" if part == "kernel" else part)
    return ".".join(out)


def flax_path(key: str) -> str:
    """The flax parameter path for a state_dict key (inverse of
    `torch_key`)."""
    parts = key.split(".")
    out = []
    i = 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"layers_{parts[i + 1]}")
            i += 2
        else:
            out.append("kernel" if parts[i] == "weight" else parts[i])
            i += 1
    return "/".join(out)


def to_jax_params(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of `from_jax_params`: a state_dict (or any {key:
    tensor} over its keys, e.g. gradients) as flat flax params, fp32 numpy,
    Dense weights transposed back to (in, out) kernels."""
    out = {}
    for key, t in tensors.items():
        path = flax_path(key)
        a = t.detach().float().cpu().numpy()
        out[path] = np.ascontiguousarray(a.T if path.endswith("/kernel")
                                         else a)
    return out


def _expected_state_dict(cfg: CaduceusConfig, backbone_only: bool = False,
                         tie_word_embeddings: bool = True):
    """Key -> (shape, dtype) of the port model's parameters for ``cfg``."""
    from caduceus_tpu_torch.models.caduceus import (
        Caduceus, CaduceusForMaskedLM)

    with torch.device("meta"):
        if backbone_only:
            model = Caduceus(cfg, device="meta")
        else:
            model = CaduceusForMaskedLM(
                cfg, device="meta", tie_word_embeddings=tie_word_embeddings)
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}


def from_jax_params(flat: Dict[str, np.ndarray], cfg: CaduceusConfig,
                    backbone_only: bool = False,
                    tie_word_embeddings: bool = True) -> Dict[str, torch.Tensor]:
    """Map flat flax params to a state_dict for `CaduceusForMaskedLM`
    (or `Caduceus` when ``backbone_only``) built from ``cfg``."""
    pending = {}
    for path, arr in flat.items():
        path = path[len("params/"):] if path.startswith("params/") else path
        key = torch_key(path)
        if key in pending:
            raise KeyError(f"two flax paths map to {key!r}")
        pending[key] = (path, arr)
    want = _expected_state_dict(cfg, backbone_only, tie_word_embeddings)
    missing = [k for k in want if k not in pending]
    if missing:
        raise KeyError(f"flax params lack {len(missing)} keys: {missing[:8]}")
    out = {}
    for key, (shape, dtype) in want.items():
        path, arr = pending.pop(key)
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if path.endswith("/kernel"):
            t = t.t()
        if tuple(t.shape) != shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)} maps to {key} "
                             f"of shape {shape}")
        out[key] = t.contiguous().to(dtype)
    if pending:
        left = [p for p, _ in pending.values()]
        raise KeyError(f"{len(left)} flax params left unused: {left[:8]}")
    return out


def load_npz_params(path: str) -> Dict[str, np.ndarray]:
    """Read a flat ``params.npz`` (see the module docstring)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_run_dir(run_dir: str, prefer_ema: bool = True
                 ) -> Tuple[CaduceusConfig, Dict[str, torch.Tensor]]:
    """(config, state_dict) of a run dir holding ``model_config.json`` and
    parameters, read from the first of:

    1. a ``params.npz`` export (flat flax paths, this module's contract);
    2. the port's latest checkpoint, ``checkpoints/<step>/`` written by
       `train/trainer.py Trainer` (its EMA weights when kept and
       ``prefer_ema``);
    3. the latest Orbax checkpoint a JAX run wrote (`caduceus_tpu.cli
       pretrain`), read with `tensorstore` (`train/checkpoint.py
       load_run_params`; EMA preferred the same way).

    Raises if none is there; never returns fresh weights. The LM head is
    untied when the parameters hold ``lm_head`` (pass
    ``tie_word_embeddings="lm_head" not in state_dict`` to the model)."""
    from caduceus_tpu_torch.train import checkpoint

    cfg = CaduceusConfig.load(os.path.join(run_dir, "model_config.json"))
    npz = os.path.join(run_dir, "params.npz")
    ckpts = os.path.join(run_dir, "checkpoints")
    if os.path.exists(npz):
        flat = load_npz_params(npz)
    elif checkpoint.latest_step(ckpts) is not None:
        flat, _ = checkpoint.read_latest_params(run_dir, prefer_ema)
    elif checkpoint.jax_latest_step(ckpts) is not None:
        flat, _ = checkpoint.load_run_params(run_dir, prefer_ema)
    else:
        raise FileNotFoundError(
            f"{run_dir} holds no parameters: expected a params.npz export, "
            "the port's checkpoints/<step>/ (meta.json) or a JAX run's "
            "Orbax checkpoints/<step>/ (_CHECKPOINT_METADATA)")
    untied = "lm_head" in flat or "params/lm_head" in flat
    return cfg, from_jax_params(flat, cfg, tie_word_embeddings=not untied)
