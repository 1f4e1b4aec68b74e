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

Under tensor parallelism (`parallel/sharding.py TPPlan`) a step keeps
the one-rank format: the model ranks gather their parts into the whole
tensors, rank 0 writes them (``whole=``), and a restore cuts each rank's
part again (``plan=``), so a run resumes on any model axis, one rank
included, and `eval`, `serve` and `finetune` read its run dir as a
one-rank run's.

`load_run_params` reads the parameters of a run dir that the JAX package
wrote (Orbax `StandardSave` of its `TrainState`: an OCDBT key-value store
of zarr arrays under ``<step>/state``) with `tensorstore` alone, which is
not JAX; it takes the latest complete step and prefers the EMA weights,
with no template (`caduceus_tpu/train/checkpoint.py:142`);
`read_orbax_arrays` is its reader, which also opens a JAX `finetune
--save-dir` export. `restore_jax_checkpoint` resumes such a run: the
weights, the step, the EMA, the loader state and the optimizer state, whose
optax chain (`caduceus_tpu/train/optim.py:322-337`) maps onto the port's
`Optimizer` (`jax_adamw_state`). `load_backbone` grafts pretrained
backbone weights into a fine-tuning model (`:179`).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

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


def save_checkpoint(path: str, state, loader_state: Optional[dict] = None,
                    whole: Optional[dict] = None) -> str:
    """Write ``state`` (a `train/trainer.py TrainState`) as step
    ``state.step`` under ``path``; returns the step's directory. ``whole``
    ({"params", "ema", "optimizer"}: the gathered state dicts of a
    tensor-parallel run) replaces what ``state`` holds."""
    if whole is None:
        whole = {"params": state.model.state_dict(),
                 "ema": state.ema_params,
                 "optimizer": state.optimizer.state_dict()}
    step = int(state.step)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, str(step))
    tmp = os.path.join(path, f"{_TMP}{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "params.npz"),
             **to_jax_params(whole["params"]))
    if whole["ema"] is not None:
        np.savez(os.path.join(tmp, "ema_params.npz"),
                 **to_jax_params(whole["ema"]))
    torch.save(whole["optimizer"], os.path.join(tmp, "optimizer.pt"))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"format": FORMAT, "step": step,
                   "ema": whole["ema"] is not None}, f)
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


def _load_into(model, flat: Dict[str, np.ndarray],
               plan=None) -> Dict[str, torch.Tensor]:
    """The state_dict of ``model`` from a whole flat tree: this rank's part
    of it under a tensor-parallel ``plan``."""
    if plan is not None:
        flat = plan.shard_flat(flat)
    return from_jax_params(flat, None, model=model)


def map_moments(sd: dict, optimizer, model, fn) -> dict:
    """A copy of an `Optimizer` state dict ``sd`` (of ``optimizer``'s
    parameter groups) with ``fn(parameter name, tensor)`` applied to its
    AdamW moments (the gather or the cut of a tensor-parallel run)."""
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in optimizer.opt.param_groups
             for p in g["params"]]
    out = dict(sd)
    adamw = dict(sd["adamw"])
    adamw["state"] = {
        i: {k: (fn(order[i], v) if k in ("exp_avg", "exp_avg_sq") else v)
            for k, v in st.items()}
        for i, st in sd["adamw"]["state"].items()}
    out["adamw"] = adamw
    return out


def _restore_ema(state, src: Optional[Dict[str, torch.Tensor]]) -> None:
    """EMA follows the caller, as in the JAX package (`:110-140`): a state
    with EMA takes ``src`` (the checkpoint's), or starts it from the
    restored parameters when the run kept none; a state without EMA drops
    the checkpoint's."""
    if state.ema_params is None:
        return
    src = src if src is not None else state.model.state_dict()
    with torch.no_grad():
        for n, e in state.ema_params.items():
            e.copy_(src[n])


def _loader_state(path: str, step: int) -> Optional[dict]:
    lpath = os.path.join(path, f"loader_state_{step}.json")
    if os.path.exists(lpath):
        with open(lpath) as f:
            return json.load(f)
    return None


def restore_checkpoint(path: str, state, plan=None) -> Optional[dict]:
    """Load the latest step under ``path`` into ``state`` in place: the
    model's parameters, the optimizer, the step and the EMA; returns the
    loader state saved with it (None if there is none). Under a
    tensor-parallel ``plan`` each takes this rank's part.

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
    model.load_state_dict(_load_into(
        model, load_npz_params(os.path.join(d, "params.npz")), plan))
    opt_sd = torch.load(os.path.join(d, "optimizer.pt"), map_location="cpu",
                        weights_only=True)
    if plan is not None:
        opt_sd = map_moments(opt_sd, state.optimizer, model, plan.part)
    state.optimizer.load_state_dict(opt_sd)
    state.step = int(meta["step"])
    ema_path = os.path.join(d, "ema_params.npz")
    _restore_ema(state, _load_into(model, load_npz_params(ema_path), plan)
                 if state.ema_params is not None and os.path.exists(ema_path)
                 else None)
    return _loader_state(path, step)


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


def orbax_tree_paths(state_dir: str) -> List[Tuple[str, ...]]:
    """The tree paths of the arrays in an Orbax `StandardSave` directory
    (from its ``_METADATA``)."""
    with open(os.path.join(state_dir, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise NotImplementedError(
            f"{state_dir}: only OCDBT-backed zarr (v2) checkpoints are "
            f"read (use_ocdbt={meta.get('use_ocdbt')}, "
            f"use_zarr3={meta.get('use_zarr3')})")
    # leaves that hold no array (optax's EmptyState, a None) are listed
    # with skip_deserialize
    return [tuple(k["key"] for k in v["key_metadata"])
            for v in meta["tree_metadata"].values()
            if not (v.get("value_metadata") or {}).get("skip_deserialize")]


def read_orbax_arrays(state_dir: str, root: str
                      ) -> Dict[str, np.ndarray]:
    """{flat path below ``root``: array} of the arrays under ``root`` in an
    Orbax `StandardSave` directory (an OCDBT key-value store of zarr
    arrays), read with `tensorstore` alone. Both a JAX run's checkpoint
    step (``<step>/state``, roots ``params`` / ``ema_params``) and a JAX
    `finetune --save-dir` export (``params/``, root ``params``) are such
    directories."""
    keys = [k for k in orbax_tree_paths(state_dir) if k[0] == root]
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"reading the JAX checkpoint {state_dir} needs the tensorstore "
            "package; without it, export the parameters as params.npz "
            "(flat flax paths, caduceus_tpu_torch/params.py) beside it"
            ) from e
    ctx = ts.Context()
    base = "file://" + os.path.abspath(state_dir)
    out = {}
    for k in keys:
        spec = {"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": base, "path": ".".join(k) + "/"}}
        out["/".join(k[1:])] = np.asarray(
            ts.open(spec, context=ctx).result().read().result())
    if not out:
        raise ValueError(f"{state_dir}: no '{root}' arrays")
    return out


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
    state_dir = os.path.join(path, str(step), "state")
    root = "params"
    if prefer_ema and any(k[0] == "ema_params"
                          for k in orbax_tree_paths(state_dir)):
        root = "ema_params"
    return read_orbax_arrays(state_dir, root), step


def jax_adamw_state(opt_state: Dict[str, np.ndarray]
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
                               int, int]:
    """(mu, nu, Adam's count, the schedule's count) of the flat
    ``opt_state`` arrays of a JAX run (`read_orbax_arrays` root
    ``opt_state``), mu / nu keyed by flat flax paths without the leading
    ``params/``.

    The chain of `caduceus_tpu/train/optim.py make_optimizer` is
    [`clip_by_global_norm` (empty state)], `adamw` = (`ScaleByAdamState
    (count, mu, nu)`, the masked decay's empty state,
    `ScaleByScheduleState(count)`) and [`scale_updates_by_tree` (empty
    state)]; the empty states hold no array, so the leaves are found by
    name: the one prefix over ``mu`` / ``nu`` is Adam's, the other
    ``count`` the schedule's (Adam's when there is none)."""
    heads = {k.split("/mu/", 1)[0] for k in opt_state if "/mu/" in k}
    if len(heads) != 1:
        raise ValueError(f"expected one ScaleByAdamState in the optimizer "
                         f"state, found {sorted(heads)}")
    (head,) = heads

    def tree(name):
        out = {}
        for k, v in opt_state.items():
            if k.startswith(f"{head}/{name}/"):
                path = k[len(head) + len(name) + 2:]
                out[path[len("params/"):] if path.startswith("params/")
                    else path] = v
        return out

    adam_count = int(opt_state[f"{head}/count"])
    counts = [int(v) for k, v in opt_state.items()
              if k.split("/")[-1] == "count" and k != f"{head}/count"]
    if len(set(counts)) > 1:
        raise ValueError(f"optimizer state with several counts: {counts}")
    return tree("mu"), tree("nu"), adam_count, (counts[0] if counts
                                                else adam_count)


def restore_jax_checkpoint(path: str, state, plan=None) -> Optional[dict]:
    """Load the latest Orbax step a JAX run wrote under ``path`` (its
    `TrainState`: params, opt_state, step, ema_params) into the port's
    ``state`` in place, read with `tensorstore` alone; returns the loader
    state saved with it (None if there is none).

    AdamW's moments and count go to each parameter's ``exp_avg`` /
    ``exp_avg_sq`` / ``step`` of `torch.optim.AdamW` (Dense kernels
    transposed as the weights are), the schedule's count to the
    `Optimizer`'s; the EMA follows the caller (`_restore_ema`). Under a
    tensor-parallel ``plan`` each takes this rank's part."""
    from caduceus_tpu_torch.params import flax_path

    step = jax_latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no Orbax checkpoint under {path}")
    state_dir = os.path.join(path, str(step), "state")
    roots = {k[0] for k in orbax_tree_paths(state_dir)}
    model = state.model
    model.load_state_dict(_load_into(
        model, read_orbax_arrays(state_dir, "params"), plan))
    mu, nu, adam_count, count = jax_adamw_state(
        read_orbax_arrays(state_dir, "opt_state"))
    if plan is not None:
        mu, nu = plan.shard_flat(mu), plan.shard_flat(nu)
    opt = state.optimizer.opt
    index = {}
    for group in opt.param_groups:
        for p in group["params"]:
            index[id(p)] = len(index)
    moments = {}
    for name, p in model.named_parameters():
        path_ = flax_path(name)
        m, v = (torch.from_numpy(np.array(t[path_], dtype=np.float32))
                for t in (mu, nu))
        if path_.endswith("/kernel") and m.dim() == 2:
            m, v = m.t(), v.t()
        if tuple(m.shape) != tuple(p.shape):
            raise ValueError(f"{path_}: moments of shape {tuple(m.shape)} "
                             f"for a parameter of shape {tuple(p.shape)}")
        moments[index[id(p)]] = {
            "step": torch.tensor(float(adam_count), dtype=torch.float32),
            "exp_avg": m.contiguous(), "exp_avg_sq": v.contiguous()}
    sd = opt.state_dict()
    sd["state"] = moments
    opt.load_state_dict(sd)
    state.optimizer.count = count
    state.step = int(read_orbax_arrays(state_dir, "step")[""])
    _restore_ema(state, _load_into(model, read_orbax_arrays(
        state_dir, "ema_params"), plan)
        if state.ema_params is not None and "ema_params" in roots else None)
    return _loader_state(path, step)


def load_backbone(pretrained: Dict[str, torch.Tensor],
                  scratch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Graft pretrained backbone weights into a downstream model's
    state_dict (`caduceus_tpu/train/checkpoint.py:179`): every key under
    ``backbone.`` that ``pretrained`` holds at the same shape takes the
    pretrained value (in the scratch tensor's dtype and device); the head,
    decoder, encoder and score keep their scratch init. Returns the merged
    state_dict."""
    out = {}
    for k, v in scratch.items():
        p = pretrained.get(k)
        if (k.startswith("backbone.") and p is not None
                and tuple(p.shape) == tuple(v.shape)):
            out[k] = p.detach().to(dtype=v.dtype, device=v.device)
        else:
            out[k] = v
    return out
