"""The training runtime: train step, eval step, prefetch and `Trainer`.

Port of `caduceus_tpu/train/trainer.py`: `TrainState` (`:41`),
`make_train_step` (`:56-147`), `make_eval_step` (`:150`),
`prefetch_to_device` (`:182`), `TrainerConfig` (`:240`) and `Trainer`
(`:266`). PyTorch keeps the parameters in the module and the optimizer
state in the optimizer, so `TrainState` holds those two, the step count
and the EMA tensors.

A batch is ``{"input_ids", "targets"[, "loss_weights"]}`` of shape
``(accum_steps * B, L)``, split into ``accum_steps`` consecutive
micro-batches of B rows, as the JAX step reshapes it. The step's gradient
is the mean of the micro-batches' gradients; its loss and accuracy are the
means of theirs, ``loss_sum`` and ``count`` their sums, and ``grad_norm``
the global norm of the mean gradient before clipping.

With a ``mesh`` (`parallel/mesh.py`) the step runs data parallelism, and
with ``context_parallel`` context parallelism, over `torch.distributed`
(the JAX Trainer's mesh, `caduceus_tpu/train/trainer.py:277-310`): every
rank builds the same global batch from the same seed and keeps its part
(`shard_batch`: its rows of each micro-batch, and under CP its sequence
columns), the loss and the metrics are global token means (sums and
counts all-reduced over every rank), and the gradients are all-reduced
over every rank before clipping, so every rank holds the same parameters,
optimizer state and EMA. GPN-weighted cross-entropy (``loss_weights``) is
normalized as JAX normalizes it, over each micro-batch of the global batch:
a rank backpropagates its weighted NLL sum over the all-reduced sum of the
weights. Under context parallelism the eval's ``last_k`` sums take each
rank's overlap with the last k columns, and its ``per_token`` vectors each
rank's columns in their place. Every rank initializes the same parameters
from the same seed; `Trainer.init_state` all-gathers a checksum of them
and raises if any rank differs. Rank 0 alone logs and writes checkpoints
(and the per-token curve).

Dropout (``TrainerConfig.dropout``, the Hyena family; JAX
`make_train_step(dropout=, dropout_seed=)`): the model is called with
``dropout_key=(seed, step, micro-batch, rank)``, from which each dropout
site seeds its own generator (`models/hyena.py dropout`), so a resumed run
draws the masks the killed one drew. ``Trainer(lr_overrides=)`` passes
per-parameter lr groups to the optimizer (`train/optim.py
hyena_lr_overrides`).

``Trainer(tensor_parallel=True)`` (the JAX Trainer's Megatron specs) cuts
the model's parameters over the mesh's model axis at init
(`parallel/sharding.py shard_module_`): every rank of a model group takes
the same rows of the batch, the loss, the metrics and the token counts are
summed over the data axis only (the model ranks hold the same logits), the
gradients are all-reduced over the data axis only, and the global-norm
clip sums the squares of each rank's own elements over the model axis and
counts every shared element once (`TPPlan.global_sq_norm`). AdamW and the
EMA run on each rank's part. At init the ranks compare checksums of their
parts over the data axis and of the shared parameters over the model
axis; at the first step, of the shared parameters' gradients over the
model axis (they must come out equal). A checkpoint is the one-rank format
(the parts gathered, rank 0 writes), and a restore cuts it again, so a
tensor-parallel run resumes on one rank and the other way round. Tensor
and context parallelism together are refused, as the JAX CLI refuses the
pair.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from caduceus_tpu_torch.parallel.comm import all_gather, all_reduce_
from caduceus_tpu_torch.parallel.mesh import shard_batch
from caduceus_tpu_torch.train.metrics import (
    NumTokens,
    Perplexity,
    accuracy,
    cross_entropy_loss,
    per_token_ppl,
)
from caduceus_tpu_torch.train.optim import (
    Optimizer,
    global_norm,
    make_optimizer,
)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    # EMA of the parameters, {state_dict key: tensor}, when ema_decay > 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def init_ema(model: nn.Module) -> Dict[str, torch.Tensor]:
    """EMA tensors starting at the current parameters."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _correct(logits, tgt, ignore_index):
    """The count of positions whose argmax is the target (ignored ones
    left out)."""
    pred = logits.argmax(dim=-1)
    return ((pred == tgt) & (tgt != ignore_index)).sum()


def _local_sums(logits, tgt, ignore_index, lw=None):
    """This rank's part of a global loss: (the numerator it backpropagates,
    the values to all-reduce: [numerator, count, correct] and with
    ``lw`` the sum of the weights). Unweighted, the numerator is the NLL
    sum; with loss weights the weighted NLL sum, whose denominator is the
    global sum of the weights (`caduceus_tpu/train/metrics.py:44-48`
    normalizes them over the micro-batch)."""
    correct = _correct(logits.detach(), tgt, ignore_index).float()
    if lw is None:
        _, aux = cross_entropy_loss(logits, tgt, ignore_index=ignore_index)
        num = aux["loss_sum"]
        return num, [num.detach().float(), aux["count"].float(), correct]
    nll, mask = per_token_ppl(logits, tgt, ignore_index=ignore_index)
    w = lw.float() * mask
    num = (nll * w).sum()
    return num, [num.detach(), mask.sum().float(), correct, w.sum()]


def _global_metrics(sums, weighted: bool):
    """(denominator, loss, accuracy, loss_sum, count) from the all-reduced
    values of `_local_sums`: the token mean, or the weighted loss with
    ``loss_sum`` = loss x count, as JAX reports it."""
    count = sums[1]
    acc = sums[2] / torch.clamp(count, min=1)
    if not weighted:
        den = torch.clamp(count, min=1)
        return den, sums[0] / den, acc, sums[0], count
    den = torch.clamp(sums[3], min=1e-8)
    loss = sums[0] / den
    return den, loss, acc, loss * count, count


def _global_loss(logits, tgt, ignore_index, world, lw=None):
    """Under a mesh: (the loss this rank backpropagates, the global loss,
    accuracy, loss_sum and count). The local numerator over the global
    denominator (the token count, or the sum of the loss weights,
    all-reduced before the backward: the weights are data and take no
    gradient), so that the ranks' gradients add up to the gradient of the
    global loss; the metrics are the all-reduced sums."""
    num, vals = _local_sums(logits, tgt, ignore_index, lw)
    sums = all_reduce_(torch.stack(vals), world)
    den, loss, acc, loss_sum, count = _global_metrics(sums, lw is not None)
    return num / den, loss, acc, loss_sum, count.round().long()


def all_reduce_grads(params, world) -> None:
    """Sum every parameter's gradient over the ranks, in one flat
    all-reduce (a fixed order: the bits are the same on every rank)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or world.size == 1:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce_(flat, world)
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


def _batch_axis(mesh, tp_plan):
    """The ranks whose batches differ: every rank, or under tensor
    parallelism the data axis (the model ranks share theirs)."""
    if mesh is None:
        return None
    return mesh.world_axis() if tp_plan is None else mesh.axis("data")


def check_shared(tp_plan, named, what: str) -> None:
    """Raise unless every model rank holds the same shared elements of
    ``named`` ((name, tensor) pairs), by their float64 checksums."""
    got = all_gather(tp_plan.shared_checksum(named), tp_plan.axis)
    if not bool((got == got[0]).all()):
        raise RuntimeError(f"the model ranks' shared {what} differ")


def make_train_step(ignore_index: int = 4, accum_steps: int = 1,
                    ema_decay: float = 0.0, mesh=None, dropout: bool = False,
                    dropout_seed: int = 0, tp_plan=None) -> Callable:
    """The train step: ``step(state, batch) -> (state, metrics)``, metrics
    as 0-d tensors on the model's device (no host sync inside but the
    collectives). With a ``mesh`` the batch is this rank's part
    (`parallel/mesh.py shard_batch`), and loss, metrics and gradients are
    global (module docstring); ``tp_plan`` (`parallel/sharding.py
    TPPlan`): the model's parameters are cut over the model axis. With
    ``dropout`` the model is called with a ``dropout_key`` of
    (dropout_seed, step, micro-batch, rank), the rank's data coordinate
    under tensor parallelism."""
    world = _batch_axis(mesh, tp_plan)
    rank = 0 if mesh is None else (mesh.rank if tp_plan is None
                                   else mesh.coord("data"))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        params = [p for p in model.parameters() if p.requires_grad]
        ids, tgt = batch["input_ids"], batch["targets"]
        lw = batch.get("loss_weights")
        if ids.shape[0] % accum_steps:
            raise ValueError(f"batch of {ids.shape[0]} rows does not split "
                             f"into {accum_steps} micro-batches")
        nb = ids.shape[0] // accum_steps
        for p in params:
            p.grad = None
        losses, accs, loss_sums, counts = [], [], [], []
        for i in range(accum_steps):
            rows = slice(i * nb, (i + 1) * nb)
            logits = (model(ids[rows], dropout_key=(dropout_seed, state.step,
                                                    i, rank))
                      if dropout else model(ids[rows]))
            if world is not None:
                loss, mean, acc, loss_sum, count = _global_loss(
                    logits, tgt[rows], ignore_index, world,
                    None if lw is None else lw[rows])
                loss.backward()
                losses.append(mean)
                accs.append(acc)
                loss_sums.append(loss_sum)
                counts.append(count)
                del logits, loss
                continue
            loss, aux = cross_entropy_loss(
                logits, tgt[rows], ignore_index=ignore_index,
                loss_weights=None if lw is None else lw[rows])
            loss.backward()   # sums the micro-batches' gradients in .grad
            losses.append(loss.detach())
            accs.append(accuracy(logits.detach(), tgt[rows],
                                 ignore_index=ignore_index))
            loss_sums.append(aux["loss_sum"].detach())
            counts.append(aux["count"])
            del logits, loss
        if world is not None:
            all_reduce_grads(params, world)
        if accum_steps > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        if tp_plan is None:
            gnorm = global_norm([p.grad for p in params
                                 if p.grad is not None])
        else:
            named = [(n, p.grad) for n, p in model.named_parameters()
                     if p.requires_grad and p.grad is not None]
            if state.step == 0:
                check_shared(tp_plan, named, "gradients")
            gnorm = torch.sqrt(tp_plan.global_sq_norm(named))
        state.optimizer.step(gnorm)
        if ema_decay > 0.0:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    e = state.ema_params[n]
                    e.copy_(ema_decay * e + (1.0 - ema_decay) * p)
        state.step += 1
        metrics = {
            "loss": torch.stack(losses).sum() / accum_steps,
            "acc": torch.stack(accs).sum() / accum_steps,
            "loss_sum": torch.stack(loss_sums).sum(),
            "count": torch.stack(counts).sum(),
            "grad_norm": gnorm,
        }
        return state, metrics

    return train_step


def make_eval_step(model: nn.Module, ignore_index: int = 4, last_k: int = 0,
                   per_token: bool = False, mesh=None,
                   tp_plan=None) -> Callable:
    """The eval step ``eval_step(params, batch) -> metrics`` with the
    reference HG38Task metric family (`src/tasks/tasks.py:244-332`):
    ``loss_sum`` / ``count`` for the streaming ppl, ``acc``, ``loss`` (with
    ``loss_weights`` in the batch the GPN-weighted loss); with ``last_k``
    the last k positions' sums, with ``per_token`` the per-position NLL and
    count summed over the batch. ``params`` (a {state_dict key: tensor}
    dict, e.g. the EMA) replaces the module's own parameters for the call;
    None uses them. Metrics are tensors on the model's device (no host sync
    inside). With a ``mesh`` the batch is this rank's part and every metric
    is global: sums all-reduced over every rank (under tensor parallelism
    over the data axis only), ``loss`` and ``acc`` from them. Under context
    parallelism (a model axis over 2 or more ranks, no ``tp_plan``) rank m
    of M holds columns [m n, (m + 1) n) of the L = M n: its ``last_k`` sums
    score its overlap with the last k columns (none, part or all of its
    own; k >= L is the whole row, as slicing is), and its ``per_token``
    sums go into their columns of length-L vectors before the all-reduce,
    so every rank holds the vectors of one device."""
    world = _batch_axis(mesh, tp_plan)
    cp = mesh is not None and mesh.shape["model"] > 1 and tp_plan is None
    m, M = (mesh.coord("model"), mesh.shape["model"]) if cp else (0, 1)

    def eval_step(params, batch):
        if world is not None:
            return _global_eval(params, batch)
        ids, tgt = batch["input_ids"], batch["targets"]
        with torch.inference_mode():
            logits = (model(ids) if params is None else
                      torch.func.functional_call(model, params, (ids,)))
            loss, aux = cross_entropy_loss(
                logits, tgt, ignore_index=ignore_index,
                loss_weights=batch.get("loss_weights"))
            aux["acc"] = accuracy(logits, tgt, ignore_index=ignore_index)
            aux["loss"] = loss
            if last_k > 0:
                _, lk = cross_entropy_loss(
                    logits[..., -last_k:, :], tgt[..., -last_k:],
                    ignore_index=ignore_index)
                aux["last_k_loss_sum"] = lk["loss_sum"]
                aux["last_k_count"] = lk["count"]
            if per_token:
                nll, mask = per_token_ppl(logits, tgt,
                                          ignore_index=ignore_index)
                aux["pos_nll_sum"] = nll.reshape(-1, nll.shape[-1]).sum(0)
                aux["pos_count"] = mask.reshape(-1, mask.shape[-1]).sum(0)
        return aux

    def _global_eval(params, batch):
        ids, tgt = batch["input_ids"], batch["targets"]
        lw = batch.get("loss_weights")
        n = tgt.shape[-1]                 # this rank's columns
        with torch.inference_mode():
            logits = (model(ids) if params is None else
                      torch.func.functional_call(model, params, (ids,)))
            _, vals = _local_sums(logits, tgt, ignore_index, lw)
            k = len(vals)
            if last_k > 0:
                # the window [L - last_k, L) in this rank's columns
                lo = min(max(M * n - last_k - m * n, 0), n)
                _, lk = cross_entropy_loss(
                    logits[..., lo:, :], tgt[..., lo:],
                    ignore_index=ignore_index)
                vals += [lk["loss_sum"].float(), lk["count"].float()]
            sums = all_reduce_(torch.stack(vals), world)
            _, loss, acc, loss_sum, count = _global_metrics(
                sums[:k], lw is not None)
            out = {"loss_sum": loss_sum, "count": count, "acc": acc,
                   "loss": loss}
            if last_k > 0:
                out["last_k_loss_sum"], out["last_k_count"] = (sums[k],
                                                               sums[k + 1])
            if per_token:
                nll, mask = per_token_ppl(logits, tgt,
                                          ignore_index=ignore_index)
                pos = torch.zeros(2, M * n, dtype=torch.float32,
                                  device=logits.device)
                pos[0, m * n:(m + 1) * n] = nll.reshape(-1, n).sum(0)
                pos[1, m * n:(m + 1) * n] = mask.reshape(-1, n).sum(0)
                all_reduce_(pos, world)
                out["pos_nll_sum"], out["pos_count"] = pos[0], pos[1]
        return out

    return eval_step


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: on a card through pinned
    memory with ``non_blocking=True``, so the copy is queued behind the
    work already on the stream and the host does not wait for it."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_to_device(loader, device: torch.device, size: int = 2):
    """Yield (device batch, loader state after it) from one host thread
    that builds up to ``size`` batches ahead of the consumer.

    The loader state travels with its batch: a checkpoint written after
    batch N records the position after N, although the loader has already
    produced N + size. Closing the generator (``fit`` reaching max_steps
    mid-epoch) stops the thread before the loader is touched again."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    stop = object()
    done = threading.Event()   # the consumer is gone
    err = []

    def put(item) -> bool:
        while not done.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in loader:
                st = (loader.state_dict() if hasattr(loader, "state_dict")
                      else None)
                if not put((to_device(b, device), st)):
                    return
        except BaseException as e:  # noqa: BLE001 (raised by the consumer)
            err.append(e)
        finally:
            put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        done.set()
        t.join(timeout=30.0)
        if t.is_alive():
            raise RuntimeError("the prefetch thread did not stop")


class _Sharded:
    """A loader whose batches are cut to this rank's part by ``shard``; its
    state is the wrapped loader's (the global batches' position)."""

    def __init__(self, loader, shard):
        self.loader, self.shard = loader, shard

    def __iter__(self):
        for b in self.loader:
            yield self.shard(b)

    def state_dict(self):
        return (self.loader.state_dict()
                if hasattr(self.loader, "state_dict") else None)


def _sync_stream(loader, device):
    for b in loader:
        st = loader.state_dict() if hasattr(loader, "state_dict") else None
        yield to_device(b, device), st


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 10_000
    log_every: int = 50
    eval_every: int = 1_000
    eval_batches: int = 16
    # HG38Task metric family (`src/tasks/tasks.py:244-332`)
    eval_last_k: int = 0      # 0 = off; else ppl over the last k positions
    eval_per_token: bool = False  # write the per-position ppl curve
    checkpoint_every: int = 500
    accum_steps: int = 1
    prefetch: int = 2  # batches built ahead by the host thread (0: none)
    ema_decay: float = 0.0  # 0 disables EMA tracking
    dropout: bool = False  # models with dropout layers (the Hyena family)
    profile_dir: Optional[str] = None  # torch.profiler trace of steps 10-13
    run_dir: str = "./outputs/run"
    seed: int = 2222
    # optimizer
    lr: float = 8e-3
    weight_decay: float = 0.1
    betas: tuple = (0.9, 0.95)
    warmup_frac: float = 0.1
    lr_min: float = 1e-4
    warmup_lr_init: float = 1e-6
    gradient_clip: float = 1.0


class Trainer:
    """Step-based training loop with streaming metrics, periodic eval and
    resumable checkpoints that carry the data loader's position (the
    reference's fault-tolerant resume contract, SURVEY.md §5.3/§5.4).

    ``model`` is a `CaduceusForMaskedLM` or a `HyenaLMHeadModel` on the
    device the loop runs on; its current parameters are the initial
    state."""

    def __init__(self, model: nn.Module, cfg: TrainerConfig, train_loader,
                 eval_loader=None, mesh=None, ignore_index: int = 4,
                 log_fn: Optional[Callable[[Dict], None]] = None,
                 lr_overrides=None,
                 tensor_parallel: bool = False,
                 context_parallel: bool = False):
        if tensor_parallel and context_parallel:
            raise ValueError("tensor and context parallelism share the "
                             "model axis: pick one per run (as the JAX CLI "
                             "does)")
        self.tp_plan = None
        if tensor_parallel:
            from caduceus_tpu_torch.parallel.mesh import set_global_mesh
            from caduceus_tpu_torch.parallel.sharding import shard_module_

            if mesh is None or mesh.shape["model"] < 2:
                raise ValueError("tensor parallelism needs a mesh with a "
                                 "model axis of 2 or more")
            set_global_mesh(mesh)
            self.tp_plan = (getattr(model, "tp_plan", None)
                            or shard_module_(model, mesh))
        if context_parallel:
            from caduceus_tpu_torch.parallel.mesh import set_global_mesh

            if mesh is None or mesh.shape["model"] < 2:
                raise ValueError("context parallelism needs a mesh with a "
                                 "model axis of 2 or more")
            if getattr(model.cfg, "context_parallel_axis", None) != "model":
                raise ValueError("context parallelism needs the model "
                                 "config's context_parallel_axis = 'model'")
            set_global_mesh(mesh)
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self.context_parallel = context_parallel
        self.is_main = mesh is None or mesh.is_main
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.device = next(model.parameters()).device
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"the model is on {self.device}, the mesh's "
                             f"device is {mesh.device}")
        self.ignore_index = ignore_index
        self.lr_overrides = lr_overrides
        if log_fn is None:
            log_fn = ((lambda m: print(json.dumps(m))) if self.is_main
                      else (lambda m: None))
        self.log_fn = log_fn
        self.ppl = Perplexity()
        self.num_tokens = NumTokens()
        self._eval_step = make_eval_step(
            model, ignore_index, last_k=cfg.eval_last_k,
            per_token=cfg.eval_per_token, mesh=mesh, tp_plan=self.tp_plan)
        self._train_step = None
        self._consumed_loader_state = None
        self._warned_eval_reset = False
        self.schedule = None
        self.state: Optional[TrainState] = None

    # -- setup -------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Optimizer, step 0 and (with ``ema_decay``) the EMA, from the
        model's current parameters."""
        cfg = self.cfg
        warmup_t = int(cfg.warmup_frac * cfg.max_steps)
        opt, self.schedule = make_optimizer(
            self.model.named_parameters(), lr=cfg.lr,
            weight_decay=cfg.weight_decay, betas=cfg.betas,
            warmup_t=warmup_t, t_initial=cfg.max_steps - warmup_t,
            lr_min=cfg.lr_min, warmup_lr_init=cfg.warmup_lr_init,
            gradient_clip=cfg.gradient_clip, lr_overrides=self.lr_overrides)
        ema = init_ema(self.model) if cfg.ema_decay > 0 else None
        self.state = TrainState(self.model, opt, 0, ema)
        self._train_step = make_train_step(
            self.ignore_index, cfg.accum_steps, ema_decay=cfg.ema_decay,
            mesh=self.mesh, dropout=cfg.dropout, dropout_seed=cfg.seed,
            tp_plan=self.tp_plan)
        if self.mesh is not None:
            self.check_same_params()
        return self.state

    def check_same_params(self) -> torch.Tensor:
        """All-gather a checksum of the parameters (per tensor: the float64
        sums of p and of p times its flat index) and raise unless every
        rank holds the same (under tensor parallelism: every rank of the
        data axis the same part, every rank of the model axis the same
        shared elements); returns the gathered checksums."""
        sums = []
        for p in self.model.parameters():
            v = p.detach().reshape(-1).double()
            idx = torch.arange(1, v.numel() + 1, device=v.device,
                               dtype=torch.float64)
            sums += [v.sum(), (v * idx).sum()]
        if self.tp_plan is not None:
            check_shared(self.tp_plan, list(self.model.named_parameters()),
                         "parameters")
        got = all_gather(torch.stack(sums),
                         _batch_axis(self.mesh, self.tp_plan))
        if not bool((got == got[0]).all()):
            bad = [r for r in range(got.shape[0])
                   if not bool((got[r] == got[0]).all())]
            raise RuntimeError(f"ranks {bad} initialized other parameters "
                               "than rank 0 (the same seed must give the "
                               "same init)")
        return got

    def _shard(self, batch):
        """This rank's part of a host batch (all of it without a mesh)."""
        if self.mesh is None:
            return batch
        return shard_batch(self.mesh, batch, cp=self.context_parallel,
                           accum_steps=self.cfg.accum_steps)

    def _stream(self):
        loader = (self.train_loader if self.mesh is None
                  else _Sharded(self.train_loader, self._shard))
        if self.cfg.prefetch > 0:
            return prefetch_to_device(loader, self.device, self.cfg.prefetch)
        return _sync_stream(loader, self.device)

    # -- loop --------------------------------------------------------------
    def fit(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        if self.state is None:
            raise RuntimeError("call init_state() (and restore_checkpoint()) "
                               "before fit()")
        max_steps = max_steps or self.cfg.max_steps
        os.makedirs(self.cfg.run_dir, exist_ok=True)
        step = self.state.step
        last_metrics: Dict[str, float] = {}
        last_m = None
        prof = None
        t0 = time.time()
        tokens_since_log = 0
        empty_passes = 0
        while step < max_steps:
            stream = self._stream()
            n_batches = 0
            try:
                for batch, loader_state in stream:
                    n_batches += 1
                    if self.cfg.profile_dir and step == 10:
                        prof = self._start_profile()
                    self.state, m = self._train_step(self.state, batch)
                    self._consumed_loader_state = loader_state
                    last_m = m
                    step = self.state.step
                    if prof is not None and step == 13:
                        self._stop_profile(prof)
                        prof = None
                    # every rank's targets are its own tokens (the model
                    # ranks' the same under tensor parallelism)
                    tokens_since_log += batch["targets"].numel() * (
                        1 if self.mesh is None else
                        _batch_axis(self.mesh, self.tp_plan).size)
                    if step % self.cfg.log_every == 0:
                        m = {k: float(v) for k, v in m.items()}
                        self.ppl.update(m["loss_sum"], m["count"])
                        self.num_tokens.update(m["count"])
                        dt = time.time() - t0
                        last_metrics = {
                            "step": step,
                            "loss": m["loss"],
                            "acc": m["acc"],
                            "ppl": self.ppl.compute(),
                            "grad_norm": m["grad_norm"],
                            "lr": float(self.schedule(step)),
                            "tokens_per_sec": tokens_since_log / dt,
                        }
                        self.log_fn(last_metrics)
                        t0 = time.time()
                        tokens_since_log = 0
                    if (self.eval_loader is not None
                            and step % self.cfg.eval_every == 0):
                        # a new dict: the logged step record stays as logged
                        last_metrics = {**last_metrics, **self.evaluate()}
                    if step % self.cfg.checkpoint_every == 0:
                        self.save_checkpoint()
                    if step >= max_steps:
                        break
            finally:
                stream.close()
                if prof is not None:   # ended inside the trace window
                    self._stop_profile(prof)
                    prof = None
            # the thread built batches past the last one consumed: put the
            # loader back, so the next fit() continues where this one ended
            if n_batches and hasattr(self.train_loader, "load_state_dict"):
                self.train_loader.load_state_dict(self._consumed_loader_state)
            empty_passes = 0 if n_batches else empty_passes + 1
            if empty_passes == 2:
                raise RuntimeError("the train loader yields no batch")
        if not last_metrics and last_m is not None:
            m = {k: float(v) for k, v in last_m.items()}
            last_metrics = {"step": step, "loss": m["loss"], "acc": m["acc"],
                            "grad_norm": m["grad_norm"]}
            self.log_fn(last_metrics)
        return last_metrics

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                self.cfg.profile_dir))
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()

    def evaluate(self, max_batches: Optional[int] = None,
                 prefix: str = "val") -> Dict[str, float]:
        """Metrics of the model (and, with EMA, of the EMA weights under
        ``<prefix>/ema``) over the first ``max_batches`` batches of the
        eval loader; every call scores the same batches."""
        max_batches = max_batches or self.cfg.eval_batches
        out = self._run_eval(None, prefix, max_batches)
        if self.state is not None and self.state.ema_params is not None:
            out.update(self._run_eval(self.state.ema_params,
                                      f"{prefix}/ema", max_batches))
        if out:
            self.log_fn(out)
        return out

    def _run_eval(self, params, tag: str, max_batches: int):
        ppl = Perplexity()
        lk = Perplexity()
        acc_w = cnt_w = 0.0
        pos_nll = pos_cnt = None
        n_batches = 0
        # score a fixed prefix of the split on every call: the sampler is
        # stateful (the resume contract), so without the reset consecutive
        # evals would score a rolling window of the split
        sampler = getattr(self.eval_loader, "sampler", None)
        if sampler is not None and hasattr(sampler, "load_state_dict"):
            sampler.load_state_dict({"epoch": 0, "counter": 0})
        elif not self._warned_eval_reset:
            warnings.warn("the eval loader has no resettable sampler: each "
                          "evaluate() scores the batches it yields next")
            self._warned_eval_reset = True
        for i, batch in enumerate(self.eval_loader):
            if i >= max_batches:
                break
            m = self._eval_step(params, to_device(
                shard_batch(self.mesh, batch, cp=self.context_parallel)
                if self.mesh is not None else batch, self.device))
            m = {k: (v.cpu().numpy() if v.dim() else float(v))
                 for k, v in m.items()}
            ppl.update(m["loss_sum"], m["count"])
            # token-weighted means: a ragged last batch would bias a mean
            # of per-batch values
            acc_w += m["acc"] * m["count"]
            cnt_w += m["count"]
            if "last_k_loss_sum" in m:
                lk.update(m["last_k_loss_sum"], m["last_k_count"])
            if "pos_nll_sum" in m:
                pos_nll = m["pos_nll_sum"] + (0 if pos_nll is None else pos_nll)
                pos_cnt = m["pos_count"] + (0 if pos_cnt is None else pos_cnt)
            n_batches += 1
        if n_batches == 0:
            return {}
        out = {
            f"{tag}/loss": float(np.log(max(ppl.compute(), 1e-30))),
            f"{tag}/acc": acc_w / max(cnt_w, 1.0),
            f"{tag}/ppl": ppl.compute(),
        }
        if self.cfg.eval_last_k > 0:
            out[f"{tag}/last_{self.cfg.eval_last_k}_ppl"] = lk.compute()
        if pos_nll is not None:
            # every rank holds the whole curve; rank 0 writes it
            path = os.path.join(
                self.cfg.run_dir, f"per_token_ppl_{tag.replace('/', '_')}.npy")
            if self.is_main:
                os.makedirs(self.cfg.run_dir, exist_ok=True)
                np.save(path, np.exp(pos_nll / np.maximum(pos_cnt, 1)))
            out[f"{tag}/per_token_ppl_file"] = path
        return out

    # -- checkpoint --------------------------------------------------------
    def save_checkpoint(self, path: Optional[str] = None) -> Optional[str]:
        """Write a checkpoint (rank 0 only; every rank holds the same
        state, or under tensor parallelism its part, which every rank
        gathers first); returns its path, None on the other ranks."""
        from caduceus_tpu_torch.train.checkpoint import (map_moments,
                                                         save_checkpoint)

        whole = None
        if self.tp_plan is not None:
            plan, st = self.tp_plan, self.state
            whole = {"params": plan.gather_state(self.model.state_dict()),
                     "ema": (None if st.ema_params is None
                             else plan.gather_state(st.ema_params)),
                     "optimizer": map_moments(st.optimizer.state_dict(),
                                              st.optimizer, self.model,
                                              plan.whole)}
        if not self.is_main:
            return None
        path = path or os.path.join(self.cfg.run_dir, "checkpoints")
        # the state captured when the last batch was consumed (the loader
        # itself has run ahead by the prefetched batches)
        loader_state = self._consumed_loader_state
        if loader_state is None and hasattr(self.train_loader, "state_dict"):
            loader_state = self.train_loader.state_dict()
        return save_checkpoint(path, self.state, loader_state, whole)

    def restore_checkpoint(self, path: Optional[str] = None) -> bool:
        """Resume from the newest checkpoint under ``path``: the port's
        ``<step>/`` or a JAX run's Orbax ``<step>/`` (its optimizer state
        mapped onto AdamW's, `train/checkpoint.py
        restore_jax_checkpoint`), the port's on a tie; False if there is
        none."""
        from caduceus_tpu_torch.train import checkpoint

        path = path or os.path.join(self.cfg.run_dir, "checkpoints")
        ours, theirs = (checkpoint.latest_step(path),
                        checkpoint.jax_latest_step(path))
        if ours is None and theirs is None:
            return False
        restore = (checkpoint.restore_jax_checkpoint
                   if ours is None or (theirs is not None and theirs > ours)
                   else checkpoint.restore_checkpoint)
        loader_state = restore(path, self.state, self.tp_plan)
        self._consumed_loader_state = loader_state
        if loader_state is not None and hasattr(self.train_loader,
                                                "load_state_dict"):
            self.train_loader.load_state_dict(loader_state)
        return True
