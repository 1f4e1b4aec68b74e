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

The `Trainer` runs one device. Not ported yet: dropout (the Hyena family,
ROADMAP.md queue 1 item 7) and the mesh, tensor- and context-parallel
arguments (queue 1 item 8); they raise `NotImplementedError`.
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


def make_train_step(ignore_index: int = 4, accum_steps: int = 1,
                    ema_decay: float = 0.0) -> Callable:
    """The train step: ``step(state, batch) -> (state, metrics)``, metrics
    as 0-d tensors on the model's device (no host sync inside)."""

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
            logits = model(ids[rows])
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
        if accum_steps > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        gnorm = global_norm([p.grad for p in params if p.grad is not None])
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
                   per_token: bool = False) -> Callable:
    """The eval step ``eval_step(params, batch) -> metrics`` with the
    reference HG38Task metric family (`src/tasks/tasks.py:244-332`):
    ``loss_sum`` / ``count`` for the streaming ppl, ``acc``, ``loss``;
    with ``last_k`` the last k positions' sums, with ``per_token`` the
    per-position NLL and count summed over the batch. ``params`` (a
    {state_dict key: tensor} dict, e.g. the EMA) replaces the module's own
    parameters for the call; None uses them. Metrics are tensors on the
    model's device (no host sync inside)."""

    def eval_step(params, batch):
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
    dropout: bool = False  # models with dropout layers: not ported yet
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

    ``model`` is a `CaduceusForMaskedLM` on the device the loop runs on;
    its current parameters are the initial state."""

    def __init__(self, model: nn.Module, cfg: TrainerConfig, train_loader,
                 eval_loader=None, mesh=None, ignore_index: int = 4,
                 log_fn: Optional[Callable[[Dict], None]] = None,
                 tensor_parallel: bool = False,
                 context_parallel: bool = False):
        if cfg.dropout:
            raise NotImplementedError(
                "dropout (the Hyena family) is not ported yet: ROADMAP.md "
                "queue 1 item 7")
        if mesh is not None or tensor_parallel or context_parallel:
            raise NotImplementedError(
                "meshes, tensor and context parallelism are not ported yet: "
                "ROADMAP.md queue 1 item 8")
        self.model = model
        self.cfg = cfg
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.device = next(model.parameters()).device
        self.ignore_index = ignore_index
        self.log_fn = log_fn or (lambda m: print(json.dumps(m)))
        self.ppl = Perplexity()
        self.num_tokens = NumTokens()
        self._eval_step = make_eval_step(
            model, ignore_index, last_k=cfg.eval_last_k,
            per_token=cfg.eval_per_token)
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
            gradient_clip=cfg.gradient_clip)
        ema = init_ema(self.model) if cfg.ema_decay > 0 else None
        self.state = TrainState(self.model, opt, 0, ema)
        self._train_step = make_train_step(
            self.ignore_index, cfg.accum_steps, ema_decay=cfg.ema_decay)
        return self.state

    def _stream(self):
        if self.cfg.prefetch > 0:
            return prefetch_to_device(self.train_loader, self.device,
                                      self.cfg.prefetch)
        return _sync_stream(self.train_loader, self.device)

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
                    tokens_since_log += batch["input_ids"].numel()
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
            m = self._eval_step(params, to_device(batch, self.device))
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
            curve = np.exp(pos_nll / np.maximum(pos_cnt, 1))
            os.makedirs(self.cfg.run_dir, exist_ok=True)
            path = os.path.join(
                self.cfg.run_dir, f"per_token_ppl_{tag.replace('/', '_')}.npy")
            np.save(path, curve)
            out[f"{tag}/per_token_ppl_file"] = path
        return out

    # -- checkpoint --------------------------------------------------------
    def save_checkpoint(self, path: Optional[str] = None) -> str:
        from caduceus_tpu_torch.train.checkpoint import save_checkpoint

        path = path or os.path.join(self.cfg.run_dir, "checkpoints")
        # the state captured when the last batch was consumed (the loader
        # itself has run ahead by the prefetched batches)
        loader_state = self._consumed_loader_state
        if loader_state is None and hasattr(self.train_loader, "state_dict"):
            loader_state = self.train_loader.state_dict()
        return save_checkpoint(path, self.state, loader_state)

    def restore_checkpoint(self, path: Optional[str] = None) -> bool:
        """Resume from the latest port checkpoint under ``path``; False if
        there is none. Raises on a JAX run's Orbax checkpoints, whose
        optimizer state the port does not take."""
        from caduceus_tpu_torch.train import checkpoint

        path = path or os.path.join(self.cfg.run_dir, "checkpoints")
        if checkpoint.latest_step(path) is None:
            if checkpoint.jax_latest_step(path) is not None:
                raise NotImplementedError(
                    f"{path} holds a JAX run's Orbax checkpoints: resuming "
                    "its optimizer state is not ported (its weights load "
                    "through params.py load_run_dir)")
            return False
        loader_state = checkpoint.restore_checkpoint(path, self.state)
        self._consumed_loader_state = loader_state
        if loader_state is not None and hasattr(self.train_loader,
                                                "load_state_dict"):
            self.train_loader.load_state_dict(loader_state)
        return True
