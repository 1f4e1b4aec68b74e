"""The MLM training step.

Port of `caduceus_tpu/train/trainer.py` `TrainState` (`:41`) and
`make_train_step` (`:56-147`): forward, masked cross-entropy, backward,
clip + AdamW, metrics, with gradient accumulation over micro-batches and an
optional EMA of the weights. PyTorch keeps the parameters in the module and
the optimizer state in the optimizer, so `TrainState` holds those two, the
step count and the EMA tensors.

A batch is ``{"input_ids", "targets"[, "loss_weights"]}`` of shape
``(accum_steps * B, L)``, split into ``accum_steps`` consecutive
micro-batches of B rows, as the JAX step reshapes it. The step's gradient
is the mean of the micro-batches' gradients; its loss and accuracy are the
means of theirs, ``loss_sum`` and ``count`` their sums, and ``grad_norm``
the global norm of the mean gradient before clipping.

Not ported yet (with the `Trainer`, queue 1 item 3): dropout rngs, the
eval step, the training loop, checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from caduceus_tpu_torch.train.metrics import accuracy, cross_entropy_loss
from caduceus_tpu_torch.train.optim import Optimizer, global_norm


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
