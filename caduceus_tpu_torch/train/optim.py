"""Optimizer and learning-rate schedules of the training step.

Port of `caduceus_tpu/train/optim.py`:

- `weight_decay_mask` (`:43`): decay applies to 2-D+ parameters whose flax
  path holds none of the exempt names (biases, norms, the embedding, A_log,
  D, conv_b). The decision is taken on the flax path of each parameter
  (`params.py flax_path`), so the two masks agree leaf for leaf: ``conv_w``
  (K, Wc) is decayed, ``embedding`` is not;
- the schedules of `SCHEDULE_REGISTRY` (`:243`), timm semantics for the
  cosine with a linear warmup prefix;
- `make_optimizer` (`:254`): clip by global norm, then AdamW with betas
  (0.9, 0.95), eps 1e-8 outside the root and decoupled decay scaled by the
  scheduled lr (optax's `clip_by_global_norm` + `adamw`, realised with
  `torch.optim.AdamW`), on the schedule ``schedule_name`` names (`:275-286`).
  Not ported yet: ``lr_overrides``, ``layer_decay`` and ``wd_mask_fn``
  (Hyena and fine-tuning).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from caduceus_tpu_torch.params import flax_path

# flax path components exempt from weight decay
_NO_DECAY_TOKENS = (
    "bias",
    "norm_w",
    "norm_b",
    "norm_f_w",
    "norm_f_b",
    "embedding",
    "A_log",
    "D",
    "dt_proj_b",
    "conv_b",
)

Schedule = Callable[[int], float]


def weight_decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]
                      ) -> Dict[str, bool]:
    """{state_dict key: True where weight decay applies}."""
    out = {}
    for name, p in named_params:
        parts = flax_path(name).split("/")
        out[name] = (not any(n in _NO_DECAY_TOKENS for n in parts)
                     and p.dim() >= 2)
    return out


def _warm(step, lr, warmup_t, warmup_lr_init):
    return (warmup_lr_init + (lr - warmup_lr_init) * min(step, warmup_t)
            / max(warmup_t, 1))


def cosine_warmup_schedule(lr: float, warmup_t: int, t_initial: int,
                           lr_min: float = 0.0,
                           warmup_lr_init: float = 1e-6) -> Schedule:
    """TimmCosineLRScheduler with warmup_prefix=True: the cosine phase
    spans `t_initial` steps *after* warmup."""

    def schedule(step):
        if step < warmup_t:
            return _warm(step, lr, warmup_t, warmup_lr_init)
        t = min(max(step - warmup_t, 0), t_initial)
        return lr_min + 0.5 * (lr - lr_min) * (
            1 + math.cos(math.pi * t / max(t_initial, 1)))

    return schedule


def constant_schedule(lr: float) -> Schedule:
    return lambda step: lr


def constant_warmup_schedule(lr: float, warmup_t: int,
                             warmup_lr_init: float = 1e-6) -> Schedule:
    return lambda step: (_warm(step, lr, warmup_t, warmup_lr_init)
                         if step < warmup_t else lr)


def linear_warmup_schedule(lr: float, warmup_t: int, t_initial: int,
                           lr_min: float = 0.0,
                           warmup_lr_init: float = 1e-6) -> Schedule:
    """Linear warmup then linear decay to lr_min."""

    def schedule(step):
        if step < warmup_t:
            return _warm(step, lr, warmup_t, warmup_lr_init)
        t = min(max(step - warmup_t, 0), t_initial)
        return lr + (lr_min - lr) * t / max(t_initial, 1)

    return schedule


def inv_sqrt_schedule(lr: float, warmup_t: int,
                      warmup_lr_init: float = 1e-6) -> Schedule:
    """InvSqrt: lr * sqrt(warmup / step) after warmup."""

    def schedule(step):
        if step < warmup_t:
            return _warm(step, lr, warmup_t, warmup_lr_init)
        w = max(warmup_t, 1)
        return lr * math.sqrt(w / max(step, w))

    return schedule


def multistep_schedule(lr: float, milestones, gamma: float = 0.1) -> Schedule:
    return lambda step: lr * gamma ** sum(step >= m for m in milestones)


SCHEDULE_REGISTRY = {
    "constant": constant_schedule,
    "constant_warmup": constant_warmup_schedule,
    "linear_warmup": linear_warmup_schedule,
    "cosine_warmup": cosine_warmup_schedule,
    "cosine_warmup_timm": cosine_warmup_schedule,
    "inv_sqrt": inv_sqrt_schedule,
    "multistep": multistep_schedule,
}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ t²) over all tensors, in fp32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Optimizer:
    """Clip by global norm, then AdamW at the scheduled lr.

    ``step()`` reads each parameter's ``.grad``, clips all of them as optax
    does — g·max_norm/‖g‖ when ‖g‖ ≥ max_norm, g unchanged below (no
    epsilon, unlike `torch.nn.utils.clip_grad_norm_`) — sets the lr of
    update ``count`` (0 first) and applies one `torch.optim.AdamW` step.
    Parameters outside the decay mask get weight_decay 0."""

    def __init__(self, named_params, schedule: Schedule, weight_decay: float,
                 betas, eps: float, gradient_clip: Optional[float],
                 mask: Dict[str, bool]):
        named = list(named_params)
        decay = [p for n, p in named if mask[n]]
        rest = [p for n, p in named if not mask[n]]
        self.params = [p for _, p in named]
        self.schedule = schedule
        self.gradient_clip = gradient_clip
        self.count = 0
        self.opt = torch.optim.AdamW(
            [{"params": decay, "weight_decay": weight_decay},
             {"params": rest, "weight_decay": 0.0}],
            lr=schedule(0), betas=tuple(betas), eps=eps)

    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.gradient_clip is not None:
            norm = global_norm(grads) if grad_norm is None else grad_norm
            keep = norm < self.gradient_clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.gradient_clip))
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        """The update count (the schedule's step) and AdamW's state."""
        return {"count": self.count, "adamw": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.opt.load_state_dict(state["adamw"])


def make_optimizer(
    named_params,
    lr: float = 8e-3,
    weight_decay: float = 0.1,
    betas=(0.9, 0.95),
    warmup_t: int = 0,
    t_initial: int = 10_000,
    lr_min: float = 0.0,
    warmup_lr_init: float = 1e-6,
    gradient_clip: Optional[float] = 1.0,
    schedule_name: str = "cosine_warmup_timm",
):
    """AdamW + the schedule ``schedule_name`` + clipping over
    ``named_params`` (e.g. ``model.named_parameters()``); returns
    (optimizer, schedule)."""
    if schedule_name in ("cosine_warmup", "cosine_warmup_timm"):
        schedule = cosine_warmup_schedule(lr, warmup_t, t_initial, lr_min,
                                          warmup_lr_init)
    elif schedule_name == "constant":
        schedule = constant_schedule(lr)
    elif schedule_name == "constant_warmup":
        schedule = constant_warmup_schedule(lr, warmup_t, warmup_lr_init)
    elif schedule_name == "linear_warmup":
        schedule = linear_warmup_schedule(lr, warmup_t, t_initial, lr_min,
                                          warmup_lr_init)
    elif schedule_name == "inv_sqrt":
        schedule = inv_sqrt_schedule(lr, warmup_t, warmup_lr_init)
    else:
        raise KeyError(f"unknown schedule: {schedule_name} "
                       f"(have {list(SCHEDULE_REGISTRY)})")
    named = list(named_params)
    return Optimizer(named, schedule, weight_decay, betas, 1e-8,
                     gradient_clip, weight_decay_mask(named)), schedule
