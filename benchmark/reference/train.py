"""Training steps of the reference: the loss, its gradients by autograd,
clipping by the global norm, and AdamW with decoupled weight decay at a
cosine schedule with a linear warm-up (timm's semantics), all in fp32.

`follow(...)` replays the first steps of a run from the initial weights
and returns what the comparison reads: each step's loss, the first
step's clipped gradient (what the optimizer received) and the weights
after the last step.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch


def lr_at(step: int, opt: dict) -> float:
    """The scheduled learning rate of update ``step`` (0 first)."""
    lr, warm = opt["lr"], opt["warmup_steps"]
    init = opt.get("warmup_lr_init", 1e-6)
    if step < warm:
        return init + (lr - init) * step / max(warm, 1)
    total, lr_min = opt["cosine_steps"], opt["lr_min"]
    t = min(step - warm, total)
    return lr_min + 0.5 * (lr - lr_min) * (1 + math.cos(math.pi * t
                                                        / max(total, 1)))


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay applies to matrices other than the embedding and A."""
    leaf = name.rsplit(".", 1)[-1]
    return p.dim() >= 2 and leaf not in ("embedding", "A_log")


class AdamW:
    """torch.optim.AdamW's update, written out."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict):
        self.p = params
        self.opt = opt
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Clip ``grads`` by their global norm, update; returns the clipped
        gradients."""
        o = self.opt
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        if norm >= o["clip"]:
            grads = {k: g / norm * o["clip"] for k, g in grads.items()}
        lr = lr_at(self.count, o)
        b1, b2 = o["betas"]
        t = self.count + 1
        for k, p in self.p.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            if decays(k, p):
                p = p * (1 - lr * o["weight_decay"])
            denom = (self.v[k] / (1 - b2 ** t)).sqrt() + o.get("eps", 1e-8)
            self.p[k] = p - lr / (1 - b1 ** t) * self.m[k] / denom
        self.count += 1
        return grads


def follow(weights: Dict[str, torch.Tensor], steps: List[list],
           loss_fn: Callable, opt: dict) -> dict:
    """Replay ``len(steps)`` optimizer steps from ``weights``: each step is
    a list of micro-batches, ``loss_fn(weights, micro_batch)`` returns a
    micro-batch's mean loss, and the gradients of the micro-batches are
    averaged. Returns {"losses", "grad1", "params"}."""
    params = {k: v.detach().float().clone() for k, v in weights.items()}
    adam = AdamW(params, opt)
    losses, grad1 = [], None
    for micro in steps:
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for mb in micro:
            leaves = {k: v.detach().requires_grad_() for k, v in
                      adam.p.items()}
            loss = loss_fn(leaves, mb)
            names = list(leaves)
            got = torch.autograd.grad(loss, [leaves[k] for k in names],
                                      allow_unused=True)
            for k, g in zip(names, got):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach())
            del loss, got, leaves
        grads = {k: g / len(micro) for k, g in grads.items()}
        losses.append(total / len(micro))
        clipped = adam.step(grads)
        if grad1 is None:
            grad1 = clipped
    return {"losses": losses, "grad1": grad1, "params": adam.p}
