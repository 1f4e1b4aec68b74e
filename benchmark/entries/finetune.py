"""Fine-tuning through the port's `finetune.make_finetune_step` on a
`DNAClassifier` (mean pooling over both strands), with AdamW and the
schedule that `finetune.finetune_one` builds for the task's steps.

Set-up builds the SSD kernels, the classifier with the benchmark's
weights and the optimizer, then takes the first steps through the same
step function the window calls (the first moment after step 1 and the
weights after the last are kept). The window steps seeded batches, made
on the device, for about ``--seconds``.
"""

from __future__ import annotations

import time

import torch

from benchmark import flops as flops_mod
from benchmark.generate import classify_batch
from benchmark.harness import Context, first_moment, release
from benchmark.weights import make_weights


class Entry:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        t = ctx.cell.traffic
        self.B, self.L, self.labels = t["batch"], t["seq_len"], t["labels"]
        self.first_steps = ctx.cell.settings["reference_steps"]
        self.next_batch = 0

    def _batch(self):
        b = classify_batch(self.ctx.seed, self.next_batch, self.B, self.L,
                           self.labels, self.ctx.device)
        self.next_batch += 1
        return b

    def setup(self) -> dict:
        from caduceus_tpu_torch.config import CaduceusConfig
        from caduceus_tpu_torch.finetune import (
            DNAClassifier,
            make_finetune_step,
        )
        from caduceus_tpu_torch.train.optim import make_optimizer

        ctx, t = self.ctx, self.ctx.cell.traffic
        mc = ctx.cell.model_cfg
        parts = {}
        t0 = time.perf_counter()
        if ctx.device.type == "cuda":
            from caduceus_tpu_torch.ops import ssd_batched
            ssd_batched.build()
        parts["kernels_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.cfg = CaduceusConfig(**mc)
        self.model = DNAClassifier(self.cfg, self.labels, t["pooling"],
                                   use_lengths=False, padding_side="left",
                                   device=ctx.device)
        names = [(n, p.shape) for n, p in self.model.named_parameters()]
        self.w0 = make_weights(names, mc, ctx.seed, ctx.device)
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(self.w0[n])
        o = t["optimizer"]
        self.opt, _ = make_optimizer(
            self.model.named_parameters(), lr=o["lr"],
            weight_decay=o["weight_decay"], betas=tuple(o["betas"]),
            warmup_t=o["warmup_steps"], t_initial=o["cosine_steps"],
            lr_min=o["lr_min"], warmup_lr_init=o["warmup_lr_init"],
            gradient_clip=o["clip"])
        self.step = make_finetune_step(self.model, self.opt,
                                       "single_label_classification")
        ctx.sync()
        parts["model_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.losses = [float(self.step(self._batch()))]
        b1 = o["betas"][0]
        self.grad1 = {n: first_moment(self.opt.opt, p) / (1 - b1)
                      for n, p in self.model.named_parameters()}
        ctx.sync()
        t1 = time.perf_counter()
        for _ in range(self.first_steps - 1):
            self.losses.append(float(self.step(self._batch())))
        t2 = time.perf_counter()
        self.params = {n: p.detach().clone()
                       for n, p in self.model.named_parameters()}
        self.step_s = (t2 - t1) / max(self.first_steps - 1, 1)
        parts["warmup_s"] = t2 - t0
        return parts

    def _run(self, steps: int) -> dict:
        t0 = time.perf_counter()
        self.window_losses = [self.step(self._batch())
                              for _ in range(steps)]
        self.ctx.sync()
        elapsed = time.perf_counter() - t0
        return {"steps": steps, "seqs": steps * self.B, "elapsed_s": elapsed,
                "attempted": steps, "step_s_setup": self.step_s}

    def finish(self, work: dict) -> dict:
        """The window's failures, counted after it: steps whose loss is not
        finite."""
        losses = torch.stack(self.window_losses)
        return {**work, "failed": int((~torch.isfinite(losses)).sum())}

    def window(self, seconds: float) -> dict:
        return self._run(max(1, round(seconds / self.step_s)))

    def traced(self) -> dict:
        return self._run(self.ctx.cell.settings["trace_steps"])

    def end_to_end(self, work: dict) -> dict:
        return {"finetune_seqs_per_s": work["seqs"] / work["elapsed_s"]}

    def shapes(self) -> dict:
        return {"G": 2 * self.B, "L": self.L}

    def flops(self, work: dict) -> float:
        return work["steps"] * flops_mod.train_flops(
            self.ctx.cell.model_cfg, self.B, self.L, "classifier")

    def release(self) -> None:
        self.step = self.opt = self.model = None
        release()

    # -- comparison --------------------------------------------------------------
    def reference(self, lowp: bool = False, half: bool = False) -> dict:
        """The reference's first steps (``lowp``: in fp8, the control;
        ``half``: each batch's first half alone, a planted fault)."""
        import torch.nn.functional as F

        from benchmark.reference.model import Model, set_fp32_math
        from benchmark.reference.train import follow

        set_fp32_math()
        mc = self.ctx.cell.model_cfg
        o = self.ctx.cell.traffic["optimizer"]
        steps = [[classify_batch(self.ctx.seed, i, self.B, self.L,
                                 self.labels, self.ctx.device)]
                 for i in range(self.first_steps)]

        keep = self.B // 2 if half else self.B

        def loss_fn(w, b):
            logits = Model(mc, w, lowp).classifier_logits(
                b["input_ids"][:keep], remat=True)
            return F.cross_entropy(logits, b["labels"][:keep])

        return follow(self.w0, steps, loss_fn, o)

    def program_result(self) -> dict:
        return {"losses": self.losses, "grad1": self.grad1,
                "params": self.params}

    def check(self) -> dict:
        from benchmark.compare import training_numbers

        return training_numbers(self.program_result(), self.reference(),
                                self.w0)
