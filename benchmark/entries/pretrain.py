"""MLM pretraining through the port's loop, `Trainer.fit`.

Set-up builds the kernels, the model (`CaduceusForMaskedLM`) with the
benchmark's weights, and one `Trainer` whose ``train_loader`` is the
benchmark's seeded MLM batches (through the port's prefetch thread), then
drives it through its first steps with the same call the window makes,
``fit``: step 1 alone (its AdamW first moment is read back), then steps 2
and 3 (the weights after them are kept). Evaluation and checkpoints are
off. The window runs whole optimizer steps for about ``--seconds``; the
reference replays the first steps afterwards.
"""

from __future__ import annotations

import time

import torch

from benchmark import flops as flops_mod
from benchmark.generate import mlm_batch
from benchmark.harness import Context, first_moment, release
from benchmark.weights import make_weights

NEVER = 10 ** 12


class Loader:
    """Seeded MLM batches of ``rows`` x ``length``; batch i depends on (seed,
    i) alone. Its state is the next batch's index."""

    def __init__(self, seed: int, rows: int, length: int, mask_prob: float):
        self.seed, self.rows, self.length = seed, rows, length
        self.mask_prob = mask_prob
        self.pos = 0

    def __iter__(self):
        i = self.pos
        while True:
            b = mlm_batch(self.seed, i, self.rows, self.length,
                          self.mask_prob)
            i += 1
            self.pos = i
            yield b

    def state_dict(self):
        return {"pos": self.pos}

    def load_state_dict(self, state):
        self.pos = state["pos"]


def build_kernels(version: int) -> None:
    if version == 2:
        from caduceus_tpu_torch.ops import ssd_batched
        ssd_batched.build()
    else:
        from caduceus_tpu_torch.ops import scan
        scan.build()


class Entry:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        t = ctx.cell.traffic
        self.rows = t["micro_batch"] * t["accum_steps"]
        self.L = t["seq_len"]
        self.first_steps = ctx.cell.settings["reference_steps"]
        self.losses = []

    # -- set-up ----------------------------------------------------------------
    def setup(self) -> dict:
        from caduceus_tpu_torch.config import CaduceusConfig
        from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
        from caduceus_tpu_torch.train.trainer import Trainer, TrainerConfig

        ctx, t = self.ctx, self.ctx.cell.traffic
        mc = ctx.cell.model_cfg
        parts = {}
        t0 = time.perf_counter()
        if ctx.device.type == "cuda":
            build_kernels(mc["ssm_cfg"]["version"])
        parts["kernels_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.cfg = CaduceusConfig(**mc)
        self.model = CaduceusForMaskedLM(self.cfg, device=ctx.device)
        names = [(n, p.shape) for n, p in self.model.named_parameters()]
        self.w0 = make_weights(names, mc, ctx.seed, ctx.device)
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(self.w0[n])
        ctx.sync()
        parts["model_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        o = t["optimizer"]
        self.loader = Loader(ctx.seed, self.rows, self.L, t["mask_prob"])
        self.trainer = Trainer(
            self.model,
            TrainerConfig(max_steps=o["schedule_steps"], log_every=1,
                          eval_every=NEVER, checkpoint_every=NEVER,
                          accum_steps=t["accum_steps"], prefetch=2,
                          run_dir=f"{ctx.tmp}/run", lr=o["lr"],
                          weight_decay=o["weight_decay"],
                          betas=tuple(o["betas"]),
                          warmup_frac=o["warmup_frac"], lr_min=o["lr_min"],
                          warmup_lr_init=o["warmup_lr_init"],
                          gradient_clip=o["clip"]),
            self.loader, log_fn=self._log)
        self.trainer.init_state()
        parts["inputs_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.trainer.fit(1)
        opt = self.trainer.state.optimizer.opt
        b1 = o["betas"][0]
        self.grad1 = {n: first_moment(opt, p) / (1 - b1)
                      for n, p in self.model.named_parameters()}
        t1 = time.perf_counter()
        self.trainer.fit(self.first_steps)
        ctx.sync()
        t2 = time.perf_counter()
        self.params = {n: p.detach().clone()
                       for n, p in self.model.named_parameters()}
        self.step_s = (t2 - t1) / max(self.first_steps - 1, 1)
        parts["warmup_s"] = t2 - t0
        self.trainer.cfg.log_every = NEVER
        return parts

    def _log(self, rec: dict) -> None:
        if self.trainer.cfg.log_every == 1:
            self.losses.append(rec["loss"])
        else:
            self.final = rec

    # -- window ----------------------------------------------------------------
    def _run(self, steps: int) -> dict:
        self.final = None
        start = self.trainer.state.step
        t0 = time.perf_counter()
        self.trainer.fit(start + steps)
        self.ctx.sync()
        elapsed = time.perf_counter() - t0
        done = self.trainer.state.step - start
        loss = None if self.final is None else self.final.get("loss")
        failed = 0 if loss is not None and loss == loss and abs(
            loss) != float("inf") else done
        return {"steps": done, "tokens": done * self.rows * self.L,
                "elapsed_s": elapsed, "attempted": steps, "failed": failed,
                "step_s_setup": self.step_s}

    def window(self, seconds: float) -> dict:
        return self._run(max(1, round(seconds / self.step_s)))

    def traced(self) -> dict:
        return self._run(self.ctx.cell.settings["trace_steps"])

    def finish(self, work: dict) -> dict:
        return work

    def end_to_end(self, work: dict) -> dict:
        return {"pretrain_tokens_per_s": work["tokens"] / work["elapsed_s"]}

    def shapes(self) -> dict:
        t = self.ctx.cell.traffic
        return {"G": 2 * t["micro_batch"], "L": self.L}

    def flops(self, work: dict) -> float:
        return work["steps"] * flops_mod.train_flops(
            self.ctx.cell.model_cfg, self.rows, self.L, "mlm")

    # -- comparison --------------------------------------------------------------
    def release(self) -> None:
        self.params = {k: v.detach().clone() for k, v in self.params.items()}
        self.trainer = self.model = None
        release()

    def program_result(self) -> dict:
        return {"losses": self.losses[:self.first_steps],
                "grad1": self.grad1, "params": self.params}

    def reference_steps(self, half: bool = False):
        """The first steps' rows as the reference takes them: per step, its
        micro-batches as (ids, targets) on the device; ``half`` keeps the
        first half of each micro-batch's rows (a planted fault)."""
        t = self.ctx.cell.traffic
        mb = t["micro_batch"]
        steps = []
        for i in range(self.first_steps):
            b = mlm_batch(self.ctx.seed, i, self.rows, self.L, t["mask_prob"])
            ids = torch.from_numpy(b["input_ids"]).long().to(self.ctx.device)
            tgt = torch.from_numpy(b["targets"]).long().to(self.ctx.device)
            keep = mb // 2 if half else mb
            steps.append([(ids[j:j + keep], tgt[j:j + keep])
                          for j in range(0, self.rows, mb)])
        return steps

    def reference(self, lowp: bool = False, half: bool = False) -> dict:
        from benchmark.reference.model import Model, mlm_loss, set_fp32_math
        from benchmark.reference.train import follow

        set_fp32_math()
        mc = self.ctx.cell.model_cfg
        o = dict(self.ctx.cell.traffic["optimizer"])
        o["warmup_steps"] = int(o["warmup_frac"] * o["schedule_steps"])
        o["cosine_steps"] = o["schedule_steps"] - o["warmup_steps"]

        def loss_fn(w, mb):
            ids, tgt = mb
            return mlm_loss(Model(mc, w, lowp).mlm_logits(ids, remat=True),
                            tgt)

        return follow(self.w0, self.reference_steps(half), loss_fn, o)

    def check(self) -> dict:
        from benchmark.compare import training_numbers

        return training_numbers(self.program_result(), self.reference(),
                                self.w0)
