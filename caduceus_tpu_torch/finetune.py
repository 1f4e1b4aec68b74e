"""Downstream fine-tuning: GenomicBenchmarks / Nucleotide Transformer tasks.

Port of `caduceus_tpu/finetune.py`:

- `_make_classifier` (`:24-140`): the pretrained backbone
  (`models/caduceus.py CaduceusBackbone`) under a `SequenceDecoder` head
  (`models/heads.py`), optionally fed by an input encoder
  (`models/encoders.py`). RCPS stacks the two strands' hidden states in
  their canonical orientation (`h[0]`, `h[1]`), conjoined (B, L, 2) ids run
  the backbone once per strand, plain (B, L) ids once. ``model_kind
  "hyena"``: `HyenaDNAClassifier` (`:59-96`), the `models/hyena.py
  HyenaLMBackbone` of a Hyena run (its config is the run's dict of model
  fields) under the same decoder, trained with its dropout on; ``"cnn"``:
  `CNNClassifier` (`:42-57`), the from-scratch `models/cnn.py
  GenomicsBenchmarkCNN`, BatchNorm on batch statistics in training and on
  its running ones in eval;
- `finetune_one` (`:143-328`): the per-problem-type loss, the freeze path
  (the backbone's gradients zeroed while AdamW still runs over them, so its
  decayed weights still shrink), AdamW (betas 0.9 / 0.999) on a cosine
  schedule with a warmup of a tenth of the steps down to lr · 0.01, clip 1.0,
  optional layer-wise lr decay; an eval of the val split per epoch with
  best-val selection on the task's headline metric, then the test split;
- `_export_finetuned` (`:331-368`): ``params.npz`` (flat flax paths,
  `params.py`) and ``task_config.json``, which `serve.py` reads for
  /classify;
- `main` (`:387-609`): presets, seeds, the metric resolver and the
  cross-seed export chosen on the val metric.

Differences from the JAX module: the pretrained weights are read through
`params.py load_run_dir` / `load_hyena_run_dir` (raw weights, not the EMA), which takes a
``params.npz`` export, the port's checkpoints or a JAX Orbax run, and
raises on a run dir that holds none (the JAX module starts from scratch);
the Hyena classifier's dropout masks are the port's own (`models/hyena.py
dropout`, keyed by the seed and the step); the classification metrics are
the port's numpy ones (`train/metrics.py`), so nothing here needs
scikit-learn.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from caduceus_tpu_torch import resolve_device

_IDENTITY = ("id", "stop", "identity")


class DNAClassifier(nn.Module):
    """Backbone + `SequenceDecoder` (+ an input encoder); ``forward(ids,
    lengths)`` returns fp32 scores (B, num_labels). State_dict keys are the
    flax paths of the JAX classifier: ``backbone.*``,
    ``decoder.output_transform.*``, ``encoder.*``."""

    def __init__(self, cfg, num_labels: int, pooling: str, use_lengths: bool,
                 padding_side: str, encoder: str = "id", device="cuda",
                 generator: Optional[torch.Generator] = None):
        from caduceus_tpu_torch.models.caduceus import CaduceusBackbone
        from caduceus_tpu_torch.models.encoders import make_encoder
        from caduceus_tpu_torch.models.heads import SequenceDecoder

        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator()
        if encoder not in _IDENTITY and cfg.rcps:
            raise ValueError("non-identity encoders bypass the complement "
                             "map; use rcps=False")
        self.cfg = cfg
        self.use_lengths = use_lengths
        self.backbone = CaduceusBackbone(cfg, g)
        self.decoder = SequenceDecoder(cfg.d_model, num_labels, mode=pooling,
                                       use_lengths=use_lengths,
                                       padding_side=padding_side, generator=g)
        self.encoder = (None if encoder in _IDENTITY else make_encoder(
            encoder, d_model=cfg.d_model, n_tokens=cfg.padded_vocab_size,
            generator=g))
        self.to(dev)

    def forward(self, ids: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.use_lengths:
            lengths = None
        if self.encoder is not None:
            x, _ = self.backbone(None, inputs_embeds=self.encoder(ids))
        elif self.cfg.rcps:
            if ids.dim() != 2:
                raise ValueError("an RCPS backbone takes plain (B, L) ids; "
                                 "conjoined (B, L, 2) inputs are the "
                                 "non-RCPS recipe")
            h, _ = self.backbone(ids)  # (2, B, L, d), both canonical
            x = torch.stack([h[0], h[1]], dim=-1)
        elif ids.dim() == 3:  # conjoined (B, L, 2) strands
            h_f, _ = self.backbone(ids[..., 0])
            h_r, _ = self.backbone(ids[..., 1])
            x = torch.stack([h_f, h_r], dim=-1)
        else:
            x, _ = self.backbone(ids)
        return self.decoder(x, lengths).float()


class HyenaDNAClassifier(nn.Module):
    """`HyenaLMBackbone` (``cfg``: the Hyena run's dict of model fields) +
    `SequenceDecoder`; ``forward(ids, lengths, dropout_key)`` returns fp32
    scores. Plain (B, L) ids, or conjoined (B, L, 2) strands run through
    the backbone once each. State_dict keys: ``backbone.*``,
    ``decoder.output_transform.*``."""

    def __init__(self, cfg: dict, num_labels: int, pooling: str,
                 use_lengths: bool, padding_side: str, device="cuda",
                 generator: Optional[torch.Generator] = None):
        from caduceus_tpu_torch.models.heads import SequenceDecoder
        from caduceus_tpu_torch.models.hyena import HyenaLMBackbone

        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator()
        self.use_lengths = use_lengths
        self.backbone = HyenaLMBackbone(generator=g, **cfg)
        self.decoder = SequenceDecoder(cfg["d_model"], num_labels,
                                       mode=pooling, use_lengths=use_lengths,
                                       padding_side=padding_side, generator=g)
        self.to(dev)

    def forward(self, ids: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                dropout_key=None) -> torch.Tensor:
        if not self.use_lengths:
            lengths = None
        if ids.dim() == 3:  # conjoined (B, L, 2) strands
            kf = None if dropout_key is None else (*dropout_key, 0)
            kr = None if dropout_key is None else (*dropout_key, 1)
            h_f, _ = self.backbone(ids[..., 0], kf)
            h_r, _ = self.backbone(ids[..., 1], kr)
            x = torch.stack([h_f, h_r], dim=-1)
        else:
            x, _ = self.backbone(ids, dropout_key)
        return self.decoder(x, lengths).float()


class CNNClassifier(nn.Module):
    """The from-scratch `GenomicsBenchmarkCNN` under the name ``cnn``;
    plain (B, L) ids of length ``seq_len``."""

    def __init__(self, num_labels: int, seq_len: int, device="cuda",
                 generator: Optional[torch.Generator] = None):
        from caduceus_tpu_torch.models.cnn import GenomicsBenchmarkCNN

        super().__init__()
        dev = resolve_device(device)
        self.cnn = GenomicsBenchmarkCNN(num_labels, seq_len,
                                        generator=generator)
        self.to(dev)

    def forward(self, ids: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if ids.dim() != 2:
            raise ValueError("the CNN baseline takes plain (B, L) ids")
        return self.cnn(ids)


def _make_classifier(cfg, num_labels, pooling, use_lengths, padding_side,
                     encoder="id", model_kind="caduceus", device="cuda",
                     generator=None, seq_len: Optional[int] = None
                     ) -> nn.Module:
    """The fine-tuning model for ``model_kind``: "caduceus" (``cfg`` a
    `CaduceusConfig`), "hyena" (``cfg`` the Hyena run's dict of model
    fields) or "cnn" (no ``cfg``; ``seq_len`` sets fc1's width)."""
    if model_kind == "cnn":
        return CNNClassifier(num_labels, seq_len, device=device,
                             generator=generator)
    if model_kind == "hyena":
        if encoder not in _IDENTITY:
            raise ValueError("encoders are a caduceus-path feature; hyena "
                             "embeds its own tokens")
        return HyenaDNAClassifier(cfg, num_labels, pooling, use_lengths,
                                  padding_side, device=device,
                                  generator=generator)
    if model_kind != "caduceus":
        raise ValueError(f"model_kind={model_kind!r}")
    return DNAClassifier(cfg, num_labels, pooling, use_lengths, padding_side,
                         encoder=encoder, device=device, generator=generator)


def _to_device(batch: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    return {"input_ids": torch.from_numpy(
                np.asarray(batch["input_ids"], np.int64)).to(dev),
            "labels": torch.from_numpy(np.asarray(batch["labels"])).to(dev),
            "lengths": torch.from_numpy(
                np.asarray(batch["lengths"], np.int64)).to(dev)}


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        problem_type: str) -> torch.Tensor:
    """Mean loss by problem type (`caduceus_tpu/finetune.py:221-227`)."""
    if problem_type == "regression":
        return torch.mean(torch.square(logits[..., 0] - labels.float()))
    if problem_type == "multi_label_classification":
        return F.binary_cross_entropy_with_logits(logits, labels.float())
    return F.cross_entropy(logits, labels.long())


def make_finetune_step(model: nn.Module, opt, problem_type: str,
                       freeze_backbone: bool = False,
                       dropout_seed: Optional[int] = None):
    """One optimizer step on a batch (device tensors): forward, loss,
    backward, then ``opt.step()``; returns the loss. Every parameter gets a
    gradient (zeros where the forward does not reach it, as in JAX), and
    with ``freeze_backbone`` the backbone's are zeroed, so AdamW still
    runs over them. The model runs in training mode (the CNN's BatchNorm
    on batch statistics); with ``dropout_seed`` (the Hyena classifier) it
    is called with the dropout key (dropout_seed, step)."""
    params = list(model.named_parameters())
    count = [0]

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        for _, p in params:
            p.grad = None
        model.train()
        if dropout_seed is None:
            logits = model(batch["input_ids"], batch["lengths"])
        else:
            logits = model(batch["input_ids"], batch["lengths"],
                           dropout_key=(dropout_seed, count[0]))
        count[0] += 1
        loss = classification_loss(logits, batch["labels"], problem_type)
        loss.backward()
        for name, p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif freeze_backbone and name.startswith("backbone."):
                p.grad.zero_()
        opt.step()
        return loss.detach()

    return step


def finetune_one(
    cfg,
    dm,
    num_labels: int,
    pretrained_params: Optional[Dict[str, torch.Tensor]] = None,
    epochs: int = 10,
    lr: float = 1e-3,
    weight_decay: float = 0.1,
    pooling: str = "mean",
    seed: int = 0,
    metric: str = "accuracy",
    select_metric: Optional[str] = None,
    problem_type: str = "single_label_classification",
    freeze_backbone: bool = False,
    use_lengths: bool = False,
    layer_decay: Optional[float] = None,
    encoder: str = "id",
    model_kind: str = "caduceus",
    log_fn=None,
    return_state: bool = False,
    device="cuda",
):
    """Train one downstream run; returns best-val and test metrics.

    ``pretrained_params`` is a pretraining model's state_dict (its
    ``backbone.*`` keys are grafted, `train/checkpoint.py load_backbone`);
    the classifier's own init comes from ``torch.Generator().manual_seed(
    seed)``. With ``return_state`` also returns the best-val state_dict (on
    the host), which `_export_finetuned` writes."""
    from caduceus_tpu_torch.train.checkpoint import load_backbone
    from caduceus_tpu_torch.train.metrics import f1 as f1_fn
    from caduceus_tpu_torch.train.metrics import mcc as mcc_fn
    from caduceus_tpu_torch.train.metrics import roc_auc
    from caduceus_tpu_torch.train.optim import make_optimizer

    dev = resolve_device(device)
    log = log_fn or (lambda m: print(json.dumps(m)))
    padding_side = getattr(dm.tokenizer, "padding_side", "left")
    seq_len = None
    if model_kind == "cnn":
        if pretrained_params is not None or freeze_backbone:
            raise ValueError("the CNN baseline trains from scratch (no "
                             "backbone)")
        # fc1's width follows the batches' length, as flax infers it
        seq_len = next(iter(dm.batches("train", seed=seed)))[
            "input_ids"].shape[1]
    model = _make_classifier(cfg, num_labels, pooling, use_lengths,
                             padding_side, encoder=encoder,
                             model_kind=model_kind, device=dev,
                             generator=torch.Generator().manual_seed(seed),
                             seq_len=seq_len)
    if pretrained_params is not None:
        model.load_state_dict(load_backbone(pretrained_params,
                                            model.state_dict()))

    steps_per_epoch = max(1, len(dm.train_ds) // dm.batch_size)
    total = steps_per_epoch * epochs
    opt, _ = make_optimizer(
        model.named_parameters(), lr=lr, weight_decay=weight_decay,
        betas=(0.9, 0.999), warmup_t=max(1, total // 10), t_initial=total,
        lr_min=lr * 0.01, layer_decay=layer_decay)
    train_step = make_finetune_step(
        model, opt, problem_type, freeze_backbone,
        dropout_seed=seed ^ 0x5EED if model_kind == "hyena" else None)

    def snapshot():
        return {k: v.detach().to("cpu", copy=True)
                for k, v in model.state_dict().items()}

    @torch.inference_mode()
    def eval_split(split):
        model.eval()
        scores, labels = [], []
        for batch in dm.batches(split, shuffle=False, drop_last=False):
            b = _to_device(batch, dev)
            scores.append(model(b["input_ids"], b["lengths"]).cpu().numpy())
            labels.append(batch["labels"])
        scores = np.concatenate(scores)
        labels = np.concatenate(labels)
        if problem_type == "regression":
            pred = scores[..., 0] if scores.ndim > 1 else scores
            err = pred - labels
            return {"mse": float(np.mean(err**2)),
                    "mae": float(np.mean(np.abs(err)))}
        if problem_type == "multi_label_classification":
            preds = (scores > 0).astype(labels.dtype)
            return {
                "accuracy": float((preds == labels).mean()),
                "subset_accuracy": float((preds == labels).all(-1).mean()),
            }
        preds = np.argmax(scores, axis=-1)
        out = {"accuracy": float((preds == labels).mean())}
        if metric in ("mcc", "all"):
            out["mcc"] = mcc_fn(preds, labels)
        if metric in ("f1", "all"):
            out["f1"] = f1_fn(preds, labels,
                              average="binary" if num_labels == 2 else "macro")
        if num_labels == 2 and metric in ("roc_auc", "all"):
            e = np.exp(scores - scores.max(-1, keepdims=True))
            out["roc_auc"] = roc_auc((e / e.sum(-1, keepdims=True))[:, 1],
                                     labels)
        return out

    def better(a, b):
        return a < b if problem_type == "regression" else a > b

    # best-val selection on the task's headline metric, never on "all"
    if problem_type == "regression":
        sel_metric = "mse"
    elif problem_type == "multi_label_classification":
        sel_metric = select_metric or "accuracy"
    else:
        sel_metric = select_metric or (
            metric if metric != "all" else "accuracy")
    best_val = np.inf if problem_type == "regression" else -np.inf
    best = snapshot()
    for epoch in range(epochs):
        for batch in dm.batches("train", epoch=epoch, seed=seed):
            loss = train_step(_to_device(batch, dev))
        val = eval_split("val")
        score = val[sel_metric]  # a KeyError beats a silent wrong selection
        log({"epoch": epoch, "loss": float(loss),
             **{f"val/{k}": v for k, v in val.items()}})
        if better(score, best_val):
            best_val, best = score, snapshot()

    model.load_state_dict(best)
    test = eval_split("test")
    log({f"test/{k}": v for k, v in test.items()})
    result = {"best_val": float(best_val),
              **{f"test_{k}": v for k, v in test.items()}}
    if return_state:
        return result, best
    return result


def _export_finetuned(args, cfg, model_kind, select, best_export) -> None:
    """Write a servable model dir: ``params.npz`` (the best seed's best-val
    weights as flat flax paths) + ``task_config.json`` (what `serve.py`
    needs to rebuild the classifier and encode requests as eval does)."""
    from caduceus_tpu_torch.params import to_jax_params

    score, seed, state, num_classes, dm = best_export
    if model_kind == "caduceus":
        model_cfg = cfg.to_dict()
    elif model_kind == "hyena":
        model_cfg = {**cfg, "attn_layer_idx": list(cfg["attn_layer_idx"])}
    else:   # the CNN trains from scratch: no backbone config
        model_cfg = None
    os.makedirs(args.save_dir, exist_ok=True)
    np.savez(os.path.join(args.save_dir, "params.npz"), **to_jax_params(state))
    task_cfg = {
        "task": args.task,
        "num_classes": int(num_classes),
        "pooling": args.pooling,
        "problem_type": args.problem_type,
        "use_lengths": bool(args.use_lengths),
        "padding_side": getattr(dm.tokenizer, "padding_side", "left"),
        "add_eos": bool(getattr(dm.train_ds, "add_eos", False)),
        "conjoin": bool(args.conjoin_train or args.conjoin_test),
        "encoder": args.encoder,
        "model_kind": model_kind,
        "max_length": int(args.max_length),
        "seed": int(seed),
        "select_metric": select,
        "val_score": float(score),
        "model_cfg": model_cfg,
    }
    with open(os.path.join(args.save_dir, "task_config.json"), "w") as f:
        json.dump(task_cfg, f, indent=1)
    print(json.dumps({"saved": args.save_dir, "seed": seed,
                      "score": float(score)}))


def _load_preset(argv):
    """``--preset <yaml>``: its flat keys become argparse defaults (the
    downstream presets in configs/downstream/)."""
    argv = list(argv)
    if "--preset" not in argv:
        return {}, argv
    i = argv.index("--preset")
    path = argv[i + 1]
    argv = argv[:i] + argv[i + 2:]
    import yaml

    with open(path) as f:
        flat = yaml.safe_load(f) or {}
    return {k.replace("-", "_"): v for k, v in flat.items()}, argv


def main(argv=None):
    import sys

    preset, argv = _load_preset(
        argv if argv is not None else sys.argv[1:])
    p = argparse.ArgumentParser(prog="finetune")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--task", required="task" not in preset)
    p.add_argument("--max-length", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--pretrained-run-dir", default=None,
                   help="pretraining run dir: model_config.json and a "
                        "params.npz export, the port's checkpoints/ or a JAX "
                        "run's Orbax checkpoints/")
    p.add_argument("--config-path", default=None)
    p.add_argument("--pooling", default="mean")
    p.add_argument("--conjoin-train", action="store_true")
    p.add_argument("--conjoin-test", action="store_true")
    p.add_argument("--rc-aug", action="store_true")
    p.add_argument("--metric", default="all")
    p.add_argument("--model", default="caduceus",
                   choices=["caduceus", "hyena", "cnn"],
                   help="cnn = the from-scratch GenomicsBenchmarkCNN "
                        "baseline; hyena = the HyenaDNA backbone, selected "
                        "by itself when --pretrained-run-dir is a Hyena run")
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-layer", type=int, default=4)
    p.add_argument("--no-rcps", action="store_true")
    p.add_argument("--freeze-backbone", action="store_true")
    p.add_argument("--use-lengths", action="store_true",
                   help="length-masked pooling")
    p.add_argument("--layer-decay", type=float, default=None,
                   help="layer-wise lr decay factor")
    p.add_argument("--encoder", default="id",
                   choices=["id", "embedding", "onehot"],
                   help="input encoder in place of the backbone embedding")
    p.add_argument("--problem-type", default="single_label_classification",
                   choices=["single_label_classification", "regression",
                            "multi_label_classification"])
    p.add_argument("--save-dir", default=None,
                   help="export the best seed's best-val model (params.npz + "
                        "task_config.json), servable via `cli.py serve` "
                        "/classify")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.set_defaults(**preset)
    args = p.parse_args(argv)

    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig
    from caduceus_tpu_torch.data.classification import (
        NT_TASK_METRICS,
        NUCLEOTIDE_TRANSFORMER_TASKS,
        ClassificationDataModule,
    )
    from caduceus_tpu_torch.models.hyena import hyena_kwargs
    from caduceus_tpu_torch.params import load_hyena_run_dir, load_run_dir
    from caduceus_tpu_torch.tokenization import CharacterTokenizer

    tok = CharacterTokenizer()
    cfg_path = args.config_path or (
        os.path.join(args.pretrained_run_dir, "model_config.json")
        if args.pretrained_run_dir else None)
    raw_cfg = None
    if cfg_path and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw_cfg = json.load(f)
    model_kind = args.model
    if model_kind == "cnn" and args.pretrained_run_dir:
        p.error("--model cnn trains from scratch; it takes no "
                "--pretrained-run-dir")
    if raw_cfg is not None and raw_cfg.get("model_type") == "hyena":
        # the run dir decides the backbone family
        model_kind = "hyena"
        cfg = hyena_kwargs(raw_cfg)
    elif model_kind == "hyena":
        if args.pretrained_run_dir:
            p.error("--model hyena with a pretrained run dir that is not a "
                    "Hyena run (its model_config.json has no \"model_type\": "
                    "\"hyena\")")
        # a from-scratch HyenaDNA backbone
        cfg = hyena_kwargs(dict(d_model=args.d_model, n_layer=args.n_layer,
                                vocab_size=tok.vocab_size,
                                l_max=args.max_length))
    elif model_kind == "cnn":
        cfg = None
    elif raw_cfg is not None:
        cfg = CaduceusConfig.load(cfg_path)
        cfg.complement_map = tok.complement_map
    else:
        cfg = CaduceusConfig(
            d_model=args.d_model, n_layer=args.n_layer,
            vocab_size=tok.vocab_size, ssm_cfg=SSMConfig(),
            rcps=not args.no_rcps, complement_map=tok.complement_map)
    if model_kind != "caduceus" and args.encoder not in _IDENTITY:
        p.error(f"--encoder is a caduceus-path feature (--model "
                f"{model_kind} embeds its own tokens)")
    if args.conjoin_train or args.conjoin_test:
        if model_kind == "cnn":
            p.error("--conjoin-train/--conjoin-test are not supported by "
                    "--model cnn (it takes plain (B, L) ids)")
        if model_kind == "caduceus" and cfg.rcps:
            p.error("--conjoin-train/--conjoin-test require a non-rcps "
                    "model (pass --no-rcps, or point at a non-rcps "
                    "pretrained config); an RCPS backbone is already "
                    "RC-equivariant and takes plain (B, L) inputs")

    dev = resolve_device(args.device)
    pretrained_params = None
    if args.pretrained_run_dir:
        # the raw weights, as the JAX module grafts TrainState.params; a run
        # dir without parameters raises (FileNotFoundError)
        load = load_hyena_run_dir if model_kind == "hyena" else load_run_dir
        _, pretrained_params = load(args.pretrained_run_dir, prefer_ema=False)

    # the task's headline metric for best-val selection
    if args.problem_type != "single_label_classification":
        select = None
    elif args.metric != "all":
        select = args.metric
    elif args.task in NUCLEOTIDE_TRANSFORMER_TASKS:
        select = NT_TASK_METRICS.get(args.task, "mcc")
    else:
        select = "accuracy"

    key = ("test_mse" if args.problem_type == "regression"
           else f"test_{select or 'accuracy'}")
    lower_better = args.problem_type == "regression"
    results = []
    best_export = None  # (score, seed, state, num_classes, dm)
    for seed in args.seeds:
        dm = ClassificationDataModule(
            args.data_dir, args.task, max_length=args.max_length,
            batch_size=args.batch_size, rc_aug=args.rc_aug,
            conjoin_train=args.conjoin_train, conjoin_test=args.conjoin_test,
            train_val_split_seed=seed, seed=seed,
            regression=(args.problem_type == "regression"),
            multi_label=(args.problem_type == "multi_label_classification"),
        )
        r = finetune_one(
            cfg, dm, dm.num_classes, pretrained_params=pretrained_params,
            epochs=args.epochs, lr=args.lr, pooling=args.pooling,
            seed=seed, metric=args.metric, select_metric=select,
            problem_type=args.problem_type,
            freeze_backbone=args.freeze_backbone,
            use_lengths=args.use_lengths, layer_decay=args.layer_decay,
            encoder=args.encoder, model_kind=model_kind,
            return_state=bool(args.save_dir), device=dev,
        )
        if args.save_dir:
            r, state = r
            # across seeds by the VAL metric: test scores never pick the
            # model that ships
            sel = r["best_val"]
            if best_export is None or (
                    sel < best_export[0] if lower_better
                    else sel > best_export[0]):
                best_export = (sel, seed, state, dm.num_classes, dm)
        r["seed"] = seed
        results.append(r)
        print(json.dumps(r))

    if args.save_dir and best_export is not None:
        _export_finetuned(args, cfg, model_kind, select, best_export)
    summary = {
        "task": args.task,
        "seeds": args.seeds,
        f"mean_{key}": float(np.mean([r[key] for r in results])),
        f"std_{key}": float(np.std([r[key] for r in results])),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
