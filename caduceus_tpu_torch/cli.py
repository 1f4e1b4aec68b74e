"""Command line of the port: ``python -m caduceus_tpu_torch.cli
{pretrain,eval,finetune,vep,serve,generate}``.

Port of those subcommands of `caduceus_tpu/cli.py`, with its flags and its
``model_config.json``. ``pretrain`` trains ``--model caduceus`` (MLM, or
NTP with ``--ntp``) and ``--model mamba --ntp`` on an hg38-style FASTA +
BED through `train/trainer.py Trainer`, writing ``model_config.json``,
``metrics.jsonl`` and ``checkpoints/`` into the run dir. ``eval``,
``serve`` and ``generate`` read a run dir's parameters from a
``params.npz`` export, the port's latest checkpoint or a JAX run's Orbax
checkpoint, in that order (`params.py load_run_dir`). ``finetune``
(`finetune.py`) trains a classifier on a downstream task from a pretraining
run dir and exports it (``--save-dir``), which ``serve`` answers /classify
from; ``vep`` (`vep.py`) dumps variant embeddings of a run dir's model and
scores them with ``--svm``. Every subcommand runs on the card unless
``--device cpu`` is given.

``pretrain`` and ``eval`` run data, tensor and context parallelism when
launched as several ranks by `torch.distributed.run` (``python -m
torch.distributed.run --standalone --nproc_per_node N -m
caduceus_tpu_torch.cli pretrain ...``): the ranks form a (data, model) mesh
(`parallel/mesh.py`), ``--mesh-model M`` ranks along the model axis;
``--tensor-parallel`` cuts the model's parameters over it
(`parallel/sharding.py`; ``pretrain`` of every family, ``eval`` of the
Caduceus and Mamba ones) and ``--context-parallel`` shards the sequence
over it, one or the other per run, as the JAX CLI takes them. ``--dist-backend``
picks the `torch.distributed` backend (nccl by default; gloo runs several
ranks on one card, or on the CPU with ``--device cpu``).

``pretrain --model hyena --ntp`` trains the HyenaDNA LM
(`models/hyena.py`) with embedding dropout and the filter lr groups
(`train/optim.py hyena_lr_overrides`), its MHA layers at
``--attn-layer-idx`` (comma-separated, as the JAX CLI takes them) with
``--num-heads`` heads, and ``--hyena-checkpoint`` recomputing each block's
mixer and MLP in the backward; it writes the JAX CLI's Hyena
``model_config.json`` (``model_type``, ``objective``, ``lr`` and the model
fields), which ``eval`` and ``finetune`` read. The Hyena family takes no
``--context-parallel`` (the FFT long conv has no sequence-sharded path),
as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_RUN_DIR_HELP = ("run dir with model_config.json and parameters: a "
                 "params.npz export, the port's checkpoints/ or a JAX run's "
                 "Orbax checkpoints/")


def _add_common_model_args(p: argparse.ArgumentParser):
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layer", type=int, default=16)
    p.add_argument("--no-rcps", action="store_true")
    p.add_argument("--bidirectional-strategy", default="add")
    p.add_argument("--no-weight-tie", action="store_true")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--config-path", default=None,
                   help="load model config from a model_config.json")


def _add_parallel_args(p: argparse.ArgumentParser):
    # the JAX CLI's multi-device flags (`caduceus_tpu/cli.py:192-216`): the
    # ranks of `torch.distributed.run` form a (data, model) mesh; DP over
    # 'data' is always on; --mesh-model N carves a 'model' axis for
    # --tensor-parallel (the parameters cut over it) or --context-parallel
    # (the sequence sharded over it)
    p.add_argument("--mesh-model", type=int, default=1,
                   help="size of the mesh 'model' axis (ranks = data x model)")
    p.add_argument("--tensor-parallel", action="store_true",
                   help="shard params + scans over the 'model' axis")
    p.add_argument("--context-parallel", action="store_true",
                   help="shard the sequence axis over the 'model' axis")
    p.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                   help="torch.distributed backend of a multi-rank run (gloo: "
                        "several ranks on one card, or the CPU)")


def _check_parallel(p, args):
    """The JAX CLI's checks of the mesh flags (`caduceus_tpu/cli.py:207-216`)."""
    if args.tensor_parallel and args.context_parallel:
        p.error("--tensor-parallel and --context-parallel share the single "
                "'model' mesh axis; pick one per run")
    if (args.tensor_parallel or args.context_parallel) and args.mesh_model < 2:
        p.error("--tensor-parallel/--context-parallel need --mesh-model >= 2")
    if args.context_parallel and args.max_length % args.mesh_model != 0:
        p.error(f"--max-length {args.max_length} not divisible by "
                f"--mesh-model {args.mesh_model} (context parallelism "
                f"shards the sequence axis)")


def _maybe_mesh(p, args):
    """The (data, model) mesh of a multi-rank run (``WORLD_SIZE`` > 1 from
    the launcher, or ``--mesh-model`` > 1), else None (one device). Prints
    the backend and the mesh from rank 0."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and args.mesh_model == 1:
        return None
    if world % args.mesh_model:
        p.error(f"{world} ranks do not split into --mesh-model "
                f"{args.mesh_model} (launch them with torch.distributed.run)")
    from caduceus_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(model=args.mesh_model, backend=args.dist_backend,
                     device="cpu" if args.device == "cpu" else None)
    if mesh.is_main:
        print(json.dumps({"dist_backend": args.dist_backend,
                          "world_size": mesh.world,
                          "mesh": {"data": mesh.shape["data"],
                                   "model": mesh.shape["model"]},
                          "tensor_parallel": args.tensor_parallel,
                          "context_parallel": args.context_parallel,
                          "device": str(mesh.device)}), flush=True)
    return mesh


def _end_mesh(mesh):
    if mesh is not None:
        mesh.close()


def _build_model_config(args, tokenizer):
    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig

    if args.config_path:
        cfg = CaduceusConfig.load(args.config_path)
        cfg.complement_map = tokenizer.complement_map
        return cfg
    ssm_cfg = getattr(args, "ssm_cfg", None)
    return CaduceusConfig(
        d_model=args.d_model,
        n_layer=args.n_layer,
        vocab_size=tokenizer.vocab_size,
        ssm_cfg=SSMConfig(**ssm_cfg) if ssm_cfg else SSMConfig(),
        rcps=not args.no_rcps,
        bidirectional_strategy=args.bidirectional_strategy,
        bidirectional_weight_tie=not args.no_weight_tie,
        complement_map=tokenizer.complement_map,
        dtype=args.dtype,
        remat=args.remat,
    )


def _load_preset(argv):
    """Extract ``--preset <yaml>`` and return (defaults, remaining argv);
    explicit flags override the preset's values. `yaml` is imported only
    here: a JSON ``--config-path`` needs no PyYAML."""
    if "--preset" not in argv:
        return {}, argv
    i = argv.index("--preset")
    path = argv[i + 1]
    argv = argv[:i] + argv[i + 2 :]
    import yaml

    with open(path) as f:
        tree = yaml.safe_load(f) or {}
    flat = {}
    mapping = {
        ("model", "name"): "model",
        ("model", "d_model"): "d_model",
        ("model", "n_layer"): "n_layer",
        ("model", "dtype"): "dtype",
        ("model", "bidirectional_strategy"): "bidirectional_strategy",
        ("data", "max_length"): "max_length",
        ("data", "batch_size"): "batch_size",
        ("data", "mlm_probability"): "mlm_probability",
        ("train", "max_steps"): "max_steps",
        ("train", "lr"): "lr",
        ("train", "weight_decay"): "weight_decay",
        ("train", "seed"): "seed",
        ("train", "betas"): "betas",
        ("train", "warmup_frac"): "warmup_frac",
        ("train", "lr_min"): "lr_min",
        ("train", "gradient_clip"): "gradient_clip",
        ("train", "accum_steps"): "accum_steps",
        ("train", "ema_decay"): "ema_decay",
        ("train", "log_every"): "log_every",
        ("train", "eval_every"): "eval_every",
        ("train", "eval_batches"): "eval_batches",
        ("train", "checkpoint_every"): "checkpoint_every",
    }
    for (sec, key), dest in mapping.items():
        if sec in tree and key in (tree[sec] or {}):
            flat[dest] = tree[sec][key]
    model = tree.get("model") or {}
    data = tree.get("data") or {}
    if isinstance(model.get("attn_layer_idx"), (list, tuple)):
        flat["attn_layer_idx"] = tuple(int(i) for i in model["attn_layer_idx"])
    if "num_heads" in model:
        flat["num_heads"] = model["num_heads"]
    if model.get("checkpoint"):
        flat["hyena_checkpoint"] = True
    if model.get("rcps") is False:
        flat["no_rcps"] = True
    if model.get("remat"):
        flat["remat"] = True
    if data.get("rc_aug"):
        flat["rc_aug"] = True
    if data.get("mlm") is False:
        flat["ntp"] = True
    # nested SSM settings pass through whole (e.g. version: 2 selects the
    # Mamba-2 / SSD mixer, configs/hg38_mlm_v2.yaml)
    if isinstance(model.get("ssm_cfg"), dict):
        flat["ssm_cfg"] = model["ssm_cfg"]
    par = tree.get("parallel") or {}
    if "mesh_model" in par:
        flat["mesh_model"] = par["mesh_model"]
    if par.get("tensor_parallel"):
        flat["tensor_parallel"] = True
    if par.get("context_parallel"):
        flat["context_parallel"] = True
    return flat, argv


def cmd_pretrain(argv):
    """MLM / NTP pretraining on an hg38-style FASTA + BED; prints
    ``{"final": metrics}`` last."""
    preset, argv = _load_preset(argv)
    p = argparse.ArgumentParser(prog="pretrain")
    p.add_argument("--fasta", required=True)
    p.add_argument("--bed", required=True)
    p.add_argument("--max-length", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=8e-3)
    p.add_argument("--weight-decay", type=float, default=0.1)
    p.add_argument("--betas", type=float, nargs=2, default=[0.9, 0.95])
    p.add_argument("--warmup-frac", type=float, default=0.1)
    p.add_argument("--lr-min", type=float, default=1e-4)
    p.add_argument("--gradient-clip", type=float, default=1.0)
    p.add_argument("--mlm-probability", type=float, default=0.15)
    p.add_argument("--ntp", action="store_true",
                   help="next-token objective instead of MLM")
    p.add_argument("--rc-aug", action="store_true")
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--run-dir", default="./outputs/pretrain")
    p.add_argument("--seed", type=int, default=2222)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--use-native-loader", action="store_true",
                   help="build batches in the C++ loader, compiled from "
                        "native/dataloader.cc at first use (g++)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches a host thread builds ahead (0: none)")
    p.add_argument("--ema-decay", type=float, default=0.0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--eval-every", type=int, default=1000)
    p.add_argument("--eval-batches", type=int, default=16)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of steps 11-13 here "
                        "(tensorboard-viewable)")
    p.add_argument("--model", default="caduceus",
                   choices=["caduceus", "mamba", "hyena"],
                   help="caduceus (BiMamba / RCPS, MLM or NTP); mamba = "
                        "unidirectional NTP (`dna_embedding.py:99-153`); "
                        "hyena = HyenaDNA-style NTP LM with dropout and "
                        "filter lr groups (`models/hyena.py`)")
    p.add_argument("--attn-layer-idx",
                   type=lambda s: tuple(int(x) for x in s.split(",") if x),
                   default=(),
                   help="comma-separated layer indices that use MHA instead "
                        "of the Hyena mixer (--model hyena only)")
    p.add_argument("--num-heads", type=int, default=8,
                   help="MHA heads on hybrid attention layers")
    p.add_argument("--hyena-checkpoint", action="store_true",
                   help="recompute the mixer and MLP branches of each block "
                        "in the backward (--model hyena only)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    _add_parallel_args(p)
    _add_common_model_args(p)
    p.set_defaults(**preset)
    args = p.parse_args(argv)
    if args.model in ("mamba", "hyena") and not args.ntp:
        p.error(f"--model {args.model} is causal: pretrain with --ntp")
    if (args.attn_layer_idx or args.hyena_checkpoint) and args.model != "hyena":
        p.error("--attn-layer-idx/--hyena-checkpoint require --model hyena")
    if any(i < 0 or i >= args.n_layer for i in args.attn_layer_idx):
        p.error(f"--attn-layer-idx entries must be in [0, {args.n_layer})")
    _check_parallel(p, args)
    if args.model == "hyena" and args.context_parallel:
        p.error("--context-parallel is not supported by --model hyena "
                "(the FFT long conv has no sequence-sharded path)")

    import torch

    from caduceus_tpu_torch import resolve_device
    from caduceus_tpu_torch.data.hg38 import HG38DataModule
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.train.trainer import Trainer, TrainerConfig
    from caduceus_tpu_torch.utils.logging import make_logger, param_count

    mesh = _maybe_mesh(p, args)
    main = mesh is None or mesh.is_main
    dev = resolve_device(args.device) if mesh is None else mesh.device
    # every rank builds the same global batches from the same seed and
    # keeps its part (`Trainer`)
    dm = HG38DataModule(
        args.bed,
        args.fasta,
        max_length=args.max_length,
        batch_size=args.batch_size,
        mlm=not args.ntp,
        mlm_probability=args.mlm_probability,
        rc_aug=args.rc_aug,
        seed=args.seed,
        use_native=args.use_native_loader,
    )
    os.makedirs(args.run_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(args.seed)
    lr_overrides = None
    if args.model == "hyena":
        from caduceus_tpu_torch.models.hyena import HyenaLMHeadModel
        from caduceus_tpu_torch.train.optim import hyena_lr_overrides

        hy = dict(d_model=args.d_model, n_layer=args.n_layer,
                  vocab_size=dm.tokenizer.vocab_size, l_max=args.max_length,
                  attn_layer_idx=tuple(args.attn_layer_idx),
                  num_heads=args.num_heads,
                  checkpoint_mixer=args.hyena_checkpoint,
                  checkpoint_mlp=args.hyena_checkpoint, dtype=args.dtype)
        # "lr": eval and fine-tuning rebuild the filter lr groups against
        # the run's base lr
        meta = {"model_type": "hyena", "objective": "ntp", "lr": args.lr,
                **hy}
        model = HyenaLMHeadModel(device=dev, generator=gen, **hy)
        # `configs/model/hyena.yaml:22-24`: the filter MLP at the base lr
        # and wd 0, z and the decay rates frozen; embedding dropout on
        lr_overrides = hyena_lr_overrides(args.lr)
    else:
        cfg = _build_model_config(args, dm.tokenizer)
        if args.model == "mamba":
            # unidirectional causal Mamba LM (`dna_embedding.py:99-153`)
            cfg.rcps = False
            cfg.bidirectional = False
        # the objective, so that `eval` rebuilds the right task; the
        # parallel axes are launch choices, not part of the model
        meta = cfg.to_dict()
        meta["objective"] = "ntp" if args.ntp else "mlm"
        meta["tensor_parallel_axis"] = None
        meta["context_parallel_axis"] = None
        if args.tensor_parallel:
            cfg.tensor_parallel_axis = "model"
        if args.context_parallel:
            cfg.context_parallel_axis = "model"
        model = CaduceusForMaskedLM(cfg, device=dev, generator=gen)
    if main:
        with open(os.path.join(args.run_dir, "model_config.json"), "w") as f:
            json.dump(meta, f, indent=2)
    tcfg = TrainerConfig(
        max_steps=args.max_steps,
        run_dir=args.run_dir,
        seed=args.seed,
        lr=args.lr,
        weight_decay=args.weight_decay,
        betas=tuple(args.betas),
        warmup_frac=args.warmup_frac,
        lr_min=args.lr_min,
        gradient_clip=args.gradient_clip,
        accum_steps=args.accum_steps,
        ema_decay=args.ema_decay,
        dropout=args.model == "hyena",
        prefetch=args.prefetch,
        profile_dir=args.profile_dir,
        log_every=args.log_every,
        eval_every=args.eval_every,
        eval_batches=args.eval_batches,
        checkpoint_every=args.checkpoint_every,
    )
    log_fn = make_logger(run_dir=args.run_dir,
                         rank=0 if mesh is None else mesh.rank)
    train_loader = dm.train_loader()
    try:
        trainer = Trainer(model, tcfg, train_loader, dm.eval_loader("valid"),
                          mesh=mesh, ignore_index=dm.tokenizer.pad_token_id,
                          log_fn=log_fn, lr_overrides=lr_overrides,
                          tensor_parallel=args.tensor_parallel,
                          context_parallel=args.context_parallel)
        trainer.init_state()
        log_fn(param_count(model))
        if args.resume:
            trainer.restore_checkpoint()
        metrics = trainer.fit()
        trainer.save_checkpoint()
    finally:
        train_loader.close()
    if main:
        print(json.dumps({"final": metrics}))
    _end_mesh(mesh)


def cmd_eval(argv):
    """Score a run's weights (the EMA when the run kept them, as
    `params.py load_run_dir` picks) on a split; prints the metrics as one
    JSON line last."""
    p = argparse.ArgumentParser(prog="eval")
    p.add_argument("--fasta", required=True)
    p.add_argument("--bed", required=True)
    p.add_argument("--run-dir", required=True, help=_RUN_DIR_HELP)
    p.add_argument("--split", default="test")
    p.add_argument("--max-length", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-batches", type=int, default=100)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    _add_parallel_args(p)
    args = p.parse_args(argv)
    _check_parallel(p, args)
    from caduceus_tpu_torch.params import (
        load_hyena_run_dir,
        load_run_dir,
        run_config,
    )

    raw = run_config(args.run_dir)
    hyena = raw.get("model_type") == "hyena"
    if hyena and (args.tensor_parallel or args.context_parallel):
        p.error("--tensor-parallel/--context-parallel eval is only "
                "supported for the caduceus/mamba families")

    from caduceus_tpu_torch import resolve_device
    from caduceus_tpu_torch.data.hg38 import HG38DataModule
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.train.trainer import Trainer, TrainerConfig

    mesh = _maybe_mesh(p, args)
    dev = resolve_device(args.device) if mesh is None else mesh.device
    if hyena:
        from caduceus_tpu_torch.models.hyena import HyenaLMHeadModel

        kw, params = load_hyena_run_dir(args.run_dir)
        model = HyenaLMHeadModel(device=dev, **kw)
    else:
        cfg, params = load_run_dir(args.run_dir)
        if args.tensor_parallel:
            cfg.tensor_parallel_axis = "model"
        if args.context_parallel:
            cfg.context_parallel_axis = "model"
        model = CaduceusForMaskedLM(
            cfg, device=dev, tie_word_embeddings="lm_head" not in params)
    model.load_state_dict(params)
    # the objective recorded at pretrain time (older runs: MLM)
    mlm = raw.get("objective", "mlm") == "mlm"
    dm = HG38DataModule(args.bed, args.fasta, max_length=args.max_length,
                        batch_size=args.batch_size, mlm=mlm)
    trainer = Trainer(model, TrainerConfig(run_dir=args.run_dir), None,
                      dm.eval_loader(args.split), mesh=mesh,
                      tensor_parallel=args.tensor_parallel,
                      context_parallel=args.context_parallel)
    metrics = trainer.evaluate(max_batches=args.max_batches,
                               prefix=args.split)
    if trainer.is_main:
        print(json.dumps(metrics))
    _end_mesh(mesh)


def cmd_finetune(argv):
    """Fine-tune on a downstream classification task (`finetune.py
    main`)."""
    from caduceus_tpu_torch.finetune import main as finetune_main

    finetune_main(argv)


def cmd_vep(argv):
    """Variant embeddings of a run dir's model, and their SVM eval with
    ``--svm`` (`vep.py main`)."""
    from caduceus_tpu_torch.vep import main as vep_main

    vep_main(argv)


def cmd_generate(argv):
    """Autoregressive generation through the recurrent (O(1)/token) path
    (`inference.py generate`), for a causal model (bidirectional=False,
    rcps=False). Prints {"prompt", "generated"} as one JSON line."""
    p = argparse.ArgumentParser(prog="generate")
    p.add_argument("--run-dir", required=True, help=_RUN_DIR_HELP)
    p.add_argument("--prompt", default="ACGT", help="DNA prompt string")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from caduceus_tpu_torch import resolve_device
    from caduceus_tpu_torch.inference import generate
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.params import load_run_dir
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    dev = resolve_device(args.device)
    cfg, params = load_run_dir(args.run_dir)
    model = CaduceusForMaskedLM(cfg, device=dev,
                                tie_word_embeddings="lm_head" not in params)
    model.load_state_dict(params)
    model.eval()
    tok = CaduceusTokenizer()
    prompt_ids = torch.from_numpy(
        tok.encode(args.prompt).astype(np.int64))[None].to(dev)
    out = generate(model, prompt_ids, args.max_new_tokens,
                   generator=torch.Generator(device=dev).manual_seed(args.seed),
                   temperature=args.temperature, top_k=args.top_k)
    print(json.dumps({
        "prompt": args.prompt,
        "generated": tok.decode(out[0, prompt_ids.shape[1]:].cpu().numpy()),
    }))


def cmd_serve(argv):
    """HTTP server for /embed, /logits and /generate over a run dir
    (`serve.py`; parameters as `params.py load_run_dir` reads them), or for
    /classify over a `finetune --save-dir` export."""
    p = argparse.ArgumentParser(prog="serve")
    p.add_argument("--run-dir", required=True,
                   help=_RUN_DIR_HELP + "; or a finetune --save-dir export "
                   "(task_config.json)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-length", type=int, default=131072)
    p.add_argument("--min-bucket", type=int, default=128)
    p.add_argument("--warmup", action="store_true",
                   help="run every bucket's dispatches once before "
                        "accepting traffic (no live request pays for a "
                        "first call)")
    args = p.parse_args(argv)

    from caduceus_tpu_torch.serve import InferenceServer, InferenceService

    svc = InferenceService.from_run_dir(
        args.run_dir, device=args.device, max_batch=args.max_batch,
        max_length=args.max_length, min_bucket=args.min_bucket)
    if args.warmup:
        print(json.dumps({"warmed_programs": svc.warmup()}), flush=True)
    server = InferenceServer(svc, args.host, args.port)
    endpoints = (["/classify"] if svc.task_cfg is not None
                 else ["/embed", "/logits", "/generate"])
    print(json.dumps({"serving": f"http://{args.host}:{server.port}",
                      "device": str(svc.device),
                      "endpoints": endpoints + ["/healthz"]}),
          flush=True)
    server.serve_forever()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    cmds = {"pretrain": cmd_pretrain, "eval": cmd_eval,
            "finetune": cmd_finetune, "vep": cmd_vep, "serve": cmd_serve,
            "generate": cmd_generate}
    if not argv or argv[0] not in cmds:
        print(f"usage: python -m caduceus_tpu_torch.cli {{{','.join(cmds)}}} ...")
        sys.exit(2)
    cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
