"""Command line of the port: ``python -m caduceus_tpu_torch.cli
{pretrain,eval,serve,generate}``.

Port of those subcommands of `caduceus_tpu/cli.py`, with its flags and its
``model_config.json``. ``pretrain`` trains ``--model caduceus`` (MLM, or
NTP with ``--ntp``) and ``--model mamba --ntp`` on an hg38-style FASTA +
BED through `train/trainer.py Trainer`, writing ``model_config.json``,
``metrics.jsonl`` and ``checkpoints/`` into the run dir. ``eval``,
``serve`` and ``generate`` read a run dir's parameters from a
``params.npz`` export, the port's latest checkpoint or a JAX run's Orbax
checkpoint, in that order (`params.py load_run_dir`). Every subcommand
runs on the card unless ``--device cpu`` is given. Not ported yet:
``finetune``, ``vep``, ``--model hyena`` and the multi-device flags
(``--mesh-model`` > 1, ``--tensor-parallel``, ``--context-parallel``).
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
    # the JAX CLI's multi-device flags, so its command lines parse; the
    # port runs one device and refuses the rest (`_refuse_parallel`)
    p.add_argument("--mesh-model", type=int, default=1,
                   help="size of the mesh 'model' axis (not ported: 1 only)")
    p.add_argument("--tensor-parallel", action="store_true",
                   help="not ported yet")
    p.add_argument("--context-parallel", action="store_true",
                   help="not ported yet")


def _refuse_parallel(p, args):
    if args.mesh_model > 1 or args.tensor_parallel or args.context_parallel:
        p.error("--mesh-model > 1, --tensor-parallel and --context-parallel "
                "are not ported yet (ROADMAP.md queue 1 item 8)")


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
                        "hyena is not ported yet")
    p.add_argument("--attn-layer-idx",
                   type=lambda s: tuple(int(x) for x in s.split(",") if x),
                   default=(), help="--model hyena only (not ported yet)")
    p.add_argument("--num-heads", type=int, default=8,
                   help="--model hyena only (not ported yet)")
    p.add_argument("--hyena-checkpoint", action="store_true",
                   help="--model hyena only (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    _add_parallel_args(p)
    _add_common_model_args(p)
    p.set_defaults(**preset)
    args = p.parse_args(argv)
    if args.model == "hyena" or args.attn_layer_idx or args.hyena_checkpoint:
        p.error("--model hyena (and its --attn-layer-idx / "
                "--hyena-checkpoint) is not ported yet (ROADMAP.md queue 1 "
                "item 7)")
    if args.model == "mamba" and not args.ntp:
        p.error("--model mamba is causal: pretrain with --ntp")
    _refuse_parallel(p, args)

    import torch

    from caduceus_tpu_torch import resolve_device
    from caduceus_tpu_torch.data.hg38 import HG38DataModule
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.train.trainer import Trainer, TrainerConfig
    from caduceus_tpu_torch.utils.logging import make_logger, param_count

    dev = resolve_device(args.device)
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
    cfg = _build_model_config(args, dm.tokenizer)
    if args.model == "mamba":
        # unidirectional causal Mamba LM (`dna_embedding.py:99-153`)
        cfg.rcps = False
        cfg.bidirectional = False
    # the objective, so that `eval` rebuilds the right task; the parallel
    # axes are launch choices, not part of the model
    meta = cfg.to_dict()
    meta["objective"] = "ntp" if args.ntp else "mlm"
    meta["tensor_parallel_axis"] = None
    meta["context_parallel_axis"] = None
    with open(os.path.join(args.run_dir, "model_config.json"), "w") as f:
        json.dump(meta, f, indent=2)
    model = CaduceusForMaskedLM(
        cfg, device=dev, generator=torch.Generator().manual_seed(args.seed))
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
        prefetch=args.prefetch,
        profile_dir=args.profile_dir,
        log_every=args.log_every,
        eval_every=args.eval_every,
        eval_batches=args.eval_batches,
        checkpoint_every=args.checkpoint_every,
    )
    log_fn = make_logger(run_dir=args.run_dir)
    train_loader = dm.train_loader()
    try:
        trainer = Trainer(model, tcfg, train_loader, dm.eval_loader("valid"),
                          ignore_index=dm.tokenizer.pad_token_id,
                          log_fn=log_fn)
        trainer.init_state()
        log_fn(param_count(model))
        if args.resume:
            trainer.restore_checkpoint()
        metrics = trainer.fit()
        trainer.save_checkpoint()
    finally:
        train_loader.close()
    print(json.dumps({"final": metrics}))


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
    _refuse_parallel(p, args)
    with open(os.path.join(args.run_dir, "model_config.json")) as f:
        raw = json.load(f)
    if raw.get("model_type") == "hyena":
        p.error("hyena run dirs are not ported yet (ROADMAP.md queue 1 "
                "item 7)")

    from caduceus_tpu_torch import resolve_device
    from caduceus_tpu_torch.data.hg38 import HG38DataModule
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.params import load_run_dir
    from caduceus_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    cfg, params = load_run_dir(args.run_dir)
    model = CaduceusForMaskedLM(cfg, device=dev,
                                tie_word_embeddings="lm_head" not in params)
    model.load_state_dict(params)
    # the objective recorded at pretrain time (older runs: MLM)
    mlm = raw.get("objective", "mlm") == "mlm"
    dm = HG38DataModule(args.bed, args.fasta, max_length=args.max_length,
                        batch_size=args.batch_size, mlm=mlm)
    trainer = Trainer(model, TrainerConfig(run_dir=args.run_dir), None,
                      dm.eval_loader(args.split))
    print(json.dumps(trainer.evaluate(max_batches=args.max_batches,
                                      prefix=args.split)))


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
    (`serve.py`; parameters as `params.py load_run_dir` reads them)."""
    p = argparse.ArgumentParser(prog="serve")
    p.add_argument("--run-dir", required=True, help=_RUN_DIR_HELP)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-length", type=int, default=131072)
    p.add_argument("--min-bucket", type=int, default=128)
    args = p.parse_args(argv)

    from caduceus_tpu_torch.serve import InferenceServer, InferenceService

    svc = InferenceService.from_run_dir(
        args.run_dir, device=args.device, max_batch=args.max_batch,
        max_length=args.max_length, min_bucket=args.min_bucket)
    server = InferenceServer(svc, args.host, args.port)
    print(json.dumps({"serving": f"http://{args.host}:{server.port}",
                      "device": str(svc.device),
                      "endpoints": ["/embed", "/logits", "/generate",
                                    "/healthz"]}),
          flush=True)
    server.serve_forever()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    cmds = {"pretrain": cmd_pretrain, "eval": cmd_eval, "serve": cmd_serve,
            "generate": cmd_generate}
    if not argv or argv[0] not in cmds:
        print(f"usage: python -m caduceus_tpu_torch.cli {{{','.join(cmds)}}} ...")
        sys.exit(2)
    cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
