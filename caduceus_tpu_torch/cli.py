"""Command line of the port: ``python -m caduceus_tpu_torch.cli
{serve,generate}``.

Port of the ``serve`` and ``generate`` subcommands of `caduceus_tpu/cli.py`
over a run dir holding ``model_config.json`` + ``params.npz``; the other
subcommands are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_generate(argv):
    """Autoregressive generation through the recurrent (O(1)/token) path
    (`inference.py generate`), for a causal model (bidirectional=False,
    rcps=False). Prints {"prompt", "generated"} as one JSON line."""
    p = argparse.ArgumentParser(prog="generate")
    p.add_argument("--run-dir", required=True,
                   help="run dir with model_config.json + params.npz")
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
    """HTTP server for /embed, /logits and /generate over a run dir holding
    ``model_config.json`` + ``params.npz`` (`serve.py`)."""
    p = argparse.ArgumentParser(prog="serve")
    p.add_argument("--run-dir", required=True,
                   help="run dir with model_config.json + params.npz")
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
    cmds = {"serve": cmd_serve, "generate": cmd_generate}
    if not argv or argv[0] not in cmds:
        print(f"usage: python -m caduceus_tpu_torch.cli {{{','.join(cmds)}}} ...")
        sys.exit(2)
    cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
