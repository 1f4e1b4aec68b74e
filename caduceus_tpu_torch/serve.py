"""Batch inference server: /embed, /logits and /generate over HTTP.

Port of `caduceus_tpu/serve.py` (`InferenceService`, `InferenceServer` and
its handler) for the Caduceus models, Mamba-1 (v1) and Mamba-2 (v2):

  POST /embed    {"sequences": [...]}   -> pooled embeddings
  POST /logits   {"sequences": [...]}   -> per-position logits
  POST /generate {"prompt": "ACGT", "max_new_tokens": 64, "temperature":
                  0.0, "top_k": null, "seed": 0}  -> {"prompt", "generated"}
  GET  /healthz                         -> liveness + stats

- **Length buckets.** Each request is padded to the next power-of-two
  bucket (≤ max_length) and the batch to the next power of two (≤
  max_batch), the same signatures as the JAX server, so both answer with
  the same numbers for the same params.
- **One device owner, micro-batching.** A single worker thread owns the
  card; concurrent HTTP requests enqueue and the worker coalesces
  same-endpoint/same-bucket requests into one padded dispatch (up to
  ``max_batch``, with a short linger window). Each dispatch is one model
  forward under ``torch.inference_mode()``.
- **Pad-masked pooling.** /embed mean-pools (in fp32) only real positions;
  RCPS hidden states collapse to the strand mean. The pads do take part in
  the bidirectional scan, as in the JAX server.
- **Generation.** A /generate request is its own dispatch: the prompt is
  prefilled at its exact length (no bucket), then decoded token by token
  (`inference.py generate`), sampling from a `torch.Generator` seeded by
  the request's ``seed``. Causal models only; the others answer 500 with
  the `NotImplementedError`, as the JAX server does.

Not ported yet: /classify (finetuned exports), which answers 501.
`from_run_dir` reads ``model_config.json`` and the parameters from a
``params.npz`` export, the port's latest checkpoint or a JAX run's Orbax
checkpoint (`params.py load_run_dir`).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from caduceus_tpu_torch import resolve_device
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models.caduceus import (
    CaduceusForMaskedLM,
    canonical_to_reference,
    collapse_strand_mean,
)
from caduceus_tpu_torch.tokenization import CaduceusTokenizer

NOT_PORTED = ("/classify",)


def _next_bucket(n: int, min_bucket: int, max_len: int) -> int:
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, max_len)


@dataclass
class _Request:
    kind: str                 # "embed" | "logits" | "generate"
    payload: Any
    bucket: int
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[str] = None

    def finish(self, result=None, error=None):
        self.result, self.error = result, error
        self.event.set()


class InferenceService:
    """A `CaduceusForMaskedLM` on one device behind /embed and /logits.

    ``params`` is the model's state_dict (e.g. from `params.py
    from_jax_params`, or `model.state_dict()`)."""

    def __init__(self, cfg: CaduceusConfig, params: Dict[str, torch.Tensor],
                 device="cuda", max_batch: int = 8, min_bucket: int = 128,
                 max_length: int = 131072, linger_ms: float = 5.0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = CaduceusForMaskedLM(
            cfg, device=self.device,
            tie_word_embeddings="lm_head" not in params)
        self.model.load_state_dict(params)
        self.model.eval()
        if self.device.type == "cuda":
            # build the kernels of the config's family now, so that no
            # request pays the nvcc compile: for v2 the two SSD libraries,
            # which hold every ``use_kernel`` route's kernels (the fused
            # ones, and the unfused ones of the prefill and of "pallas")
            if cfg.ssm_cfg.version == 1:
                from caduceus_tpu_torch.ops.scan import build
            else:
                from caduceus_tpu_torch.ops.ssd_batched import build
            build()
        self.tok = CaduceusTokenizer(model_max_length=max_length)
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        self.max_length = max_length
        self.linger_s = linger_ms / 1e3
        self.n_served = 0
        self.n_dispatches = 0

    @classmethod
    def from_run_dir(cls, run_dir: str, **kw) -> "InferenceService":
        """Serve a run dir's model (`params.py load_run_dir`: a
        ``params.npz`` export, else the latest checkpoint, EMA weights
        preferred)."""
        from caduceus_tpu_torch.params import load_run_dir

        return cls(*load_run_dir(run_dir), **kw)

    # --- one padded dispatch ---

    def _embed(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h, _ = self.model.backbone(ids)
        if self.cfg.rcps:
            h = collapse_strand_mean(canonical_to_reference(h))
        m = mask[..., None].float()
        return (h.float() * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)

    def _run_batch(self, kind: str, batch: List[_Request]):
        try:
            bucket = batch[0].bucket
            bs = _next_bucket(len(batch), 1, self.max_batch)
            ids = np.full((bs, bucket), self.tok.pad_token_id, np.int64)
            lens = []
            for i, r in enumerate(batch):
                ids[i, :len(r.payload)] = r.payload
                lens.append(len(r.payload))
            lens += [0] * (bs - len(batch))
            ids_t = torch.from_numpy(ids).to(self.device)
            with torch.inference_mode():
                if kind == "embed":
                    mask = (torch.arange(bucket)[None, :]
                            < torch.tensor(lens)[:, None]).to(self.device)
                    out = self._embed(ids_t, mask).cpu().numpy()
                    for i, r in enumerate(batch):
                        r.finish(result=out[i])
                else:
                    out = self.model(ids_t).cpu().numpy()
                    for i, r in enumerate(batch):
                        r.finish(result=out[i, :lens[i]])
            self.n_dispatches += 1
            self.n_served += len(batch)
        except Exception as e:  # surface to every waiter in the batch
            traceback.print_exc()
            for r in batch:
                r.finish(error=f"{type(e).__name__}: {e}")

    def _run_generate(self, r: _Request):
        from caduceus_tpu_torch.inference import generate

        try:
            p = r.payload
            prompt = torch.from_numpy(
                np.asarray(p["ids"], np.int64))[None].to(self.device)
            gen = torch.Generator(device=self.device).manual_seed(
                p.get("seed", 0))
            out = generate(self.model, prompt, p["max_new_tokens"],
                           generator=gen,
                           temperature=p.get("temperature", 0.0),
                           top_k=p.get("top_k"))
            new = out[0, prompt.shape[1]:].cpu().numpy()
            self.n_dispatches += 1
            self.n_served += 1
            r.finish(result=self.tok.decode(new))
        except Exception as e:  # surface to the waiter
            traceback.print_exc()
            r.finish(error=f"{type(e).__name__}: {e}")


class InferenceServer:
    """HTTP front + batching worker around an `InferenceService`."""

    def __init__(self, service: InferenceService, host: str = "127.0.0.1",
                 port: int = 8000):
        self.service = service
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.port = self.httpd.server_address[1]

    # --- batching worker: coalesce same-kind/same-bucket requests ---

    def _drain(self):
        svc = self.service
        pending: List[_Request] = []  # requests seen but not yet dispatched
        while not self._stop.is_set():
            if not pending:
                try:
                    pending.append(self.queue.get(timeout=0.1))
                except queue.Empty:
                    continue
            first = pending.pop(0)
            if first.kind == "generate":
                svc._run_generate(first)
                continue
            batch = [first]
            deadline = time.monotonic() + svc.linger_s
            # same (kind, bucket) joins the dispatch; anything else waits
            # its turn in `pending` (still FIFO per signature)
            while len(batch) < svc.max_batch:
                nxt = None
                for i, r in enumerate(pending):
                    if r.kind == first.kind and r.bucket == first.bucket:
                        nxt = pending.pop(i)
                        break
                if nxt is None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        cand = self.queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if (cand.kind == first.kind
                            and cand.bucket == first.bucket):
                        nxt = cand
                    else:
                        pending.append(cand)
                        continue
                batch.append(nxt)
            svc._run_batch(first.kind, batch)

    def submit_many(self, kind: str, payloads_buckets,
                    timeout: float = 600.0):
        """Enqueue several requests at once (so one HTTP request's
        sequences can share a dispatch), then wait for all."""
        reqs = [_Request(kind, p, b) for p, b in payloads_buckets]
        for r in reqs:
            self.queue.put(r)
        out = []
        for r in reqs:
            if not r.event.wait(timeout):
                raise TimeoutError(f"{kind} request timed out")
            if r.error:
                raise RuntimeError(r.error)
            out.append(r.result)
        return out

    def submit(self, kind: str, payload, bucket: int,
               timeout: float = 600.0):
        return self.submit_many(kind, [(payload, bucket)], timeout)[0]

    def start(self):
        self._worker.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._http_thread.start()
        return self

    def stop(self):
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._worker.join(timeout=10)

    def serve_forever(self):
        self._worker.start()
        self.httpd.serve_forever()


def _make_handler(server: InferenceServer):
    svc = server.service

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            if os.environ.get("CADUCEUS_SERVE_VERBOSE") == "1":
                super().log_message(fmt, *args)

        def _reply(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {
                    "status": "ok",
                    "served": svc.n_served,
                    "dispatches": svc.n_dispatches,
                    "model": {"d_model": svc.cfg.d_model,
                              "n_layer": svc.cfg.n_layer,
                              "rcps": svc.cfg.rcps},
                    "device": str(svc.device),
                })
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except Exception as e:
                return self._reply(400, {"error": f"bad json: {e}"})
            try:
                if self.path in NOT_PORTED:
                    return self._reply(501, {
                        "error": f"{self.path} is not yet ported to the "
                                 "PyTorch server; use caduceus_tpu.serve"})
                if self.path in ("/embed", "/logits"):
                    seqs = req.get("sequences")
                    if not isinstance(seqs, list) or not seqs:
                        return self._reply(
                            400, {"error": "'sequences' must be a "
                                  "non-empty list of strings"})
                    kind = self.path[1:]
                    items = []
                    for s in seqs:
                        ids = svc.tok.encode(s)
                        if len(ids) > svc.max_length:
                            return self._reply(
                                400, {"error": f"sequence length {len(ids)}"
                                      f" > max_length {svc.max_length}"})
                        items.append((ids, _next_bucket(
                            len(ids), svc.min_bucket, svc.max_length)))
                    outs = server.submit_many(kind, items)
                    return self._reply(
                        200, {kind: [o.tolist() for o in outs]})
                if self.path == "/generate":
                    prompt = req.get("prompt", "")
                    ids = svc.tok.encode(prompt)
                    if len(ids) > svc.max_length:
                        return self._reply(
                            400, {"error": f"prompt length {len(ids)} > "
                                  f"max_length {svc.max_length}"})
                    out = server.submit("generate", {
                        "ids": ids,
                        "max_new_tokens": int(req.get("max_new_tokens", 64)),
                        "temperature": float(req.get("temperature", 0.0)),
                        "top_k": req.get("top_k"),
                        "seed": int(req.get("seed", 0)),
                    }, bucket=0)
                    return self._reply(
                        200, {"prompt": prompt, "generated": out})
                return self._reply(404, {"error": "not found"})
            except Exception as e:
                return self._reply(500, {"error": str(e)})

    return Handler
