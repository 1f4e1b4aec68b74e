"""Batch inference server: /embed, /logits, /generate and /classify over
HTTP.

Port of `caduceus_tpu/serve.py` (`InferenceService`, `InferenceServer` and
its handler) for the Caduceus models, Mamba-1 (v1) and Mamba-2 (v2):

  POST /embed    {"sequences": [...]}   -> pooled embeddings
  POST /logits   {"sequences": [...]}   -> per-position logits
  POST /generate {"prompt": "ACGT", "max_new_tokens": 64, "temperature":
                  0.0, "top_k": null, "seed": 0}  -> {"prompt", "generated"}
  POST /classify {"sequences": [...]}   -> per-sequence scores of a
                                           fine-tuned classifier
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
- **Warm-up.** `InferenceService.warmup` (``cli.py serve --warmup``) runs
  every (bucket, batch) signature's dispatches once before the socket
  listens, with the JAX server's defaults and count.
- **Generation.** A /generate request is its own dispatch: the prompt is
  prefilled at its exact length (no bucket), then decoded token by token
  (`inference.py generate`), sampling from a `torch.Generator` seeded by
  the request's ``seed``. Causal models only; the others answer 500 with
  the `NotImplementedError`, as the JAX server does.

- **Classification.** A model dir holding ``task_config.json`` (`finetune
  --save-dir`, the port's or the JAX package's; a Caduceus, Hyena or CNN
  classifier, by its ``model_kind``) serves /classify only: each
  sequence is encoded as the fine-tuning's eval encodes it (the task's
  padding side and ``add_eos``, the rc strand stacked when conjoined) at
  the task's fixed length, and the batch is padded to a power of two with
  pad rows of length 1; replies by problem type (label and softmax probs,
  sigmoid probs and labels, or a regression value).

`from_run_dir` reads ``model_config.json`` and the parameters from a
``params.npz`` export, the port's latest checkpoint or a JAX run's Orbax
checkpoint (`params.py load_run_dir`), or a fine-tuned export: its
``params.npz``, or the JAX export's Orbax ``params/`` (`train/checkpoint.py
read_orbax_arrays`, tensorstore).
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
from caduceus_tpu_torch.models.hyena import hyena_kwargs
from caduceus_tpu_torch.models.caduceus import (
    CaduceusForMaskedLM,
    canonical_to_reference,
    collapse_strand_mean,
)
from caduceus_tpu_torch.tokenization import (
    CaduceusTokenizer,
    CharacterTokenizer,
    string_reverse_complement,
)


def _next_bucket(n: int, min_bucket: int, max_len: int) -> int:
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, max_len)


@dataclass
class _Request:
    kind: str                 # "embed" | "logits" | "generate" | "classify"
    payload: Any
    bucket: int
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[str] = None

    def finish(self, result=None, error=None):
        self.result, self.error = result, error
        self.event.set()


class InferenceService:
    """A `CaduceusForMaskedLM` on one device behind /embed and /logits, or,
    with ``task_cfg`` (a fine-tuned export's ``task_config.json``), its
    classifier (`finetune.py _make_classifier`) behind /classify.

    ``params`` is the model's state_dict (e.g. from `params.py
    from_jax_params`, or `model.state_dict()`)."""

    def __init__(self, cfg: CaduceusConfig, params: Dict[str, torch.Tensor],
                 device="cuda", max_batch: int = 8, min_bucket: int = 128,
                 max_length: int = 131072, linger_ms: float = 5.0,
                 task_cfg: Optional[dict] = None):
        self.cfg = cfg
        self.task_cfg = task_cfg
        self.device = resolve_device(device)
        if task_cfg is not None:
            from caduceus_tpu_torch.finetune import _make_classifier

            self.model = _make_classifier(
                cfg, task_cfg["num_classes"], task_cfg["pooling"],
                task_cfg["use_lengths"], task_cfg.get("padding_side", "left"),
                encoder=task_cfg.get("encoder", "id"),
                model_kind=task_cfg["model_kind"], device=self.device,
                seq_len=task_cfg["max_length"])
        else:
            self.model = CaduceusForMaskedLM(
                cfg, device=self.device,
                tie_word_embeddings="lm_head" not in params)
        self.model.load_state_dict(params)
        self.model.eval()
        if self.device.type == "cuda":
            # build the kernels of the config's family now, so that no
            # request pays the nvcc compile: for v2 the two SSD libraries,
            # which hold every ``use_kernel`` route's kernels (the fused
            # ones, and the unfused ones of the prefill and of "pallas");
            # for a Hyena classifier the attention kernels (the CNN has
            # none)
            kind = "caduceus" if task_cfg is None else task_cfg["model_kind"]
            if kind == "hyena":
                from caduceus_tpu_torch.ops.attention import build
            elif kind == "cnn":
                build = None
            elif cfg.ssm_cfg.version == 1:
                from caduceus_tpu_torch.ops.scan import build
            else:
                from caduceus_tpu_torch.ops.ssd_batched import build
            if build is not None:
                build()
        if task_cfg is not None:
            # encode as the fine-tuning's eval does: the task's padding
            # side, its fixed length
            self.tok = CharacterTokenizer(
                model_max_length=max_length,
                padding_side=task_cfg.get("padding_side", "left"))
        else:
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
        preferred), or a fine-tuned export (``task_config.json``) behind
        /classify."""
        from caduceus_tpu_torch.params import load_run_dir

        task_path = os.path.join(run_dir, "task_config.json")
        if os.path.exists(task_path):
            return cls._from_finetuned(run_dir, task_path, **kw)
        return cls(*load_run_dir(run_dir), **kw)

    @classmethod
    def _from_finetuned(cls, run_dir: str, task_path: str,
                        **kw) -> "InferenceService":
        """A `finetune --save-dir` export: ``task_config.json`` and the
        classifier's parameters as ``params.npz`` (the port's export) or an
        Orbax ``params/`` directory (the JAX package's: its ``params``
        root, and for the CNN its BatchNorm ``batch_stats`` root beside
        it, `caduceus_tpu/finetune.py:331-339`)."""
        from caduceus_tpu_torch.finetune import _make_classifier
        from caduceus_tpu_torch.params import from_jax_params, load_npz_params
        from caduceus_tpu_torch.train.checkpoint import (
            orbax_tree_paths, read_orbax_arrays)

        with open(task_path) as f:
            tc = json.load(f)
        kind = tc["model_kind"]
        if kind == "caduceus":
            cfg = CaduceusConfig.from_dict(tc["model_cfg"])
        elif kind == "hyena":
            cfg = hyena_kwargs(tc["model_cfg"])
        else:   # the from-scratch CNN
            cfg = None
        npz = os.path.join(run_dir, "params.npz")
        if os.path.exists(npz):
            flat = load_npz_params(npz)
        else:
            orbax = os.path.join(run_dir, "params")
            roots = {k[0] for k in orbax_tree_paths(orbax)}
            flat = {}
            for root in ("params", "batch_stats"):
                if root in roots:
                    flat.update(read_orbax_arrays(orbax, root))
        with torch.device("meta"):
            shape = _make_classifier(
                cfg, tc["num_classes"], tc["pooling"], tc["use_lengths"],
                tc.get("padding_side", "left"),
                encoder=tc.get("encoder", "id"), model_kind=kind,
                device="meta", seq_len=tc["max_length"])
        params = from_jax_params(flat, cfg, model=shape)
        kw.setdefault("max_length", tc["max_length"])
        return cls(cfg, params, task_cfg=tc, **kw)

    def warmup(self, buckets=None, batch_sizes=None) -> int:
        """Run every dispatch signature once before live requests, as the
        JAX service's ``warmup`` compiles them (`caduceus_tpu/serve.py:
        206-243`), so that no live request pays for a first call: on the
        card the kernel libraries built and loaded, cuBLAS's handles and
        the allocator's blocks of each signature. JAX's defaults: every
        power-of-two bucket in [min_bucket, max_length] x every
        power-of-two batch size below ``max_batch``, then ``max_batch`` (the
        batch sizes a dispatch pads to). An LM runs the /embed and the
        /logits dispatch of each (bucket, batch), counted 2 as JAX counts
        its programs; a fine-tuned classifier its fixed length x each batch
        size (``buckets`` does not apply), counted 1. Returns the count.
        Nothing is caught: a failure ends the warm-up."""
        if batch_sizes is None:
            batch_sizes, b = [], 1
            while b < self.max_batch:
                batch_sizes.append(b)
                b *= 2
            batch_sizes.append(self.max_batch)
        n = 0
        pad = self.tok.pad_token_id
        if self.task_cfg is not None:
            L = self.task_cfg["max_length"]
            with torch.inference_mode():
                for bs in batch_sizes:
                    shape = ((bs, L, 2) if self.task_cfg.get("conjoin")
                             else (bs, L))
                    self.model(torch.full(shape, pad, device=self.device),
                               torch.ones(bs, dtype=torch.long,
                                          device=self.device))
                    n += 1
            return n
        if buckets is None:
            buckets, b = [], self.min_bucket
            while b <= self.max_length:
                buckets.append(b)
                b *= 2
        for bucket in buckets:
            for bs in batch_sizes:
                ids = np.full((bs, bucket), pad, np.int64)
                for kind in ("embed", "logits"):
                    self._dispatch(kind, ids, [bucket] * bs)
                    n += 1
        return n

    # --- one padded dispatch ---

    def _embed(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h, _ = self.model.backbone(ids)
        if self.cfg.rcps:
            h = collapse_strand_mean(canonical_to_reference(h))
        m = mask[..., None].float()
        return (h.float() * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)

    def _dispatch(self, kind: str, ids: np.ndarray, lens) -> np.ndarray:
        """One padded /embed or /logits forward of (bs, bucket) ``ids``
        whose rows hold ``lens`` real tokens: the pooled embeddings or the
        logits, on the host."""
        ids_t = torch.from_numpy(ids).to(self.device)
        with torch.inference_mode():
            if kind == "embed":
                mask = (torch.arange(ids.shape[1])[None, :]
                        < torch.tensor(lens)[:, None]).to(self.device)
                return self._embed(ids_t, mask).cpu().numpy()
            return self.model(ids_t).cpu().numpy()

    def _run_batch(self, kind: str, batch: List[_Request]):
        try:
            if kind == "classify":
                return self._run_classify(batch)
            bucket = batch[0].bucket
            bs = _next_bucket(len(batch), 1, self.max_batch)
            ids = np.full((bs, bucket), self.tok.pad_token_id, np.int64)
            lens = []
            for i, r in enumerate(batch):
                ids[i, :len(r.payload)] = r.payload
                lens.append(len(r.payload))
            lens += [0] * (bs - len(batch))
            out = self._dispatch(kind, ids, lens)
            for i, r in enumerate(batch):
                r.finish(result=out[i] if kind == "embed"
                         else out[i, :lens[i]])
            self.n_dispatches += 1
            self.n_served += len(batch)
        except Exception as e:  # surface to every waiter in the batch
            traceback.print_exc()
            for r in batch:
                r.finish(error=f"{type(e).__name__}: {e}")

    def _run_classify(self, batch: List[_Request]):
        """One fixed-length /classify dispatch; each payload is the raw
        sequence string."""
        tc = self.task_cfg
        L = tc["max_length"]
        xs, lens = [], []
        for r in batch:
            seq = r.payload
            ids = self.tok.encode_padded(seq, L, add_sep=tc["add_eos"])
            if tc.get("conjoin"):
                rc = self.tok.encode_padded(string_reverse_complement(seq), L,
                                            add_sep=tc["add_eos"])
                ids = np.stack([ids, rc], axis=-1)
            xs.append(ids)
            lens.append(min(len(seq) + int(tc["add_eos"]), L))
        bs = _next_bucket(len(batch), 1, self.max_batch)
        while len(xs) < bs:
            xs.append(np.full_like(xs[0], self.tok.pad_token_id))
            lens.append(1)
        ids = torch.from_numpy(np.stack(xs).astype(np.int64)).to(self.device)
        lengths = torch.tensor(lens, dtype=torch.long, device=self.device)
        with torch.inference_mode():
            scores = self.model(ids, lengths).cpu().numpy()
        pt = tc["problem_type"]
        for i, r in enumerate(batch):
            s = scores[i]
            if pt == "regression":
                r.finish(result={"prediction": float(s[0])})
            elif pt == "multi_label_classification":
                p = 1.0 / (1.0 + np.exp(-s))
                r.finish(result={"probs": p.tolist(),
                                 "labels": np.nonzero(s > 0)[0].tolist()})
            else:
                e = np.exp(s - s.max())
                r.finish(result={"label": int(np.argmax(s)),
                                 "probs": (e / e.sum()).tolist()})
        self.n_dispatches += 1
        self.n_served += len(batch)

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


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 is fewer than the
    # connections one batch of concurrent requests opens at once, and a
    # connect past a full backlog waits for a SYN retry (about a second)
    request_queue_size = 128


class InferenceServer:
    """HTTP front + batching worker around an `InferenceService`."""

    def __init__(self, service: InferenceService, host: str = "127.0.0.1",
                 port: int = 8000):
        self.service = service
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self.httpd = _HTTPServer((host, port), _make_handler(self))
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
                if svc.task_cfg is not None:
                    info = {"task": svc.task_cfg["task"],
                            "num_classes": svc.task_cfg["num_classes"],
                            "model_kind": svc.task_cfg["model_kind"]}
                else:
                    info = {"d_model": svc.cfg.d_model,
                            "n_layer": svc.cfg.n_layer,
                            "rcps": svc.cfg.rcps}
                self._reply(200, {
                    "status": "ok",
                    "served": svc.n_served,
                    "dispatches": svc.n_dispatches,
                    "model": info,
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
                if self.path == "/classify":
                    if svc.task_cfg is None:
                        return self._reply(
                            400, {"error": "/classify needs a finetuned "
                                  "model dir (finetune --save-dir)"})
                    seqs = req.get("sequences")
                    if not isinstance(seqs, list) or not seqs:
                        return self._reply(
                            400, {"error": "'sequences' must be a "
                                  "non-empty list of strings"})
                    L = svc.task_cfg["max_length"]
                    outs = server.submit_many(
                        "classify", [(s, L) for s in seqs])
                    return self._reply(200, {"classify": outs})
                if self.path in ("/embed", "/logits"):
                    if svc.task_cfg is not None:
                        return self._reply(
                            400, {"error": f"{self.path} needs a pretrain "
                                  "run dir; this server hosts the "
                                  f"'{svc.task_cfg['task']}' classifier "
                                  "(/classify)"})
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
                    if svc.task_cfg is not None:
                        return self._reply(
                            400, {"error": "/generate needs a pretrain run "
                                  "dir (causal LM)"})
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
