#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100: kernels, server, training.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc). It imports nothing of JAX or of `caduceus_tpu`. Phases, in
order (any failure exits non-zero; nothing is caught and passed over):

1. build the kernels from `caduceus_tpu_torch/csrc` (nvcc, sm_90a; one
   nvcc per source, side by side): `ssd_fused_fwd.cu` and
   `ssd_fused_bwd.cu` (two __global__ kernels); print build times and
   the ptxas reports;
2. hold the forward kernel (y, hN and the chunk carries) against its
   plain PyTorch version (`ops/ssd.py ssd_chunked_fused`) on the card:
   small shapes (fp32 and bf16, both directions, nonzero h_init, L not a
   multiple of the chunk, ngroups 1 and 2) and the main-path geometry
   (H=8, P=64, N=128, K=4, Wc=768, G=4, L=8192), by the rule of
   `caduceus_tpu_torch/kernel_check.py`; faults planted in its output at
   the main geometry (D term dropped, one 16x16 tile of y or hN wrong)
   must fail that check;
3. the same for the backward kernels (`ssd_fused_bwd`: all eight
   gradients against `ssd_chunked_fused_bwd`, nonzero h_init and g_hN),
   each kernel also alone against its own plain version, and four faults
   planted in the backward's outputs at the main geometry (the conv
   transpose's neighbour rows dropped, one 16-row tile of g_dt zeroed,
   g_A scaled by 1+2^-4, one 16x16 tile of g_xBC's B columns zeroed);
4. hold the whole model on the card against the same model on the CPU
   (same weights, full width, 2 layers, L=2048, fp32 logits);
5. serve the full-width `hg38_mlm_v2` model (16 layers, random weights
   from a seeded torch.Generator) over HTTP: /embed and /logits at
   buckets 1024 and 16384 with 1-4 sequences, and one 131,072-token
   /logits; the forward kernel's launch count must be 2 directions x 16
   layers per dispatch, and the served bf16 logits of a 1024-bucket
   request must equal a direct forward and agree with the fp32 model on
   the CPU;
6. one training step (accum 2) of the full-width model at 2 layers,
   L=2048, fp32, on the card and on the CPU from the same weights and
   batch: loss, grad norm, every gradient and every updated parameter
   must agree, and the card's update must equal AdamW's first step from
   the card's own gradient;
7. train the full-width `hg38_mlm_v2` model (16 layers, remat span 1,
   bf16 over fp32 params) at L=131072: micro-batches of 2 sequences
   (G=4 per SSD call), accum 2, AdamW as `bench.py`; one warm-up step
   and 2 timed steps, finite loss and grad norm, and the launch counts
   pinned per micro-batch;
8. time the kernels at the training shape (G=4, L=131072, bf16) and the
   forward also at G=16 (`bench.py`'s batch of 8 x 2 strands) beside
   their plain versions and bounds, and hold the timed outputs against
   the plain versions'.

Prints every measurement as one `[report]` JSON line, then a `kernels`
JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

MODEL_TOL = 1e-3       # card vs CPU logits, fp32, 2 layers, normalized
# card vs CPU training step, fp32, 2 layers (both sides sum in other
# orders): loss and grad norm relative; each gradient against its largest
# element; each updated parameter in units of (1 + |p|) where the gradient
# is above `settled` x its largest (Adam's first step is lr·g/(|g| + eps):
# at a gradient near 0 its sign decides, so there the bound is 2·lr), and
# every updated parameter, in the same units, against AdamW's first step
# computed in fp64 from the card's own gradient
TRAIN_TOL = {"metric": 1e-5, "grad": 1e-4, "param": 1e-6, "settled": 1e-3}
# served bf16 logits vs the fp32 CPU model, 16 layers, normalized: a few
# bf16 roundings (2^-8 each) per layer, compounded over 16 layers
BF16_MODEL_TOL = 5e-2
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12       # dense tensor-core bf16
FP32_FLOP_PER_S = 67e12        # fp32 outside the tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str):
    print(msg, flush=True)


def hg38_mlm_v2_config(n_layer: int = 16, dtype: str = "bfloat16"):
    """`configs/hg38_mlm_v2.yaml`'s model, written out (no YAML)."""
    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    tok = CaduceusTokenizer()
    return CaduceusConfig(
        d_model=256, n_layer=n_layer, vocab_size=tok.vocab_size,
        rcps=True, complement_map=tok.complement_map, bidirectional=True,
        bidirectional_strategy="add", bidirectional_weight_tie=True,
        rms_norm=True, residual_in_fp32=False, fused_add_norm=True,
        dtype=dtype, param_dtype="float32", remat=True, remat_span=1,
        ssm_cfg=SSMConfig(version=2, d_state=128, headdim=64, ngroups=1,
                          d_conv=4, expand=2, ssd_chunk_size=128,
                          ssd_seg_chunks=8))


def ssd_inputs(G, L, H, P, NG, N, K, dtype, seed, width_pad=0):
    """Seeded kernel inputs on the card, with the backward's cotangents
    g_y and g_hN. With ``width_pad`` xBC and dt are column slices of one
    wider tensor, as the mixer's in_proj split gives them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    Wc = H * P + 2 * NG * N

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    wide = rnd(G, L, width_pad + Wc + H)
    wide[..., width_pad + Wc:] *= 0.5
    wide = wide.to(dtype)
    xBC = wide[..., width_pad:width_pad + Wc]
    dt = wide[..., width_pad + Wc:]
    if width_pad == 0:
        xBC, dt = xBC.contiguous(), dt.contiguous()
    return dict(
        xBC=xBC, dt=dt, A=-torch.exp(rnd(H, scale=0.5)),
        conv_w=rnd(K, Wc, scale=0.5), conv_b=rnd(Wc, scale=0.1),
        D=rnd(H), dt_bias=rnd(H, scale=0.1),
        h_init=rnd(G, H, N, P), dims=(H, P, NG, N),
        g_y=rnd(G, L, H, P).to(dtype), g_hN=rnd(G, H, N, P))


def phase_build():
    from caduceus_tpu_torch import _build
    from caduceus_tpu_torch.ops import ssd_batched

    t0 = time.perf_counter()
    built = ssd_batched.build()
    wall = time.perf_counter() - t0
    out = {"nvcc_flags": list(_build.NVCC_FLAGS), "wall_s": wall}
    for name, (path, secs) in built.items():
        log(f"[build] {name}: {secs:.1f} s -> {os.path.relpath(path)}")
        out[f"{name}_s"] = secs
        with open(path[:-3] + ".log") as f:
            report = f.read().split("Compiling entry function")
        for entry in report[1:]:  # the K=4 (d_conv) instantiations
            head = entry.split("\n", 1)[0]
            if "Li4E" not in head:
                continue
            kernel = next(k for k in ("ssd_fused_fwd_kernel",
                                      "ssd_fused_bwd_kernel",
                                      "ssd_conv_bwd_kernel") if k in head)
            kind = "bf16" if "bfloat16" in head else "fp32"
            kind += ", reverse" if "Lb1E" in head else ""
            for line in entry.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build]   {kernel} ({kind}): {line.strip()}")
    log(f"[build] both libraries in {wall:.1f} s wall")
    return out


def run_pair(inp, reverse, **over):
    """The forward kernel and its plain version on the same card tensors:
    ((y, hN, carries) of the kernel, (y, hN, carries) of the plain
    version). ``over`` replaces inputs of the kernel's run only."""
    from caduceus_tpu_torch.ops.ssd import ssd_chunked_fused
    from caduceus_tpu_torch.ops.ssd_batched import KERNEL_CHUNK, ssd_fused_fwd

    T = KERNEL_CHUNK[inp["xBC"].dtype]
    k = {**inp, **over}
    kernel = ssd_fused_fwd(
        k["xBC"], k["dt"], k["A"], k["conv_w"], k["conv_b"], k["D"],
        k["dt_bias"], k["dims"], True, reverse, T, k["h_init"],
        save_carries=True)
    torch.cuda.synchronize()
    plain = ssd_chunked_fused(
        inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
        inp["D"], inp["dt_bias"], dims=inp["dims"], dt_softplus=True,
        reverse=reverse, chunk_size=T, h_init=inp["h_init"],
        return_carries=True)
    return kernel, plain


FWD_NAMES = ("y", "hN", "carries")
BWD_NAMES = ("g_xBC", "g_dt", "g_A", "g_conv_w", "g_conv_b", "g_D",
             "g_dt_bias", "g_h0")


def hold(label, tol, kernel, plain, names=FWD_NAMES, expect_ok=True,
         tag="ssd"):
    """Hold each kernel output against the plain version's (see
    `caduceus_tpu_torch/kernel_check.py` for the rule) and require that
    the check passes (``expect_ok``) or, for a planted fault, fails."""
    from caduceus_tpu_torch.kernel_check import compare, describe

    out = {}
    for name, k, p in zip(names, kernel, plain):
        check(k.dtype == p.dtype and k.shape == p.shape,
              f"{label}: {name} is {k.dtype} {tuple(k.shape)}, plain "
              f"{p.dtype} {tuple(p.shape)}")
        check(bool(torch.isfinite(k).all()), f"{label}: non-finite {name}")
        out[name] = compare(k, p, tol)
    ok = all(s["ok"] for s in out.values())
    log(f"[{tag}] {label}: {'pass' if ok else 'FAIL'} (tol rel_l2 "
        f"{tol.rel_l2:.0e}, |err| <= {tol.rtol:.2e}|ref| + {tol.atol:.2e} "
        f"mean|ref|)")
    for name, st in out.items():
        log(f"[{tag}]   {name}: {describe(st)}")
    check(ok == expect_ok, f"{label}: the check "
          f"{'failed' if expect_ok else 'passed a planted fault'}")
    return out


def planted_faults(inp, kernel, plain):
    """Faults planted in the forward kernel's output (or its D term) must
    fail the bf16 check at the main geometry: the check is not too loose
    to see one wrong 16x16 tensor-core tile."""
    from caduceus_tpu_torch.kernel_check import TOL

    y_k, h_k, c_k = kernel
    res = {}
    no_d, _ = run_pair(inp, False, D=torch.zeros_like(inp["D"]))
    t0 = 37 * 64 + 16                     # rows 16..31 of chunk 37
    faults = {"D term dropped": (no_d[0], h_k, c_k)}
    y = y_k.clone()
    y[1, t0:t0 + 16, 5, 48:64] = 0
    faults["one y tile (g1, h5, p48-63) zeroed"] = (y, h_k, c_k)
    y = y_k.clone()
    y[1, t0:t0 + 16, 5, 48:64] *= 1 + 2 ** -4
    faults["one y tile scaled by 1+2^-4"] = (y, h_k, c_k)
    h = h_k.clone()
    h[2, 3, 112:128, 48:64] = 0
    faults["one hN tile (g2, h3, n112-127, p48-63) zeroed"] = (y_k, h, c_k)
    for name, out in faults.items():
        res[name] = hold(f"planted fault: {name}", TOL[torch.bfloat16], out,
                         plain, expect_ok=False)
    return res


def phase_kernel_checks():
    from caduceus_tpu_torch.kernel_check import TOL

    results = []
    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        for NG in (1, 2):
            for reverse in (False, True):
                seed += 1
                inp = ssd_inputs(2, 200, 4, 32, NG, 32, 4, dtype, seed,
                                 width_pad=16 if reverse else 0)
                label = (f"fwd small G=2 L=200 H=4 P=32 NG={NG} N=32 "
                         f"{str(dtype)[6:]} rev={reverse}")
                results.append({"case": label, **hold(
                    label, TOL[dtype], *run_pair(inp, reverse))})
    faults = None
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        # columns 512.. of a 1288-wide in_proj output, as in the model
        inp = ssd_inputs(4, 8192, 8, 64, 1, 128, 4, dtype, seed,
                         width_pad=512)
        label = (f"fwd main G=4 L=8192 H=8 P=64 N=128 {str(dtype)[6:]} "
                 f"rev={reverse}")
        kernel, plain = run_pair(inp, reverse)
        results.append({"case": label, **hold(label, TOL[dtype], kernel,
                                              plain)})
        if faults is None:
            faults = planted_faults(inp, kernel, plain)
        del inp, kernel, plain
    return results, faults


def bwd_pair(inp, reverse):
    """The backward kernels and their plain version on the same inputs and
    the same carries (the forward kernel's): (kernel's eight gradients,
    plain version's, carries)."""
    from caduceus_tpu_torch.ops.ssd import ssd_chunked_fused_bwd
    from caduceus_tpu_torch.ops.ssd_batched import (
        KERNEL_CHUNK, ssd_fused_bwd, ssd_fused_fwd)

    T = KERNEL_CHUNK[inp["xBC"].dtype]
    args = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
            inp["D"], inp["dt_bias"])
    _, _, car = ssd_fused_fwd(*args, inp["dims"], True, reverse, T,
                              inp["h_init"], save_carries=True)
    kernel = ssd_fused_bwd(*args, inp["g_y"], car, inp["g_hN"], inp["dims"],
                           True, reverse, T)
    torch.cuda.synchronize()
    plain = ssd_chunked_fused_bwd(*args, inp["g_y"], car, inp["g_hN"],
                                  inp["dims"], True, reverse, T)
    return kernel, plain, car


def bwd_planted_faults(inp, kernel, plain):
    """Faults planted in the backward's outputs at the main geometry
    (bf16, forward direction) must fail the check."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops.conv import causal_conv1d
    from caduceus_tpu_torch.ops.ssd import ssd_adjoint_xc
    from caduceus_tpu_torch.ops.ssd_batched import KERNEL_CHUNK

    H, P, NG, N = inp["dims"]
    K = inp["conv_w"].shape[0]
    t0 = 37 * 64 + 16                     # rows 16..31 of chunk 37
    faults = {}
    # the conv transpose without its neighbour rows: g_xBC[j] = w[K-1]
    # g_pre[j] only, g_pre from the plain version's d loss / d silu(pre)
    g_xc = ssd_adjoint_xc(
        inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
        inp["D"], inp["dt_bias"], inp["g_y"], plain[-1], inp["g_hN"],
        inp["dims"], True, False, KERNEL_CHUNK[torch.bfloat16])[0]
    pre = causal_conv1d(inp["xBC"].float(), inp["conv_w"], inp["conv_b"],
                        activation=None)
    sig = torch.sigmoid(pre)
    own = inp["conv_w"][K - 1] * g_xc * sig * (1 + pre * (1 - sig))
    del g_xc, pre, sig
    faults["conv transpose: neighbour rows dropped"] = (
        (own.to(kernel[0].dtype),) + kernel[1:])
    del own
    g_dt = kernel[1].clone()
    g_dt[1, t0:t0 + 16, 5] = 0
    faults["one 16-row tile of g_dt (g1, h5) zeroed"] = (
        kernel[:1] + (g_dt,) + kernel[2:])
    faults["g_A scaled by 1+2^-4"] = (
        kernel[:2] + (kernel[2] * (1 + 2 ** -4),) + kernel[3:])
    g_x = kernel[0].clone()
    g_x[1, t0:t0 + 16, H * P + 16:H * P + 32] = 0
    faults["one 16x16 tile of g_xBC's B columns zeroed"] = (
        (g_x,) + kernel[1:])
    res = {}
    for name, out in faults.items():
        res[name] = hold(f"planted fault: {name}", TOL[torch.bfloat16],
                         out, plain[:-1], BWD_NAMES, expect_ok=False,
                         tag="bwd")
    return res


def phase_bwd_checks():
    from caduceus_tpu_torch.kernel_check import TOL

    results = []
    seed = 100
    for dtype in (torch.float32, torch.bfloat16):
        for NG in (1, 2):
            for reverse in (False, True):
                seed += 1
                inp = ssd_inputs(2, 200, 4, 32, NG, 32, 4, dtype, seed,
                                 width_pad=16 if reverse else 0)
                label = (f"bwd small G=2 L=200 H=4 P=32 NG={NG} N=32 "
                         f"{str(dtype)[6:]} rev={reverse}")
                kernel, plain, _ = bwd_pair(inp, reverse)
                results.append({"case": label, **hold(
                    label, TOL[dtype], kernel, plain, BWD_NAMES,
                    tag="bwd")})
    faults = None
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        inp = ssd_inputs(4, 8192, 8, 64, 1, 128, 4, dtype, seed,
                         width_pad=512)
        label = (f"bwd main G=4 L=8192 H=8 P=64 N=128 {str(dtype)[6:]} "
                 f"rev={reverse}")
        kernel, plain, car = bwd_pair(inp, reverse)
        results.append({"case": label, **hold(
            label, TOL[dtype], kernel, plain, BWD_NAMES, tag="bwd")})
        if faults is None:
            faults = bwd_planted_faults(inp, kernel, plain + (car,))
        del inp, kernel, plain, car
    return results, faults


def phase_model_vs_cpu():
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM

    cfg = hg38_mlm_v2_config(n_layer=2, dtype="float32")
    gen = torch.Generator().manual_seed(1234)
    cpu = CaduceusForMaskedLM(cfg, device="cpu", generator=gen)
    card = CaduceusForMaskedLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    ids = torch.randint(7, 11, (1, 2048), generator=gen)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu(ids)
        t_cpu = time.perf_counter() - t0
        got = card(ids.cuda())
        torch.cuda.synchronize()
    got = got.cpu()
    check(got.shape == ref.shape == (1, 2048, cfg.padded_vocab_size),
          f"model logits shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "model logits not finite")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel_l2 = ((got - ref).norm() / ref.norm()).item()
    check(err <= MODEL_TOL * scale,
          f"card vs CPU logits: {err:.3e} > {MODEL_TOL} x {scale:.3e}")
    log(f"[model] card vs CPU, full width, 2 layers, L=2048, fp32: max err "
        f"{err:.3e} (max|logit| {scale:.3e}, tol {MODEL_TOL} normalized), "
        f"rel_l2 {rel_l2:.2e}; CPU forward {t_cpu:.2f} s")
    return {"max_abs_err": err, "max_abs_ref": scale, "rel_l2": rel_l2}


def _post(port, path, obj, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_serve():
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.ops import ssd_batched
    from caduceus_tpu_torch.serve import InferenceServer, InferenceService

    cfg = hg38_mlm_v2_config()
    model = CaduceusForMaskedLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(2222))
    svc = InferenceService(cfg, model.state_dict(), device="cuda",
                           max_batch=4, min_bucket=1024, max_length=131072)
    del model
    server = InferenceServer(svc, port=0).start()
    rng = np.random.default_rng(7)

    def seqs(*lengths):
        return ["".join(rng.choice(list("ACGT"), n)) for n in lengths]

    plan = [
        ("/embed", seqs(1000)),
        ("/logits", seqs(900, 1024)),
        ("/embed", seqs(16384, 12000, 9000, 16000)),
        ("/logits", seqs(16384, 10000, 13000)),
        ("/logits", seqs(131072)),
    ]
    requests = []
    try:
        torch.cuda.reset_peak_memory_stats()
        d0 = svc.n_dispatches
        ssd_batched.launches = 0
        for path, batch in plan:
            t0 = time.perf_counter()
            out = _post(server.port, path, {"sequences": batch})[path[1:]]
            dt = time.perf_counter() - t0
            ntok = sum(map(len, batch))
            for s, o in zip(batch, out):
                a = np.asarray(o, np.float32)
                want = ((cfg.d_model,) if path == "/embed"
                        else (len(s), cfg.padded_vocab_size))
                check(a.shape == want, f"{path}: shape {a.shape} != {want}")
                check(bool(np.isfinite(a).all()), f"{path}: non-finite")
            requests.append({"path": path, "n_seq": len(batch),
                             "tokens": ntok, "latency_s": dt,
                             "tokens_per_s": ntok / dt})
            log(f"[serve] {path} {len(batch)} seq, {ntok} tokens: "
                f"{dt * 1e3:.1f} ms, {ntok / dt:,.0f} tokens/s")
            if path == "/logits" and len(batch) == 2:
                small = (batch, out)
        launches = ssd_batched.launches
        dispatches = svc.n_dispatches - d0
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.stop()
    per = 2 * cfg.n_layer
    log(f"[serve] ssd_fused_fwd launches {launches} over {dispatches} "
        f"dispatches (expect {per} each); peak memory "
        f"{peak / 2**30:.2f} GiB")
    check(dispatches == len(plan), f"{dispatches} dispatches for "
          f"{len(plan)} requests")
    check(launches == per * dispatches and launches > 0,
          f"kernel launches {launches} != {per} x {dispatches} dispatches")

    # the served logits are the model's own: rerun the 1024-bucket
    # dispatch directly (the server only pads and slices) ...
    batch, out = small
    tok = svc.tok
    ids = torch.full((2, 1024), tok.pad_token_id, dtype=torch.long)
    for i, s in enumerate(batch):
        ids[i, :len(s)] = torch.from_numpy(tok.encode(s).astype(np.int64))
    with torch.inference_mode():
        direct = svc.model(ids.cuda()).cpu().numpy()
    served = [np.asarray(o, np.float32) for o in out]
    for i, s in enumerate(batch):
        err = np.abs(served[i] - direct[i, :len(s)]).max()
        check(err <= 1e-6, f"served /logits differ from the model by {err}")
    # ... and agree with the fp32 model on the CPU (same weights): the
    # card computes in bf16 (8-bit mantissa) through 16 layers
    ref_model = CaduceusForMaskedLM(
        dataclasses.replace(cfg, dtype="float32"), device="cpu")
    ref_model.load_state_dict({k: v.cpu() for k, v in
                               svc.model.state_dict().items()})
    with torch.inference_mode():
        ref = ref_model(ids).numpy()
    err = max(np.abs(served[i] - ref[i, :len(s)]).max()
              for i, s in enumerate(batch))
    scale = max(np.abs(ref[i, :len(s)]).max() for i, s in enumerate(batch))
    diff = np.concatenate([(served[i] - ref[i, :len(s)]).ravel()
                           for i, s in enumerate(batch)])
    want = np.concatenate([ref[i, :len(s)].ravel()
                           for i, s in enumerate(batch)])
    rel_l2 = float(np.linalg.norm(diff) / np.linalg.norm(want))
    log(f"[serve] bf16 /logits on the card vs fp32 on the CPU (16 layers, "
        f"L=1024): max err {err:.3e}, max|logit| {scale:.3e} "
        f"(tol {BF16_MODEL_TOL} normalized), rel_l2 {rel_l2:.2e}")
    check(err <= BF16_MODEL_TOL * scale,
          f"served bf16 logits vs fp32 CPU: {err:.3e} > {BF16_MODEL_TOL} x "
          f"{scale:.3e}")
    # the 131k request without HTTP/JSON: one direct forward
    long_ids = torch.from_numpy(
        svc.tok.encode(plan[-1][1][0]).astype(np.int64))[None].cuda()
    with torch.inference_mode():
        svc.model(long_ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.model(long_ids)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    log(f"[serve] direct forward, 1 x 131072 tokens (no HTTP/JSON): "
        f"{fwd_s * 1e3:.1f} ms")
    return {"requests": requests, "launches": launches,
            "dispatches": dispatches, "peak_mem_bytes": peak,
            "forward_131k_s": fwd_s,
            "bf16_vs_fp32_cpu": {"max_abs_err": float(err),
                                 "max_abs_ref": float(scale),
                                 "rel_l2": rel_l2}}


def _counts():
    from caduceus_tpu_torch.ops import ssd_batched as sb

    return {"ssd_fused_fwd": sb.launches, "ssd_fused_bwd_kernel":
            sb.bwd_launches, "ssd_conv_bwd_kernel": sb.conv_bwd_launches}


def _zero_counts():
    from caduceus_tpu_torch.ops import ssd_batched as sb

    sb.launches = sb.bwd_launches = sb.conv_bwd_launches = 0


def _per_micro_batch(n_layer):
    """Launches of one micro-batch's forward + backward with remat span 1:
    each layer's two directions run forward twice (the remat recompute)
    and backward once."""
    return {"ssd_fused_fwd": 2 * n_layer * 2,
            "ssd_fused_bwd_kernel": 2 * n_layer,
            "ssd_conv_bwd_kernel": 2 * n_layer}


def phase_train_vs_cpu():
    """One step (accum 2) of the full-width model at 2 layers, L=2048, fp32,
    on the card and on the CPU from the same weights and batch."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.train.optim import (make_optimizer,
                                                weight_decay_mask)
    from caduceus_tpu_torch.train.trainer import TrainState, make_train_step

    cfg = hg38_mlm_v2_config(n_layer=2, dtype="float32")
    L, accum = 2048, 2
    cpu = CaduceusForMaskedLM(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(4321))
    card = CaduceusForMaskedLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(4322)
    ids = torch.randint(7, 11, (accum, L), generator=gen)
    tgt = torch.randint(0, 12, (accum, L), generator=gen)
    # warmup_t=0: step 0 runs at the full lr, so the update is not tiny
    opt_kw = dict(lr=8e-3, warmup_t=0, t_initial=50_000, weight_decay=0.1)
    p0 = {n: p.detach().double() for n, p in cpu.named_parameters()}
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
        opt, schedule = make_optimizer(model.named_parameters(), **opt_kw)
        state = TrainState(model, opt)
        step = make_train_step(accum_steps=accum)
        _zero_counts()
        t0 = time.perf_counter()
        state, m = step(state, {"input_ids": ids.to(dev),
                                "targets": tgt.to(dev)})
        if dev == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        m = {k: float(v) for k, v in m.items()}
        # .grad holds the clipped gradient the update was made from
        out[name] = (m, {n: p.grad.detach().cpu()
                         for n, p in model.named_parameters()},
                     {n: p.detach().cpu() for n, p in
                      model.named_parameters()}, secs, _counts())
    (m_c, g_c, p_c, s_c, _), (m_k, g_k, p_k, s_k, counts) = (out["cpu"],
                                                             out["card"])
    want = {k: v * accum for k, v in _per_micro_batch(cfg.n_layer).items()}
    check(counts == want, f"train step launches {counts} != {want}")
    for k in ("loss", "grad_norm"):
        check(math.isfinite(m_k[k]), f"card {k} not finite")
        rel = abs(m_k[k] - m_c[k]) / abs(m_c[k])
        check(rel <= TRAIN_TOL["metric"], f"card vs CPU {k}: {m_k[k]} vs "
              f"{m_c[k]} (rel {rel:.2e})")
    # the first AdamW update, in fp64 from the card's own clipped gradient:
    # p·(1 - lr·wd) - lr·g / (|g| + eps) (m̂ = g, √v̂ = |g| at step 1)
    lr, decay = schedule(0), weight_decay_mask(card.named_parameters())
    g_err = p_err = adam_err = 0.0
    worst, unsettled = "", {}
    for n in g_c:
        # the mean gradients before clipping, against the CPU's largest
        gc = g_c[n] * max(1.0, m_c["grad_norm"])
        gk = g_k[n] * max(1.0, m_k["grad_norm"])
        s = gc.abs().max().item() + 1e-30
        e = ((gk - gc).abs().max() / s).item()
        if e > g_err:
            g_err, worst = e, n
        scale = 1 + p0[n].abs()
        g = g_k[n].double()
        ref = (p0[n] * (1 - lr * opt_kw["weight_decay"] * decay[n])
               - lr * g / (g.abs() + 1e-8))
        a = ((p_k[n].double() - ref).abs() / scale).max().item()
        check(a <= TRAIN_TOL["param"], f"card's update of {n} vs AdamW from "
              f"its own gradient: {a:.2e}·(1+|p|)")
        adam_err = max(adam_err, a)
        # card vs CPU: strict where the gradient is well above 0; near 0
        # the sign of g decides Adam's first step, so there 2·lr
        settled = gc.abs() > TRAIN_TOL["settled"] * s
        unsettled[n] = (int((~settled).sum()), settled.numel())
        d = (p_k[n] - p_c[n]).abs()
        lim = torch.where(settled, TRAIN_TOL["param"] * scale.float(),
                          torch.full_like(d, 2 * lr))
        check(bool((d <= lim).all()), f"card vs CPU updated {n}: max "
              f"|diff| {d.max().item():.3e}")
        p_err = max(p_err, ((d / scale) * settled).max().item())
    check(g_err <= TRAIN_TOL["grad"], f"card vs CPU gradient {worst}: "
          f"{g_err:.2e} of its max > {TRAIN_TOL['grad']}")
    most = max(unsettled, key=lambda n: unsettled[n][0] / unsettled[n][1])
    log(f"[train] card vs CPU, full width, 2 layers, L=2048, fp32, accum 2: "
        f"loss {m_k['loss']:.6f} vs {m_c['loss']:.6f}, grad_norm "
        f"{m_k['grad_norm']:.6f} vs {m_c['grad_norm']:.6f}; worst gradient "
        f"{worst} {g_err:.2e} of its max (tol {TRAIN_TOL['grad']}); worst "
        f"updated parameter {p_err:.2e}·(1+|p|) where |g| > "
        f"{TRAIN_TOL['settled']}·max|g| (tol {TRAIN_TOL['param']}); held "
        f"only to 2·lr against the CPU: "
        f"{sum(u for u, _ in unsettled.values())} of "
        f"{sum(t for _, t in unsettled.values())} elements, at most "
        f"{unsettled[most][0]} of {unsettled[most][1]} in one leaf ({most}); "
        f"every element's update vs AdamW from the card's own gradient: "
        f"{adam_err:.2e}·(1+|p|) (tol {TRAIN_TOL['param']}); launches "
        f"{counts}; card step {s_k:.2f} s, CPU step {s_c:.2f} s")
    return {"loss": [m_k["loss"], m_c["loss"]],
            "grad_norm": [m_k["grad_norm"], m_c["grad_norm"]],
            "grad_err": g_err, "param_err": p_err, "adam_err": adam_err,
            "unsettled_share": unsettled, "launches": counts,
            "card_s": s_k, "cpu_s": s_c}


def phase_train_full():
    """The main path of this slice: `make_train_step` + `make_optimizer` on
    the full-width hg38_mlm_v2 model at L=131072, micro-batches of 2
    sequences (G=4 per SSD call), accum 2; one warm-up and 2 timed steps."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.train.optim import make_optimizer
    from caduceus_tpu_torch.train.trainer import TrainState, make_train_step

    cfg = hg38_mlm_v2_config()
    L, micro, accum, n_steps = 131072, 2, 2, 3
    model = CaduceusForMaskedLM(cfg, device="cuda",
                                generator=torch.Generator().manual_seed(2222))
    opt, _ = make_optimizer(model.named_parameters(), lr=8e-3, warmup_t=100,
                            t_initial=50_000)
    state = TrainState(model, opt)
    step = make_train_step(accum_steps=accum)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [{"input_ids": torch.randint(7, 11, (micro * accum, L),
                                           generator=gen, device="cuda"),
                "targets": torch.randint(0, 12, (micro * accum, L),
                                         generator=gen, device="cuda")}
               for _ in range(n_steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    steps = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        m = {k: float(v) for k, v in m.items()}
        steps.append({"step_s": secs, **m})
        log(f"[train] full width, 16 layers, L={L}, {micro} x {accum} "
            f"sequences: step {i} ({'warm-up' if i == 0 else 'timed'}) "
            f"{secs:.2f} s, loss {m['loss']:.5f}, grad_norm "
            f"{m['grad_norm']:.4f}, acc {m['acc']:.4f}")
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"step {i}: loss {m['loss']}, grad_norm {m['grad_norm']}")
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    n_mb = n_steps * accum
    want = {k: v * n_mb for k, v in _per_micro_batch(cfg.n_layer).items()}
    check(counts == want, f"training launches {counts} != {want} "
          f"({n_mb} micro-batches)")
    timed = [s["step_s"] for s in steps[1:]]
    step_s = float(np.mean(timed))
    tokens = micro * accum * L
    log(f"[train] timed steps {', '.join(f'{t:.2f}' for t in timed)} s: "
        f"{step_s:.2f} s/step, {tokens / step_s:,.0f} tokens/s; peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {counts} over {n_mb} "
        f"micro-batches (= {_per_micro_batch(cfg.n_layer)} each)")
    return {"steps": steps, "step_s": step_s, "tokens_per_step": tokens,
            "tokens_per_s": tokens / step_s, "peak_mem_bytes": peak,
            "launches": counts, "micro_batches": n_mb, "accum": accum}


def _time_cuda(fn, n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _bound(nbytes, flops, flop_per_s=BF16_FLOP_PER_S):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flop_per_s * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _timed(kernel_fn, plain_fn, n_kernel=3):
    """Kernel and plain version in turns (plain, kernel, kernel, plain)."""
    plain_ms = [_time_cuda(plain_fn, 1)]
    kernel_ms = [_time_cuda(kernel_fn, n_kernel), _time_cuda(kernel_fn,
                                                             n_kernel)]
    plain_ms.append(_time_cuda(plain_fn, 1))
    return {"ms": float(np.mean(kernel_ms)), "kernel_ms_runs": kernel_ms,
            "plain_ms": float(np.mean(plain_ms)), "plain_ms_runs": plain_ms}


def phase_timing():
    """The forward kernel at the serving batch (G=16: 8 sequences x 2
    strands, L=131072, bf16, no carries) and every kernel at the training
    shape (G=4, L=131072, bf16, forward direction), each beside its plain
    version and its bound; the timed outputs held against the plain
    versions'."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops import ssd as plain
    from caduceus_tpu_torch.ops.ssd_batched import (
        KERNEL_CHUNK, conv_silu_bwd, ssd_adjoint_xc, ssd_batched_fused,
        ssd_fused_fwd)

    L, H, P, NG, N, K = 131072, 8, 64, 1, 128, 4
    T = KERNEL_CHUNK[torch.bfloat16]
    Wc = H * P + 2 * NG * N
    bf16 = TOL[torch.bfloat16]
    res = {}

    # -- forward, serving batch G=16, no carries
    G = 16
    inp = ssd_inputs(G, L, H, P, NG, N, K, torch.bfloat16, 99, width_pad=512)
    args = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"])
    kw = dict(conv_b=inp["conv_b"], D=inp["D"], dt_bias=inp["dt_bias"],
              dims=inp["dims"], dt_softplus=True, return_final_state=True)
    outs = {}
    t = _timed(lambda: outs.__setitem__("k", ssd_batched_fused(*args, **kw)),
               lambda: outs.__setitem__("p", plain.ssd_chunked_fused(
                   *args, chunk_size=T, **kw)), n_kernel=5)
    one = (inp["xBC"][:2], inp["dt"][:2]) + args[2:]
    t["ms_G2"] = _time_cuda(lambda: outs.__setitem__(
        "k2", ssd_batched_fused(*one, **kw)), 3)
    y_p, h_p = outs.pop("p")
    t["checks"] = {
        "G=16": hold(f"timed fwd G=16 L={L} bf16", bf16, outs.pop("k"),
                     (y_p, h_p), ("y", "hN")),
        "G=2": hold(f"timed fwd G=2 L={L} bf16 (one 131k request)", bf16,
                    outs.pop("k2"), (y_p[:2], h_p[:2]), ("y", "hN"))}
    rows = G * L
    # each input read once, each output written once (bf16 = 2 bytes); the
    # fp32 parameters and hN are < 1 MB. Matmul work the function needs
    # (no per-head recompute of CB): CB per group, M@dx, C@h, B^T@wdx
    t.update(_bound(rows * (Wc + H) * 2 + rows * H * P * 2
                    + G * H * N * P * 4,
                    rows * (2 * T * N * NG + 2 * T * P * H + 4 * N * P * H)))
    res["fwd_G16"] = t
    log(f"[time] ssd_fused_fwd G=16 L={L} bf16: kernel {t['ms']:.3f} ms "
        f"(runs {', '.join(f'{v:.3f}' for v in t['kernel_ms_runs'])}), "
        f"plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}); at G=2 (one 131k request) {t['ms_G2']:.3f} ms")
    del inp, args, one, y_p, h_p, outs

    # -- the training shape: G=4 (2 sequences x 2 strands)
    G = 4
    rows = G * L
    nc = -(-L // T)
    inp = ssd_inputs(G, L, H, P, NG, N, K, torch.bfloat16, 98, width_pad=512)
    a7 = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
          inp["D"], inp["dt_bias"])
    outs = {}
    t = _timed(lambda: outs.__setitem__("k", ssd_fused_fwd(
                   *a7, inp["dims"], True, False, T, None, save_carries=True)),
               lambda: outs.__setitem__("p", plain.ssd_chunked_fused(
                   *a7, dims=inp["dims"], dt_softplus=True, chunk_size=T,
                   return_carries=True)))
    fwd_k, fwd_p = outs.pop("k"), outs.pop("p")
    t["check"] = hold(f"timed fwd + carries G=4 L={L} bf16", bf16, fwd_k,
                      fwd_p)
    car_bytes = G * nc * H * N * P * 2
    t.update(_bound(rows * (Wc + H) * 2 + rows * H * P * 2
                    + G * H * N * P * 4 + car_bytes,
                    rows * (2 * T * N * NG + 2 * T * P * H + 4 * N * P * H)))
    res["fwd_G4_carries"] = t
    log(f"[time] ssd_fused_fwd + carries G=4 L={L} bf16: kernel "
        f"{t['ms']:.3f} ms, plain {t['plain_ms']:.1f} ms, bound "
        f"{t['bound_ms']:.3f} ms ({t['bound_by']}: {t['bytes'] / 1e9:.2f} GB)")
    car = fwd_k[2]
    del fwd_k, fwd_p
    bwd_args = a7 + (inp["g_y"], car, None, inp["dims"], True, False, T)

    t = _timed(lambda: outs.__setitem__("k", ssd_adjoint_xc(*bwd_args)),
               lambda: outs.__setitem__("p", plain.ssd_adjoint_xc(*bwd_args)))
    adj_k, adj_p = outs.pop("k"), outs.pop("p")
    t["check"] = hold(
        f"timed ssd_fused_bwd_kernel G=4 L={L} bf16", TOL[torch.bfloat16],
        adj_k, adj_p, ("g_xc", "g_dt", "g_A", "g_D", "g_dt_bias", "g_h0"),
        tag="bwd")
    # The two kernels' bounds split the backward function's own bound
    # (each input read once, each output written once): this kernel takes
    # the reads of xBC, dt, g_y and the carries and the write of g_dt, and
    # all the matmul work: CB, LG@B, LG^T@C once per group, G, gdx
    # (T x T x P) and six N x P products (B@lambda, C@h, B^T@wdx, gye@h^T,
    # wdx@lambda^T, C^T@gye) per head. The fp32 (G, L, Wc) workspace
    # between the two kernels is a cost of the split design, not of the
    # function: it stands beside the bound as `extra_bytes`.
    t.update(_bound(rows * (Wc * 2 + H * 2 + H * P * 2 + H * 2) + car_bytes,
                    rows * (6 * T * N * NG + H * (4 * T * P + 12 * N * P))))
    t["extra_bytes"] = rows * Wc * 4
    res["bwd_main"] = t
    log(f"[time] ssd_fused_bwd_kernel G=4 L={L} bf16: kernel {t['ms']:.3f} "
        f"ms, plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}: {t['bytes'] / 1e9:.2f} GB, "
        f"{t['flops'] / 1e12:.2f} TFLOP; workspace write "
        f"{t['extra_bytes'] / 1e9:.2f} GB on top)")

    g_xc = adj_k[0]
    conv_args = (g_xc, inp["xBC"], inp["conv_w"], inp["conv_b"], False)
    t = _timed(lambda: outs.__setitem__("k", conv_silu_bwd(*conv_args)),
               lambda: outs.__setitem__("p", plain.conv_silu_bwd(*conv_args)))
    conv_k, conv_p = outs.pop("k"), outs.pop("p")
    t["check"] = hold(
        f"timed ssd_conv_bwd_kernel G=4 L={L} bf16 (the kernel's g_xc)",
        TOL[torch.bfloat16], conv_k, conv_p,
        ("g_xBC", "g_conv_w", "g_conv_b"), tag="bwd")
    # its share of the function's bound: the write of g_xBC, and the
    # elementwise fp32 work (conv recompute, SiLU adjoint, conv transpose,
    # g_w / g_b: ~6K + 8 operations per element) on the non-tensor-core
    # fp32 units; on top, the split design reads the workspace and xBC a
    # second time
    t.update(_bound(rows * Wc * 2, rows * Wc * (6 * K + 8), FP32_FLOP_PER_S))
    t["extra_bytes"] = rows * Wc * (4 + 2)
    res["bwd_conv"] = t
    log(f"[time] ssd_conv_bwd_kernel G=4 L={L} bf16: kernel {t['ms']:.3f} "
        f"ms, plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}; workspace and xBC reads "
        f"{t['extra_bytes'] / 1e9:.2f} GB on top)")
    # the whole backward against the plain version end to end
    whole_p = plain.conv_silu_bwd(adj_p[0], inp["xBC"], inp["conv_w"],
                                  inp["conv_b"], False)
    pick = lambda c, a: (c[0], a[1], a[2], c[1], c[2], a[3], a[4], a[5])
    res["bwd_whole"] = hold(f"timed ssd_fused_bwd (both kernels) G=4 L={L}",
                            TOL[torch.bfloat16], pick(conv_k, adj_k),
                            pick(whole_p, adj_p), BWD_NAMES, tag="bwd")
    # the function's own bound: reads xBC, dt, g_y, carries; writes g_xBC,
    # g_dt; and the pair's time against it
    res["bwd_function_bound"] = _bound(
        rows * (Wc * 2 + H * 2 + H * P * 2 + Wc * 2 + H * 2) + car_bytes,
        rows * (6 * T * N * NG + H * (4 * T * P + 12 * N * P)))
    pair_ms = res["bwd_main"]["ms"] + res["bwd_conv"]["ms"]
    log(f"[time] ssd_fused_bwd, both kernels: {pair_ms:.3f} ms, bound of "
        f"the function {res['bwd_function_bound']['bound_ms']:.3f} ms "
        f"({res['bwd_function_bound']['bytes'] / 1e9:.2f} GB), sum of the "
        f"kernels' bounds {res['bwd_main']['bound_ms'] + res['bwd_conv']['bound_ms']:.3f} ms")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    import caduceus_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; nvidia-smi: {card}")
    report = {"build": phase_build()}
    phases = time.perf_counter()
    report["ssd_checks"], report["planted_faults"] = phase_kernel_checks()
    report["bwd_checks"], report["bwd_planted_faults"] = phase_bwd_checks()
    report["model_vs_cpu"] = phase_model_vs_cpu()
    report["serve"] = phase_serve()
    report["train_vs_cpu"] = phase_train_vs_cpu()
    report["train"] = phase_train_full()
    report["timing"] = phase_timing()
    report["phase_s"] = time.perf_counter() - phases
    tm, tr = report["timing"], report["train"]
    # share of the training step inside the kernels (derived: per-launch
    # times at the same shape x launches per step)
    per_step = {k: v // tr["micro_batches"] * tr["accum"] for k, v in
                tr["launches"].items()}
    ms = {"ssd_fused_fwd": tm["fwd_G4_carries"]["ms"],
          "ssd_fused_bwd_kernel": tm["bwd_main"]["ms"],
          "ssd_conv_bwd_kernel": tm["bwd_conv"]["ms"]}
    tr["kernel_s_per_step"] = {k: per_step[k] * ms[k] / 1e3 for k in ms}
    tr["kernel_share"] = sum(tr["kernel_s_per_step"].values()) / tr["step_s"]
    log(f"[train] derived: kernels take {tr['kernel_share']:.1%} of the step "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in tr['kernel_s_per_step'].items())})")

    def entry(name, source, t, launches, err, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": "caduceus_tpu/ops/ssd_pallas_batched.py:"
                            + ("173" if name == "ssd_fused_fwd" else "486"),
                "launches": launches, "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "check": "pass", **extra}

    f16 = tm["fwd_G16"]
    # the backward's two kernels split its bound; the workspace traffic of
    # the split stands beside it
    pair = {"function_bound_ms": tm["bwd_function_bound"]["bound_ms"]}
    kernels = {"kernels": [
        entry("ssd_fused_fwd", "caduceus_tpu_torch/csrc/ssd_fused_fwd.cu",
              tm["fwd_G4_carries"], tr["launches"]["ssd_fused_fwd"],
              tm["fwd_G4_carries"]["check"]["y"]["max_abs_err"],
              shape="G=4 L=131072 bf16, carries saved",
              launches_serve=report["serve"]["launches"],
              serve_G16={k: f16[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")}),
        entry("ssd_fused_bwd_kernel", "caduceus_tpu_torch/csrc/ssd_fused_bwd.cu",
              tm["bwd_main"], tr["launches"]["ssd_fused_bwd_kernel"],
              tm["bwd_main"]["check"]["g_xc"]["max_abs_err"],
              shape="G=4 L=131072 bf16",
              extra_bytes=tm["bwd_main"]["extra_bytes"], **pair),
        entry("ssd_conv_bwd_kernel", "caduceus_tpu_torch/csrc/ssd_fused_bwd.cu",
              tm["bwd_conv"], tr["launches"]["ssd_conv_bwd_kernel"],
              tm["bwd_conv"]["check"]["g_xBC"]["max_abs_err"],
              shape="G=4 L=131072 bf16",
              extra_bytes=tm["bwd_conv"]["extra_bytes"], **pair),
    ]}
    report.update(kernels)
    report["card"] = card
    report["seconds"] = time.perf_counter() - t_start
    log("[report] " + json.dumps(report))
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
