#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100: kernels, server, training,
generation.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc). It imports nothing of JAX or of `caduceus_tpu`. Phases, in
order (any failure exits non-zero; nothing is caught and passed over):

1. build the kernels from `caduceus_tpu_torch/csrc` (nvcc, sm_90a; one
   nvcc per source, side by side): `ssd_fused_fwd.cu` (entry points
   `ssd_fused_fwd` and `ssd_fwd`: prep, segment pre-pass and main pass)
   and `ssd_fused_bwd.cu` (`ssd_fused_bwd` / `ssd_bwd`: prep, pre-pass,
   main pass, head-order g_B / g_C sum; `ssd_conv_bwd`: the streaming
   SiLU + conv adjoint and its fixed-order weight sum), the two scan
   sources and five planted-fault variants (three of the scan kernels, two
   of the conv adjoint); print build times, every compiled kernel's
   registers, spills and static shared memory, and each SSD sub-launch's
   dynamic shared memory;
2. hold the forward kernel (y, hN and the chunk carries) against its
   plain PyTorch version (`ops/ssd.py ssd_chunked_fused`) on the card:
   small shapes (fp32 and bf16, both directions, nonzero h_init, L not a
   multiple of the chunk, ngroups 1 and 2) and the main-path geometry
   (H=8, P=64, N=128, K=4, Wc=768, G=4, L=8192: 4 segments of 32
   chunks), by the rule of `caduceus_tpu_torch/kernel_check.py`; faults
   planted in its output at the main geometry (D term dropped, one 16x16
   tile of y or hN wrong, and, in each scan direction, one segment's
   incoming state dropped in the kernels' combine) must fail that check;
3. the same for the backward kernels (`ssd_fused_bwd`: all eight
   gradients against `ssd_chunked_fused_bwd`, nonzero h_init and g_hN),
   each kernel also alone against its own plain version, and four faults
   planted in the backward's outputs at the main geometry (the conv
   transpose's neighbour rows dropped, one 16-row tile of g_dt zeroed,
   g_A scaled by 1+2^-4, one 16x16 tile of g_xBC's B columns zeroed, and
   in each direction one segment's incoming lambda dropped); then the SiLU
   + conv adjoint `ssd_conv_bwd` (#3b) alone against `ops/ssd.py
   conv_silu_bwd`: small shapes (fp32 and bf16, both directions, K 1-4,
   L=4099 over five 1,024-row tiles, Wc 388, and Wc 203 as a column view
   at an odd offset) and the main geometry (G=4, L=8192, Wc=768), with the
   halo of every row tile dropped (the g_pre rows past it, the raw rows
   before it: `CONV_DROP` variant builds) failing the check;
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
7. train the full-width `hg38_mlm_v2` model (8 layers, remat span 1,
   bf16 over fp32 params) at L=131072: micro-batches of 2 sequences
   (G=4 per SSD call), accum 2, AdamW as `bench.py`; one warm-up step
   and 2 timed steps, finite loss and grad norm, and the launch counts
   pinned per micro-batch;
8. time the kernels at the training shape (G=4, L=131072, bf16) and the
   forward also at G=16 (`bench.py`'s batch of 8 x 2 strands) beside
   their plain versions and bounds, each SSD sub-launch alone beside its
   bytes, #3b also beside the floor of its own traffic and the two PyTorch
   calls that compute its function (`silu_backward` then
   `convolution_backward`, held to the plain version first), and hold the
   timed outputs against the plain versions'; then
   run #1 + #3, #2 + #4 and the v1 scan kernels (#9 + #8 in both
   directions, #7 + #8 with h_init and g_hN, #10) twice on the same inputs
   at the training shape and require every output bit for bit the same;

then the v1 (Mamba-1) model of `configs/hg38_mlm.yaml` and its selective
scan kernels, `selective_scan_fwd.cu` (`selective_scan_fwd`, one
direction; `bidir_scan_fwd`, two) and `selective_scan_bwd.cu`:

9. the forward kernels against the plain forward (`ops/selective_scan.py
   selective_scan`): small shapes (fp32 and bf16, both directions,
   nonzero h_init, L = 200 and 600: one partial 256-row chunk, and two
   and a partial one, with and without D and bias, both entry points, the
   SiLU(z) gate) and the main geometry (d=512, N=16, G=4, L=8192: y, hN,
   carries; gated too), then planted faults that must fail (D term
   dropped, one 16-row x 16-channel y tile zeroed, the reverse set run
   with the forward set's A, and in each scan direction one run's
   incoming state dropped);
10. the backward kernels against `selective_scan_bwd`, all eight outputs,
   nonzero g_hN, small and main geometry, and planted faults (g_A scaled
   by 1+2^-4, one 16x16 tile of g_delta zeroed, the softplus chain
   dropped from g_delta, one cluster's g_B share left out, and in each
   scan direction one run's incoming lam dropped);
11. the 2-layer full-width v1 model, card vs CPU (as 4);
12. serve the full-width 16-layer v1 model: /embed and /logits at bucket
   1024 and one 131,072-token /logits, 16 `bidir_scan_fwd` launches per
   dispatch, served logits equal to a direct forward;
13. the 2-layer v1 train step, card vs CPU (as 6);
14. one accum-2 step of a 2-layer unidirectional v1 model (`MambaMixer`,
   L=8192), which runs `selective_scan_fwd`;
15. train the full-width v1 model as 7: 32 `bidir_scan_fwd` and 32
   `selective_scan_bwd` launches per micro-batch;
16. time the three scan kernels at the training shape beside their plain
   versions, bounds and exp counts, #7 also at the v1 prefill's shape
   (G=1, fp32) and with the SiLU(z) gate, and #8's main pass and g_B /
   g_C share sum each alone beside their bytes, holding the timed
   outputs;

and generation, for the causal models of `cli.py pretrain --model mamba`
(v2: after phase 8, through the unfused SSD forward `ssd_fwd`, TPU kernel
#2, the K = 0 instantiation of `ssd_fused_fwd.cu`; v1: after phase 16,
through `selective_scan_fwd`, #7, chained from the cache):

17. `ssd_fwd` against its plain version (`ops/ssd.py ssd_chunked`): small
   shapes (fp32 and bf16, both directions, nonzero h_init, L not a
   multiple of the chunk, ngroups 1 and 2, x/B/C and dt as strided column
   views) and the main geometry (H=8, P=64, N=128, G=4, L=8192: y, hN,
   carries); planted faults that must fail (D dropped, one 16x16 y tile
   zeroed, h_init ignored);
18. (v2, then v1 after 16) the full-width causal model at 2 layers, fp32:
   `prefill` on the card against the CPU (logits and every cache entry),
   two chained prefills (split inside a chunk and before d_conv rows)
   against one, greedy `generate` of 32 tokens against the CPU's tokens
   and the argmax of the card's full forward;
19. the full-width 16-layer causal model over HTTP: /generate with prompts
   of 1,000 and 131,072 tokens and 64 new tokens; the prefill launches
   its scan kernel 16 times per request and decoding none; a bf16
   prefill's last logits against the full forward's last position
   (BF16_MODEL_TOL); prefill tokens/s at 131,072, decode ms per token at
   batch 1 and 8, /generate latency, each beside its bound; the 131,072
   prefill and /generate timed again with the scan in bf16 (the rule
   before the bf16 prefill scanned in fp32, as the JAX prefill does);
20. `ssd_fwd` per call at G=1 and G=4, L=131072, bf16, and at G=1 in
   fp32 (the prefill's scan dtype), beside its plain version and bound;

and, after 16, the last four TPU kernels: the unfused SSD adjoint `ssd_bwd`
(the K = 0 instantiation of `ssd_fused_bwd.cu`'s SSD adjoint; #4 behind
`ops/ssd_batched.py ssd_batched_chained`, #6 behind `ops/ssd_head.py`), the
per-head route of ``use_kernel: pallas`` (#5 / #6), and the paired scan
adjoint `bidir_scan_bwd` (#10):

21. `ssd_bwd` against `ssd_chunked_bwd`, all eight gradients: small shapes
   (fp32 and bf16, both directions, ngroups 1 and 2, strided column views,
   nonzero h_init and g_hN, L not a multiple of the chunk) and the main
   geometry; planted faults that must fail (g_h0 left at zero, g_A x
   (1+2^-4), a 16-row tile of g_dt zeroed, a 16x16 tile of g_B zeroed);
22. two chained `ssd_batched_chained` calls (split inside a chunk) against
   one call under autograd: y, hN and every gradient, g_h0 among them;
23. the 2-layer full-width `use_kernel: pallas` model, card vs CPU (as 4),
   and its train step (as 6), 32 + 16 per-head launches per micro-batch;
24. that model at 8 layers trained at L=131072 (as 7): 32 `ssd_head_fwd`
   and 16 `ssd_head_bwd` launches per micro-batch, no fused kernel;
25. the 16-layer `use_kernel: pallas` model served: a 131,072-token /logits,
   32 `ssd_head_fwd` launches per dispatch, logits equal a direct forward;
26. the 2-layer causal `use_kernel: pallas` model's prefill, card vs CPU
   (as 18), through `ssd_head_fwd`;
27. `bidir_scan_bwd` against the two-launch backward and the plain adjoints,
   small shapes and d=512, N=16, G=4, L=8192; planted faults (the reverse
   set given the forward set's g_y, a 16-channel tile of g_u zeroed);
28. with CADUCEUS_BIDIR_BWD=1: the 2-layer v1 train step card vs CPU, and
   the full-width 16-layer v1 model trained at L=131072 (as 15) with 16
   `bidir_scan_bwd` and no `selective_scan_bwd` launches per micro-batch;
29. `ssd_head_fwd`, `ssd_bwd` / `ssd_head_bwd` and `bidir_scan_bwd` at the
   training shape (G=4, L=131072, bf16) beside their plain versions and
   bounds, holding the timed outputs.

and, last, pretraining through the port's own loop (`cli.py pretrain`: the
hg38 loader, `Trainer`, checkpoints) on a synthetic genome of 2 contigs of
2^23 bases in 2^20-base windows, written into a temporary directory:

30. the Python and the native loader (built from `native/dataloader.cc`
   with g++) timed per batch of 4 x 131,072 tokens; whether `tensorstore`
   and `yaml` import here;
31. the bare 16-layer `make_train_step` at the loop's geometry (as 7);
32. `hg38_mlm_v2` at 16 layers, L=131072, 4 sequences in 2 micro-batches,
   4 steps, EMA, a checkpoint every 2 steps, an eval at step 4: run A
   through `cli.main` in this process (its launches counted: the loop runs
   the kernels of 7 and the eval's forwards), run B with the native loader
   in a subprocess, SIGKILLed once its step-2 checkpoint is in place and
   run again with ``--resume``; B's logged loss, acc, grad_norm and lr at
   every step, its eval and its final parameters and EMA must equal A's
   bit for bit; the loop's step against the bare step;
33. `cli.py eval` of run A's test split (finite), and run A, which holds
   only checkpoints, served: a 1,024-token /logits equal to a direct
   forward of the checkpoint's EMA weights;
34. 32 for the v1 model at 4 layers.

Prints every measurement as one `[report]` JSON line, then a `kernels`
JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from unittest import mock

import numpy as np
import torch

MODEL_TOL = 1e-3       # card vs CPU logits, fp32, 2 layers, normalized
# card vs CPU training step, fp32, 2 layers (both sides sum in other
# orders): loss and grad norm relative; each gradient against its largest
# element; each updated parameter in units of (1 + |p|) where the gradient
# is above `settled` x its largest and above `adam_floor` (Adam's first
# step is lr·g/(|g| + eps), eps = 1e-8: at a gradient near 0 its sign
# decides, and within 100 eps of 0 its size turns on the last digits of g,
# so there the bound is 2·lr), and every updated parameter, in the same
# units, against AdamW's first step computed in fp64 from the card's own
# gradient
TRAIN_TOL = {"metric": 1e-5, "grad": 1e-4, "param": 1e-6, "settled": 1e-3,
             "adam_floor": 1e-6}
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


def hg38_mlm_v2_config(n_layer: int = 16, dtype: str = "bfloat16",
                       use_kernel: str = "auto"):
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
                          ssd_seg_chunks=8, use_kernel=use_kernel))


def hg38_mlm_v2_pallas_config(n_layer: int = 16, dtype: str = "bfloat16"):
    """The same model with ``ssm_cfg.use_kernel = "pallas"``: the per-head
    route (conv + SiLU as a PyTorch op, then `ops/ssd_head.py ssd_head`:
    TPU kernels #5 / #6)."""
    return hg38_mlm_v2_config(n_layer, dtype, use_kernel="pallas")


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


_KERNEL_NAMES = ("ssd_prep_kernel", "ssd_fwd_state_kernel", "ssd_fwd_kernel",
                 "ssd_bwd_state_kernel", "ssd_fused_bwd_kernel",
                 "ssd_share_sum_kernel", "ssd_conv_bwd_kernel",
                 "ssd_conv_wsum_kernel", "selective_scan_fwd_kernel",
                 "selective_scan_bwd_kernel", "bc_share_sum_kernel")


def _instantiation(mangled: str) -> str:
    """A readable name of one compiled kernel: its name, storage type,
    conv width K and scan direction (SSD), or d_state N, gate and warps per
    block (scan), from the mangled symbol."""
    import re

    name = next((k for k in _KERNEL_NAMES if k in mangled), mangled)
    tail = mangled.split(name, 1)[-1]
    args = []
    if "bfloat16" in tail:
        args.append("bf16")
    elif re.match(r"I(Li\d+E)?f", tail):
        args.append("fp32")
    ints = re.findall(r"Li(\d+)E", tail)
    if ints:
        args.append(f"{'K' if name.startswith('ssd') else 'N'}={ints[0]}")
    if name == "selective_scan_fwd_kernel" and len(ints) > 1:
        args.append(f"{ints[1]} warps")
    if "Lb1E" in tail:
        args.append("reverse" if name.startswith("ssd") else "gated")
    return f"{name}<{', '.join(args)}>" if args else name


# the scan kernels' planted faults: variant libraries of the same sources
# built with these defines (`csrc/scan_common.cuh` SCAN_DROP)
DROP_RUN = ("SCAN_DROP=1",)     # one run's incoming state / lam zeroed
DROP_SHARE = ("SCAN_DROP=2",)   # one cluster's g_B share left out
# the conv adjoint's (`csrc/ssd_fused_bwd.cu` CONV_DROP): a row tile's halo
CONV_DROP_AFTER = ("CONV_DROP=1",)   # the g_pre rows past each tile zero
CONV_DROP_BEFORE = ("CONV_DROP=2",)  # the raw rows before each tile zero
FAULT_BUILDS = (("selective_scan_fwd", DROP_RUN),
                ("selective_scan_bwd", DROP_RUN),
                ("selective_scan_bwd", DROP_SHARE),
                ("ssd_fused_bwd", CONV_DROP_AFTER),
                ("ssd_fused_bwd", CONV_DROP_BEFORE))


def _variant(module, defines):
    """While open, the wrappers of ``module`` launch the variant library
    built with ``defines`` (a planted fault) instead of the shipped one."""
    real = module._fn
    return mock.patch.object(module, "_fn", lambda name: real(name, defines))


def scan_fault(defines):
    """`_variant` of the scan wrappers (`csrc/scan_common.cuh` SCAN_DROP)."""
    from caduceus_tpu_torch.ops import scan

    return _variant(scan, defines)


def phase_build():
    """nvcc of the four sources and of the five planted-fault variants
    (three of the scan kernels, two of the conv adjoint) side by side; then
    every compiled kernel's registers, static shared memory and spills
    (`-Xptxas -v`), and the dynamic shared memory each SSD sub-launch asks
    for at the main geometry (P=64, N=128) and K = 4 and 0."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from caduceus_tpu_torch import _build

    names = ("ssd_fused_fwd", "ssd_fused_bwd", "selective_scan_fwd",
             "selective_scan_bwd")
    builds = [(n, ()) for n in names] + list(FAULT_BUILDS)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        done = list(pool.map(lambda b: _build.build(*b), builds))
    wall = time.perf_counter() - t0
    built = dict(zip(names, done))
    out = {"nvcc_flags": list(_build.NVCC_FLAGS), "wall_s": wall,
           "ptxas": {}, "dynamic_smem": {}}
    for name, (path, secs) in built.items():
        log(f"[build] {name}: {secs:.1f} s -> {os.path.relpath(path)}")
        out[f"{name}_s"] = secs
        with open(path[:-3] + ".log") as f:
            report = f.read().split("Compiling entry function")
        for entry in report[1:]:
            head = entry.split("\n", 1)[0].strip(" '")
            kernel = _instantiation(head)
            used = [ln.strip() for ln in entry.splitlines()
                    if "registers" in ln or "spill" in ln]
            out["ptxas"][kernel] = used
            log(f"[build]   {kernel}: {'; '.join(used)}")
        if name.startswith("ssd"):
            fn = getattr(ctypes.CDLL(path), f"{name}_smem")
            fn.restype = ctypes.c_longlong
            fn.argtypes = [ctypes.c_int] * 5
            for dtype, dname in ((1, "bf16"), (0, "fp32")):
                for K in (4, 0):
                    sizes = {part: fn(dtype, K, 64, 128, i) for i, part in
                             enumerate(("prep", "pre-pass", "main pass"))}
                    if name == "ssd_fused_bwd" and K:
                        sizes["conv adjoint block"] = fn(dtype, K, 64, 128, 3)
                    out["dynamic_smem"][f"{name} {dname} K={K}"] = sizes
                    log(f"[build]   {name} {dname} K={K} dynamic shared "
                        f"memory (P=64, N=128): " + ", ".join(
                            f"{k} {v:,} B" for k, v in sizes.items()))
    for (name, defines), (path, secs) in zip(FAULT_BUILDS, done[len(names):]):
        log(f"[build] {name} -D{' -D'.join(defines)} (planted fault): "
            f"{secs:.1f} s -> {os.path.relpath(path)}")
    log(f"[build] {len(builds)} libraries in {wall:.1f} s wall")
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


def _second_segment(S, reverse):
    """The array index of the segment the scan passes second: dropping its
    pre-pass output hands the third segment a zero incoming state."""
    check(S >= 3, f"{S} segments: the segment faults need 3 or more")
    return S - 2 if reverse else 1


def drop_segment_fwd(inp, reverse):
    """The forward kernels (y, hN, carries) with one segment's incoming
    state dropped: after the prep and the pre-pass, the state of the
    segment the scan passes second is set to 0 and its sum of a to -inf, so
    the combine hands the next segment a zero state."""
    from caduceus_tpu_torch.ops import ssd_batched as sb

    T = sb.KERNEL_CHUNK[inp["xBC"].dtype]
    a = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
         inp["D"], inp["dt_bias"], inp["dims"], True, reverse, T,
         inp["h_init"], True)
    ws = sb.fused_fwd_call(*a, parts=sb.PART_PREP | sb.PART_STATE)[3]
    j = _second_segment(ws["S"], reverse)
    ws["seg"][:, :, j] = 0
    ws["seg_a"][:, :, j] = -math.inf
    return sb.fused_fwd_call(*a, parts=sb.PART_MAIN, ws=ws)[:3]


def drop_segment_bwd(inp, reverse, car):
    """The backward kernels' eight gradients with one segment's incoming
    lambda dropped (as `drop_segment_fwd`, on the adjoint's pre-pass)."""
    from caduceus_tpu_torch.ops import ssd_batched as sb

    T = sb.KERNEL_CHUNK[inp["xBC"].dtype]
    a = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
         inp["D"], inp["dt_bias"], inp["g_y"], car, inp["g_hN"], inp["dims"],
         True, reverse, T)
    ws = sb.adjoint_xc_call(*a, parts=sb.PART_PREP | sb.PART_STATE)[1]
    j = _second_segment(ws["S"], not reverse)
    ws["seg"][:, :, j] = 0
    ws["seg_a"][:, :, j] = -math.inf
    (g_xc, g_dt, g_A, g_D, g_bias, g_h0), _ = sb.adjoint_xc_call(
        *a, parts=sb.PART_MAIN | sb.PART_SUM, ws=ws)
    g_xBC, g_w, g_b = sb.conv_silu_bwd(g_xc, inp["xBC"], inp["conv_w"],
                                       inp["conv_b"], reverse)
    return g_xBC, g_dt, g_A, g_w, g_b, g_D, g_bias, g_h0


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
        if dtype == torch.bfloat16:
            name = f"segment's incoming state dropped, rev={reverse}"
            faults[name] = hold(f"planted fault: {name}", TOL[dtype],
                                drop_segment_fwd(inp, reverse), plain,
                                expect_ok=False)
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
        if dtype == torch.bfloat16:
            name = f"segment's incoming lambda dropped, rev={reverse}"
            faults[name] = hold(f"planted fault: {name}", TOL[dtype],
                                drop_segment_bwd(inp, reverse, car), plain,
                                BWD_NAMES, expect_ok=False, tag="bwd")
        del inp, kernel, plain, car
    return results, faults


def conv_inputs(G, L, Wc, K, dtype, seed, pad=None):
    """The conv adjoint's inputs on the card: g_xc (fp32), xBC (contiguous,
    or a column view at offset ``pad`` of a wider row), conv_w, conv_b."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=g, device="cuda") * sc
    wide = rnd(G, L, (pad or 0) + Wc + 8).to(dtype)
    xBC = (wide[..., :Wc].contiguous() if pad is None
           else wide[..., pad:pad + Wc])
    return rnd(G, L, Wc), xBC, rnd(K, Wc, sc=0.5), rnd(Wc, sc=0.1)


CONV_NAMES = ("g_xBC", "g_conv_w", "g_conv_b")


def conv_pair(args, reverse, fault=()):
    """`ssd_conv_bwd` (or a planted fault's build of it) and its plain
    version, `ops/ssd.py conv_silu_bwd`, on the same tensors."""
    from caduceus_tpu_torch.ops import ssd_batched as sb
    from caduceus_tpu_torch.ops.ssd import conv_silu_bwd

    with _variant(sb, fault) if fault else contextlib.nullcontext():
        kernel = sb.conv_silu_bwd(*args, reverse)
    torch.cuda.synchronize()
    return kernel, conv_silu_bwd(*args, reverse)


def phase_conv_checks():
    """#3b alone (`ssd_conv_bwd`, the SiLU + conv adjoint) against its
    plain version: small shapes (fp32 and bf16, both directions, K 1-4,
    L=4099: four 1,024-row tiles and a ragged fifth; Wc 388 contiguous, and
    Wc 203 as a column view at an odd offset, which takes the scalar path)
    and the main geometry (G=4, L=8192, Wc=768 in a 1288-wide row, bf16
    both directions, fp32); then the halo of every row tile dropped (the
    g_pre rows past it, the raw rows before it: variant builds), which
    must fail."""
    from caduceus_tpu_torch.kernel_check import TOL

    results, faults = [], {}
    seed = 300
    for dtype in (torch.float32, torch.bfloat16):
        for reverse in (False, True):
            for K in (1, 2, 3, 4):
                for Wc, pad in ((388, None), (203, 5)):
                    seed += 1
                    label = (f"conv small G=2 L=4099 Wc={Wc} K={K} "
                             f"{str(dtype)[6:]} rev={reverse}")
                    args = conv_inputs(2, 4099, Wc, K, dtype, seed, pad)
                    results.append({"case": label, **hold(
                        label, TOL[dtype], *conv_pair(args, reverse),
                        CONV_NAMES, tag="conv")})
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        args = conv_inputs(4, 8192, 768, 4, dtype, seed, pad=512)
        label = f"conv main G=4 L=8192 Wc=768 {str(dtype)[6:]} rev={reverse}"
        kernel, plain = conv_pair(args, reverse)
        results.append({"case": label, **hold(
            label, TOL[dtype], kernel, plain, CONV_NAMES, tag="conv")})
        if dtype == torch.bfloat16:
            for what, fault in (("g_pre rows past", CONV_DROP_AFTER),
                                ("raw rows before", CONV_DROP_BEFORE)):
                name = f"the {what} each row tile dropped, rev={reverse}"
                faults[name] = hold(
                    f"planted fault: {name}", TOL[dtype],
                    conv_pair(args, reverse, fault)[0], plain, CONV_NAMES,
                    expect_ok=False, tag="conv")
        del args, kernel, plain
    return results, faults


def phase_model_vs_cpu(config=None):
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM

    config = config or hg38_mlm_v2_config
    cfg = config(n_layer=2, dtype="float32")
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
    log(f"[model] {config.__name__[:-7]}: card vs CPU, full width, 2 layers, "
        f"L=2048, fp32: max err "
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
    from caduceus_tpu_torch.ops import scan, ssd_head
    from caduceus_tpu_torch.ops import ssd_batched as sb

    return {"ssd_fused_fwd": sb.launches, "ssd_fwd": sb.unfused_launches,
            "ssd_fused_bwd_kernel":
            sb.bwd_launches, "ssd_conv_bwd_kernel": sb.conv_bwd_launches,
            "ssd_bwd": sb.unfused_bwd_launches,
            "ssd_head_fwd": ssd_head.head_fwd_launches,
            "ssd_head_bwd": ssd_head.head_bwd_launches,
            "selective_scan_fwd": scan.fwd_launches,
            "bidir_scan_fwd": scan.bidir_launches,
            "selective_scan_bwd": scan.bwd_launches,
            "bidir_scan_bwd": scan.bidir_bwd_launches}


def _zero_counts():
    from caduceus_tpu_torch.ops import scan, ssd_head
    from caduceus_tpu_torch.ops import ssd_batched as sb

    sb.launches = sb.unfused_launches = 0
    sb.bwd_launches = sb.conv_bwd_launches = sb.unfused_bwd_launches = 0
    ssd_head.head_fwd_launches = ssd_head.head_bwd_launches = 0
    scan.fwd_launches = scan.bidir_launches = scan.bwd_launches = 0
    scan.bidir_bwd_launches = 0


def _per_head(cfg) -> bool:
    """Whether the v2 config takes the per-head route (`models/mamba2.py`)."""
    k = cfg.ssm_cfg.use_kernel
    return k.startswith("pallas") and not k.startswith("pallas_batched")


def _per_micro_batch(cfg):
    """Launches of one micro-batch's forward + backward with remat span 1:
    each layer's forward runs twice (the remat recompute), its backward
    once. v2: two SSD directions per layer (fused-conv kernels, or the
    per-head pair for ``use_kernel="pallas"``); v1 bidirectional: one
    paired forward and two backward launches per layer (one paired backward
    with CADUCEUS_BIDIR_BWD=1); v1 unidirectional: one and one."""
    n = cfg.n_layer
    out = dict.fromkeys(_counts(), 0)
    if cfg.ssm_cfg.version == 2 and _per_head(cfg):
        out.update({"ssd_head_fwd": 2 * n * 2, "ssd_head_bwd": 2 * n})
    elif cfg.ssm_cfg.version == 2:
        out.update({"ssd_fused_fwd": 2 * n * 2, "ssd_fused_bwd_kernel": 2 * n,
                    "ssd_conv_bwd_kernel": 2 * n})
    elif cfg.bidirectional and os.environ.get("CADUCEUS_BIDIR_BWD") == "1":
        out.update({"bidir_scan_fwd": n * 2, "bidir_scan_bwd": n})
    elif cfg.bidirectional:
        out.update({"bidir_scan_fwd": n * 2, "selective_scan_bwd": 2 * n})
    else:
        out.update({"selective_scan_fwd": n * 2, "selective_scan_bwd": n})
    return out


def phase_train_vs_cpu(config=None):
    """One step (accum 2) of the full-width model at 2 layers, L=2048, fp32,
    on the card and on the CPU from the same weights and batch."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.train.optim import (make_optimizer,
                                                weight_decay_mask)
    from caduceus_tpu_torch.train.trainer import TrainState, make_train_step

    config = config or hg38_mlm_v2_config
    cfg = config(n_layer=2, dtype="float32")
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
    want = {k: v * accum for k, v in _per_micro_batch(cfg).items()}
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
        settled = ((gc.abs() > TRAIN_TOL["settled"] * s)
                   & (gc.abs() > TRAIN_TOL["adam_floor"]))
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
    log(f"[train] {config.__name__[:-7]}: card vs CPU, full width, 2 layers, "
        f"L=2048, fp32, accum 2: "
        f"loss {m_k['loss']:.6f} vs {m_c['loss']:.6f}, grad_norm "
        f"{m_k['grad_norm']:.6f} vs {m_c['grad_norm']:.6f}; worst gradient "
        f"{worst} {g_err:.2e} of its max (tol {TRAIN_TOL['grad']}); worst "
        f"updated parameter {p_err:.2e}·(1+|p|) where |g| > "
        f"{TRAIN_TOL['settled']}·max|g| and {TRAIN_TOL['adam_floor']} (tol "
        f"{TRAIN_TOL['param']}); held "
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


def phase_train_full(config=None, n_layer=16):
    """`make_train_step` + `make_optimizer` on a full-width model (default
    hg38_mlm_v2; hg38_mlm for v1) at L=131072, micro-batches of 2
    sequences (G=4 per scan call), accum 2; one warm-up and 2 timed
    steps."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.train.optim import make_optimizer
    from caduceus_tpu_torch.train.trainer import TrainState, make_train_step

    config = config or hg38_mlm_v2_config
    cfg = config(n_layer=n_layer)
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
        log(f"[train] {config.__name__[:-7]} full width, {n_layer} layers, "
            f"L={L}, {micro} x {accum} "
            f"sequences: step {i} ({'warm-up' if i == 0 else 'timed'}) "
            f"{secs:.2f} s, loss {m['loss']:.5f}, grad_norm "
            f"{m['grad_norm']:.4f}, acc {m['acc']:.4f}")
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"step {i}: loss {m['loss']}, grad_norm {m['grad_norm']}")
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    n_mb = n_steps * accum
    want = {k: v * n_mb for k, v in _per_micro_batch(cfg).items()}
    check(counts == want, f"training launches {counts} != {want} "
          f"({n_mb} micro-batches)")
    timed = [s["step_s"] for s in steps[1:]]
    step_s = float(np.mean(timed))
    tokens = micro * accum * L
    log(f"[train] timed steps {', '.join(f'{t:.2f}' for t in timed)} s: "
        f"{step_s:.2f} s/step, {tokens / step_s:,.0f} tokens/s; peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {counts} over {n_mb} "
        f"micro-batches (= {_per_micro_batch(cfg)} each)")
    del model, state, opt, batches
    torch.cuda.empty_cache()
    return {"n_layer": n_layer, "steps": steps, "step_s": step_s,
            "tokens_per_step": tokens,
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


def _sub_launches(call, parts, bytes_of, n=3):
    """Each sub-launch of one kernel call timed alone (``call(parts, ws)``
    runs the chosen ones with the workspace of a full call made first, so
    every input a sub-launch reads is in place), beside the bytes it must
    move and their time at the card's memory rate."""
    ws = call(sum(parts.values()), None)
    out = {}
    for name, part in parts.items():
        ms = _time_cuda(lambda: call(part, ws), n)
        nbytes = bytes_of[name]
        out[name] = {"ms": ms, "bytes": nbytes,
                     "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    log("[time]   sub-launches: " + "; ".join(
        f"{k} {v['ms']:.3f} ms ({v['bytes'] / 1e9:.3f} GB, "
        f"{v['bytes_ms']:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)"
        for k, v in out.items()))
    return out


def phase_timing():
    """The forward kernel at the serving batch (G=16: 8 sequences x 2
    strands, L=131072, bf16, no carries) and every kernel at the training
    shape (G=4, L=131072, bf16, forward direction), each beside its plain
    version and its bound; the timed outputs held against the plain
    versions'."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops import ssd as plain
    from caduceus_tpu_torch.ops import ssd_batched as sb
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
    # the three launches of one call: bytes each must move (bf16 rows; the
    # pre-pass reads x, dt and B for the S - 1 segments it covers; the main
    # pass reads x, dt, B, C and CB and writes y and the carries)
    S = sb.n_segments(G, H, nc, "cuda")
    frac = (S - 1) / S
    cb_bytes = G * NG * nc * T * T * 4
    t["segments"] = S
    t["sub_launches"] = _sub_launches(
        lambda parts, ws: sb.fused_fwd_call(
            *a7, inp["dims"], True, False, T, None, True, parts=parts,
            ws=ws)[3],
        {"prep": sb.PART_PREP, "pre-pass": sb.PART_STATE,
         "main pass": sb.PART_MAIN},
        {"prep": rows * 2 * NG * N * 2 * 2 + cb_bytes,
         "pre-pass": frac * rows * (H * P + H + NG * N) * 2
         + G * H * (S - 1) * N * P * 4,
         "main pass": rows * (H * P + H + 2 * NG * N) * 2 + cb_bytes
         + rows * H * P * 2 + car_bytes + G * H * N * P * 4})
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
    # the four launches of one call: the pre-pass reads C, dt and g_y for
    # S - 1 segments; the main pass reads x, dt, B, C, CB, g_y and the
    # carries and writes g_x (fp32 workspace columns), g_dt and the heads'
    # fp32 g_B / g_C shares; the share sum reads those and writes g_B, g_C
    t["segments"] = S
    share_bytes = rows * H * 2 * N * 4
    t["sub_launches"] = _sub_launches(
        lambda parts, ws: sb.adjoint_xc_call(*bwd_args, parts=parts,
                                             ws=ws)[1],
        {"prep": sb.PART_PREP, "pre-pass": sb.PART_STATE,
         "main pass": sb.PART_MAIN, "share sum": sb.PART_SUM},
        {"prep": rows * 2 * NG * N * 2 * 2 + cb_bytes,
         "pre-pass": frac * rows * (NG * N + H + H * P) * 2
         + G * H * (S - 1) * N * P * 4,
         "main pass": rows * (H * P + H + 2 * NG * N + H * P) * 2 + cb_bytes
         + car_bytes + rows * (H * P * 4 + H * 2) + share_bytes,
         "share sum": share_bytes + rows * 2 * NG * N * 4})
    res["bwd_main"] = t
    log(f"[time] ssd_fused_bwd_kernel G=4 L={L} bf16: kernel {t['ms']:.3f} "
        f"ms, plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}: {t['bytes'] / 1e9:.2f} GB, "
        f"{t['flops'] / 1e12:.2f} TFLOP; workspace write "
        f"{t['extra_bytes'] / 1e9:.2f} GB on top)")

    g_xc = adj_k[0]
    conv_args = (g_xc, inp["xBC"], inp["conv_w"], inp["conv_b"], False)
    t = _timed(lambda: outs.__setitem__("k", conv_silu_bwd(*conv_args)),
               lambda: outs.__setitem__("p", plain.conv_silu_bwd(*conv_args)),
               n_kernel=10)
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
    # the kernel alone as a function of its own inputs: g_xc and xBC read
    # once, g_xBC written once
    t["floor"] = _bound(rows * Wc * (4 + 2 + 2), rows * Wc * (6 * K + 8),
                        FP32_FLOP_PER_S)
    t["library_pair"] = library_pair_timing(conv_args, conv_p)
    res["bwd_conv"] = t
    log(f"[time] ssd_conv_bwd_kernel G=4 L={L} bf16: kernel {t['ms']:.3f} "
        f"ms (runs {', '.join(f'{v:.3f}' for v in t['kernel_ms_runs'])}), "
        f"plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}; workspace and xBC reads "
        f"{t['extra_bytes'] / 1e9:.2f} GB on top); floor of the kernel's own "
        f"traffic {t['floor']['bound_ms']:.3f} ms "
        f"({t['floor']['bytes'] / 1e9:.2f} GB); two PyTorch calls "
        f"{t['library_pair']['ms']:.3f} ms")
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


def library_pair(g_xc, xBC, conv_w, conv_b):
    """The pair of PyTorch calls that computes #3b's function (forward
    direction), a yardstick the port never calls: ``torch.ops.aten.
    silu_backward`` then ``convolution_backward`` of the depthwise causal
    conv (groups = Wc) on channel-first views. Set-up, not timed: xBC in
    fp32 with K-1 zero rows in front (the conv's causal padding), and
    pre = conv(xBC) by `conv1d`. Returns (call, to_outputs): ``call()``
    runs the two calls; ``to_outputs`` maps its result to (g_xBC,
    g_conv_w, g_conv_b) in the port's layouts."""
    G, L, Wc = xBC.shape
    K = conv_w.shape[0]
    x_cf = torch.nn.functional.pad(xBC.float().transpose(1, 2), (K - 1, 0))
    weight = conv_w.float().t().reshape(Wc, 1, K).contiguous()
    pre = torch.nn.functional.conv1d(x_cf, weight, conv_b.float(), groups=Wc)
    g_cf = g_xc.transpose(1, 2)

    def call():
        g_pre = torch.ops.aten.silu_backward(g_cf, pre)
        return torch.ops.aten.convolution_backward(
            g_pre, x_cf, weight, [Wc], [1], [0], [1], False, [0], Wc,
            [True, True, True])

    def to_outputs(res):
        g_x, g_w, g_b = res
        return (g_x[..., K - 1:].transpose(1, 2).to(xBC.dtype),
                g_w.reshape(Wc, K).t(), g_b)

    return call, to_outputs


def library_pair_timing(conv_args, conv_p):
    """The two PyTorch calls of `library_pair` timed on #3b's inputs (the
    set-up outside the timing), after holding their outputs to the plain
    version's (the bf16 rule), so the yardstick computes the same
    function."""
    from caduceus_tpu_torch.kernel_check import TOL

    g_xc, xBC, conv_w, conv_b, _ = conv_args
    call, to_outputs = library_pair(g_xc, xBC, conv_w, conv_b)
    out = {"check": hold("library pair (silu_backward + convolution_backward)"
                         " vs plain", TOL[torch.bfloat16],
                         to_outputs(call()), conv_p, CONV_NAMES, tag="conv")}
    call()
    out["ms_runs"] = [_time_cuda(call, 3), _time_cuda(call, 3)]
    out["ms"] = float(np.mean(out["ms_runs"]))
    del call, to_outputs
    torch.cuda.empty_cache()
    return out


def phase_determinism():
    """Run-to-run bits at the training shape (G=4, L=131072, bf16, forward
    direction): the fused forward with carries (#1) and the fused backward
    (#3: the SSD adjoint and the conv adjoint), the unfused forward and
    adjoint (#2 / #4), and the v1 scan pairs of `scan_determinism_pairs`,
    each twice on the same inputs; every output must be bit for bit the
    same (no sum is left to atomics)."""
    from caduceus_tpu_torch.ops import ssd_batched as sb

    G, L, H, P, NG, N, K = 4, 131072, 8, 64, 1, 128, 4
    T = sb.KERNEL_CHUNK[torch.bfloat16]
    inp = ssd_inputs(G, L, H, P, NG, N, K, torch.bfloat16, 97, width_pad=512)
    a7 = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
          inp["D"], inp["dt_bias"])
    runs = {}

    def fused():
        y, hN, car = sb.ssd_fused_fwd(*a7, inp["dims"], True, False, T,
                                      inp["h_init"], save_carries=True)
        g = sb.ssd_fused_bwd(*a7, inp["g_y"], car, inp["g_hN"], inp["dims"],
                             True, False, T)
        return dict(zip(FWD_NAMES + BWD_NAMES, (y, hN, car) + tuple(g)))

    uinp = unfused_inputs(G, L, H, P, NG, N, torch.bfloat16, 96, pad=16)
    ua = _unfused_args(uinp)

    def unfused():
        y, hN, car = sb.ssd_fwd(*ua, True, False, T, uinp["h_init"], True)
        g = sb.ssd_bwd(*ua, uinp["g_y"], car, uinp["g_hN"], True, False, T)
        return dict(zip(FWD_NAMES + UNFUSED_BWD_NAMES, (y, hN, car) + g))

    res = {}
    pairs = [("fused #1 + #3", fused), ("unfused #2 + #4", unfused)]
    for name, fn in pairs + scan_determinism_pairs():
        first = {k: v.clone() for k, v in fn().items()}
        second = fn()
        torch.cuda.synchronize()
        same = {k: bool(torch.equal(first[k], second[k])) for k in first}
        res[name] = same
        log(f"[determinism] {name}, G={G} L={L} bf16, two runs: " + ", ".join(
            f"{k} {'bit-equal' if v else 'DIFFER'}" for k, v in same.items()))
        check(all(same.values()), f"{name}: outputs differ between two runs "
              f"on the same inputs: {[k for k, v in same.items() if not v]}")
        del first, second
    del inp, uinp, pairs
    torch.cuda.empty_cache()
    return res


def scan_determinism_pairs():
    """The v1 scan kernels at the training shape (G=4, L=131072, d=512,
    N=16, bf16) for `phase_determinism`: #9 + #8 (both directions, #8 once
    per set), #7 + #8 with h_init and g_hN, and #10 from #9's carries."""
    from caduceus_tpu_torch.ops import scan

    G, L, d, N = 4, 131072, 512, 16
    T = scan.KERNEL_CHUNK
    f = scan_inputs(G, L, d, N, torch.bfloat16, 95, model_like=True)
    r = scan_inputs(G, L, d, N, torch.bfloat16, 94, model_like=True)
    a, b = _scan_args(f), _scan_args(r)
    pa = (*a[:2], *a[3:5], *b[:2], *b[3:5], a[2], b[2], a[5], b[5], a[6],
          b[6])

    def paired():
        yf, yr, cf, cr = scan.bidir_scan_fwd(*pa, save_carries=True)
        gf = scan.selective_scan_bwd_cuda(*a, f["g_y"], cf, None, True, False,
                                          T)
        gr = scan.selective_scan_bwd_cuda(*b, r["g_y"], cr, None, True, True,
                                          T)
        return dict(zip(("yf", "yr", "carf", "carr") + tuple(
            f"{n}f" for n in SCAN_BWD_NAMES[:7]) + tuple(
            f"{n}r" for n in SCAN_BWD_NAMES[:7]), (yf, yr, cf, cr) + gf[:7]
            + gr[:7]))

    def one_direction():
        y, hN, car = scan.selective_scan_fwd(*a, True, False, T, f["h0"],
                                             save_carries=True)
        g = scan.selective_scan_bwd_cuda(*a, f["g_y"], car, f["g_hN"], True,
                                         False, T)
        return dict(zip(SCAN_FWD_NAMES + SCAN_BWD_NAMES, (y, hN, car) + g))

    def paired_bwd():
        _, _, cf, cr = scan.bidir_scan_fwd(*pa, save_carries=True)
        g = scan.bidir_scan_bwd(*pa, f["g_y"], r["g_y"], cf, cr)
        return dict(zip(BIDIR_BWD_NAMES, g))

    return [("scan #9 + #8 (both directions)", paired),
            ("scan #7 + #8 (h_init, g_hN)", one_direction),
            ("scan #10", paired_bwd)]


# --- the v1 (Mamba-1) model: the selective scan kernels #7, #8, #9 -------

SCAN_FWD_NAMES = ("y", "hN", "carries")
SCAN_BWD_NAMES = ("g_u", "g_delta", "g_A", "g_B", "g_C", "g_D", "g_bias",
                  "g_h0")


def hg38_mlm_config(n_layer: int = 16, dtype: str = "bfloat16",
                    bidirectional: bool = True):
    """`configs/hg38_mlm.yaml`'s model (the v1 Caduceus-PS: d_model 256,
    d_inner 512, d_state 16, dt_rank 16), written out (no YAML)."""
    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    tok = CaduceusTokenizer()
    return CaduceusConfig(
        d_model=256, n_layer=n_layer, vocab_size=tok.vocab_size,
        rcps=bidirectional, complement_map=tok.complement_map
        if bidirectional else None, bidirectional=bidirectional,
        bidirectional_strategy="add", bidirectional_weight_tie=True,
        rms_norm=True, residual_in_fp32=False, fused_add_norm=True,
        dtype=dtype, param_dtype="float32", remat=True, remat_span=1,
        ssm_cfg=SSMConfig(version=1, d_state=16, d_conv=4, expand=2))


def scan_inputs(G, L, d, N, dtype, seed, model_like=False, D=True,
                bias=True):
    """Seeded scan operands on the card, with h_init and the cotangents.
    B and C are column slices of one (G, L, 16 + 2N) tensor, as the x_proj
    output gives them. ``model_like``: A = -(1..N) x exp(0.3 noise) and a
    dt bias of softplus^-1 of a log-uniform dt in [1e-3, 0.1], the model's
    init, so the states carry over thousands of rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    dbc = rnd(G, L, 16 + 2 * N).to(dtype)
    if model_like:
        A = -torch.arange(1, N + 1, device="cuda").float() * torch.exp(
            rnd(d, N, scale=0.3))
        dt = torch.exp(torch.rand(d, generator=g, device="cuda")
                       * math.log(100.0) + math.log(1e-3))
        b = dt + torch.log(-torch.expm1(-dt))
    else:
        A, b = -torch.exp(rnd(d, N, scale=0.5)), rnd(d, scale=0.1)
    return dict(u=rnd(G, L, d).to(dtype), delta=(rnd(G, L, d) * 0.5).to(dtype),
                A=A, B=dbc[..., 16:16 + N], C=dbc[..., 16 + N:],
                D=rnd(d) if D else None, bias=b if bias else None,
                h0=rnd(G, d, N), g_y=rnd(G, L, d).to(dtype),
                g_hN=rnd(G, d, N))


def _scan_args(inp, **over):
    k = {**inp, **over}
    return [k[n] for n in ("u", "delta", "A", "B", "C", "D", "bias")]


def scan_pair(inp, reverse, z=None, fault=(), **over):
    """`selective_scan_fwd` (with h_init and carries, gated by ``z`` when
    given) and its plain version on the same card tensors; ``over``
    replaces the kernel's inputs, ``fault`` names a planted fault's build
    (`scan_fault`)."""
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan

    T = scan.KERNEL_CHUNK
    with scan_fault(fault):
        kernel = scan.selective_scan_fwd(*_scan_args(inp, **over), True,
                                         reverse, T, inp["h0"],
                                         save_carries=True, z=z)
    torch.cuda.synchronize()
    plain = selective_scan(*_scan_args(inp), True, reverse, T, inp["h0"],
                           True, True, z=z)
    return kernel, plain


def gate_of(inp, seed):
    """A SiLU gate z for `scan_inputs`' u: the second half of a seeded
    (G, L, 2 d) tensor, as the in_proj output gives it (row stride 2 d)."""
    G, L, d = inp["u"].shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    xz = torch.randn(G, L, 2 * d, generator=g, device="cuda")
    return xz.to(inp["u"].dtype)[..., d:]


def bidir_pair(f, r, **over):
    """`bidir_scan_fwd` (set f left to right, set r right to left, with
    carries) and the two plain scans; ``over`` replaces the kernel's
    inputs of set r."""
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan

    T = scan.KERNEL_CHUNK
    a, b = _scan_args(f), _scan_args(r, **over)
    yf, yr, cf, cr = scan.bidir_scan_fwd(*a[:2], *a[3:5], *b[:2], *b[3:5],
                                         a[2], b[2], a[5], b[5], a[6], b[6],
                                         save_carries=True)
    torch.cuda.synchronize()
    pf = selective_scan(*_scan_args(f), True, False, T, return_carries=True)
    pr = selective_scan(*_scan_args(r), True, True, T, return_carries=True)
    return (yf, cf, yr, cr), pf + pr


def phase_scan_checks():
    """The forward kernels against the plain forward: small shapes (one
    partial chunk, and two chunks and a partial one), the SiLU(z) gate, the
    main geometry (d=512, N=16, G=4, L=8192), then planted faults."""
    from caduceus_tpu_torch.kernel_check import TOL

    res, seed = [], 200
    bidir_names = ("yf", "carf", "yr", "carr")
    for dtype in (torch.float32, torch.bfloat16):
        for L in (200, 600):
            for reverse in (False, True):
                for with_dd in (True, False):
                    seed += 1
                    inp = scan_inputs(2, L, 48, 16, dtype, seed, D=with_dd,
                                      bias=with_dd)
                    label = (f"scan fwd small G=2 L={L} d=48 N=16 "
                             f"{str(dtype)[6:]} rev={reverse} "
                             f"D,bias={with_dd}")
                    res.append({"case": label, **hold(
                        label, TOL[dtype], *scan_pair(inp, reverse),
                        SCAN_FWD_NAMES, tag="scan")})
            seed += 1
            inp = scan_inputs(2, L, 48, 16, dtype, seed)
            label = (f"scan fwd gated small G=2 L={L} d=48 N=16 "
                     f"{str(dtype)[6:]}")
            res.append({"case": label, **hold(
                label, TOL[dtype], *scan_pair(inp, L == 600,
                                              z=gate_of(inp, seed)),
                SCAN_FWD_NAMES, tag="scan")})
        seed += 1
        f = scan_inputs(2, 600, 48, 8, dtype, seed)
        r = scan_inputs(2, 600, 48, 8, dtype, seed + 50, D=False)
        label = f"bidir small G=2 L=600 d=48 N=8 {str(dtype)[6:]}"
        res.append({"case": label, **hold(label, TOL[dtype], *bidir_pair(f, r),
                                          bidir_names, tag="scan")})
    faults = {}
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        inp = scan_inputs(4, 8192, 512, 16, dtype, seed, model_like=True)
        label = (f"scan fwd main G=4 L=8192 d=512 N=16 {str(dtype)[6:]} "
                 f"rev={reverse}")
        kernel, plain = scan_pair(inp, reverse)
        res.append({"case": label, **hold(label, TOL[dtype], kernel, plain,
                                          SCAN_FWD_NAMES, tag="scan")})
        if dtype != torch.bfloat16:
            continue
        bf16 = TOL[torch.bfloat16]
        # every scan direction: one run's incoming state dropped
        dropped, _ = scan_pair(inp, reverse, fault=DROP_RUN)
        faults[f"one run's incoming state dropped (rev={reverse})"] = hold(
            f"planted fault: one run's incoming state dropped "
            f"(rev={reverse})", bf16, dropped, plain, SCAN_FWD_NAMES,
            expect_ok=False, tag="scan")
        z = gate_of(inp, seed + 70)
        label = f"scan fwd gated main G=4 L=8192 d=512 N=16 bf16 rev={reverse}"
        res.append({"case": label, **hold(label, bf16, *scan_pair(
            inp, reverse, z=z), SCAN_FWD_NAMES, tag="scan")})
        del dropped, z
        if reverse:
            continue
        no_d, _ = scan_pair(inp, reverse, D=None)
        faults["D term dropped"] = hold(
            "planted fault: D term dropped", bf16, no_d, plain,
            SCAN_FWD_NAMES, expect_ok=False, tag="scan")
        y = kernel[0].clone()
        y[1, 37 * 64 + 16:37 * 64 + 32, 80:96] = 0
        faults["one 16x16 y tile zeroed"] = hold(
            "planted fault: one 16-row x 16-channel y tile zeroed", bf16,
            (y,) + kernel[1:], plain, SCAN_FWD_NAMES, expect_ok=False,
            tag="scan")
        del no_d, y
        r = scan_inputs(4, 8192, 512, 16, dtype, seed + 50, model_like=True)
        label = "bidir main G=4 L=8192 d=512 N=16 bf16"
        k2, p2 = bidir_pair(inp, r)
        res.append({"case": label, **hold(label, bf16, k2, p2, bidir_names,
                                          tag="scan")})
        k2, _ = bidir_pair(inp, r, A=inp["A"])
        faults["reverse set run with the forward set's A"] = hold(
            "planted fault: the reverse set run with the forward set's A",
            bf16, k2, p2, bidir_names, expect_ok=False, tag="scan")
        del r, k2, p2
        del inp, kernel, plain
    # the v1 prefill's shape (G=1, fp32: blocks of 4 warps) at a ragged L
    seed += 1
    inp = scan_inputs(1, 8000, 512, 16, torch.float32, seed, model_like=True)
    label = "scan fwd main G=1 L=8000 d=512 N=16 float32 (4-warp blocks)"
    res.append({"case": label, **hold(label, TOL[torch.float32],
                                      *scan_pair(inp, False), SCAN_FWD_NAMES,
                                      tag="scan")})
    return res, faults


def scan_bwd_pair(inp, reverse, fault=()):
    """`selective_scan_bwd` and its plain version from the same carries
    (the forward kernel's), nonzero h_init and g_hN; ``fault`` names a
    planted fault's build of the adjoint (`scan_fault`)."""
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan_bwd

    T = scan.KERNEL_CHUNK
    a = _scan_args(inp)
    _, _, car = scan.selective_scan_fwd(*a, True, reverse, T, inp["h0"],
                                        save_carries=True)
    with scan_fault(fault):
        kernel = scan.bwd_call(*a, inp["g_y"], car, inp["g_hN"], True,
                               reverse, T)[0]
    torch.cuda.synchronize()
    plain = selective_scan_bwd(*a, inp["g_y"], car, inp["g_hN"], True,
                               reverse, T)
    return kernel, plain


def phase_scan_bwd_checks():
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops.selective_scan import resolve_delta

    res, seed = [], 300
    for dtype in (torch.float32, torch.bfloat16):
        for L in (200, 600):
            for reverse in (False, True):
                seed += 1
                inp = scan_inputs(2, L, 48, 16, dtype, seed)
                label = (f"scan bwd small G=2 L={L} d=48 N=16 "
                         f"{str(dtype)[6:]} rev={reverse}")
                res.append({"case": label, **hold(
                    label, TOL[dtype], *scan_bwd_pair(inp, reverse),
                    SCAN_BWD_NAMES, tag="scan-bwd")})
    faults = {}
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        inp = scan_inputs(4, 8192, 512, 16, dtype, seed, model_like=True)
        label = (f"scan bwd main G=4 L=8192 d=512 N=16 {str(dtype)[6:]} "
                 f"rev={reverse}")
        kernel, plain = scan_bwd_pair(inp, reverse)
        res.append({"case": label, **hold(label, TOL[dtype], kernel, plain,
                                          SCAN_BWD_NAMES, tag="scan-bwd")})
        if dtype != torch.bfloat16:
            continue
        bf16 = TOL[torch.bfloat16]
        # every scan direction: one run's incoming lam dropped
        dropped, _ = scan_bwd_pair(inp, reverse, fault=DROP_RUN)
        faults[f"one run's incoming lam dropped (rev={reverse})"] = hold(
            f"planted fault: one run's incoming lam dropped (rev={reverse})",
            bf16, dropped, plain, SCAN_BWD_NAMES, expect_ok=False,
            tag="scan-bwd")
        del dropped
        if reverse:
            continue
        dropped, _ = scan_bwd_pair(inp, reverse, fault=DROP_SHARE)
        faults["one cluster's g_B share left out"] = hold(
            "planted fault: one cluster's g_B share left out", bf16, dropped,
            plain, SCAN_BWD_NAMES, expect_ok=False, tag="scan-bwd")
        del dropped
        planted = {"g_A scaled by 1+2^-4": kernel[:2] + (
            kernel[2] * (1 + 2 ** -4),) + kernel[3:]}
        g_d = kernel[1].clone()
        g_d[1, 37 * 64 + 16:37 * 64 + 32, 80:96] = 0
        planted["one 16-row x 16-channel tile of g_delta zeroed"] = (
            kernel[:1] + (g_d,) + kernel[2:])
        sig = 1 - torch.exp(-resolve_delta(inp["delta"], inp["bias"], True))
        planted["the softplus chain dropped from g_delta"] = (
            kernel[:1] + ((kernel[1].float() / sig).to(dtype),) + kernel[2:])
        for name, out in planted.items():
            faults[name] = hold(f"planted fault: {name}", bf16, out, plain,
                                SCAN_BWD_NAMES, expect_ok=False,
                                tag="scan-bwd")
        del planted, g_d, sig
        del inp, kernel, plain
    return res, faults


def phase_v1_serve():
    """Serve the full-width hg38_mlm model (16 layers, random weights):
    /embed and /logits at bucket 1024 and one 131,072-token /logits; 16
    `bidir_scan_fwd` launches per dispatch; the served bf16 logits equal
    a direct forward."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.serve import InferenceServer, InferenceService

    cfg = hg38_mlm_config()
    model = CaduceusForMaskedLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(3333))
    svc = InferenceService(cfg, model.state_dict(), device="cuda",
                           max_batch=4, min_bucket=1024, max_length=131072)
    del model
    server = InferenceServer(svc, port=0).start()
    rng = np.random.default_rng(8)

    def seqs(*lengths):
        return ["".join(rng.choice(list("ACGT"), n)) for n in lengths]

    plan = [("/embed", seqs(1000)), ("/logits", seqs(900, 1024)),
            ("/logits", seqs(131072))]
    requests = []
    try:
        torch.cuda.reset_peak_memory_stats()
        d0 = svc.n_dispatches
        _zero_counts()
        for path, batch in plan:
            t0 = time.perf_counter()
            out = _post(server.port, path, {"sequences": batch})[path[1:]]
            dt = time.perf_counter() - t0
            ntok = sum(map(len, batch))
            for s_, o in zip(batch, out):
                a = np.asarray(o, np.float32)
                want = ((cfg.d_model,) if path == "/embed"
                        else (len(s_), cfg.padded_vocab_size))
                check(a.shape == want, f"{path}: shape {a.shape} != {want}")
                check(bool(np.isfinite(a).all()), f"{path}: non-finite")
            requests.append({"path": path, "n_seq": len(batch),
                             "tokens": ntok, "latency_s": dt,
                             "tokens_per_s": ntok / dt})
            log(f"[serve-v1] {path} {len(batch)} seq, {ntok} tokens: "
                f"{dt * 1e3:.1f} ms, {ntok / dt:,.0f} tokens/s")
            if path == "/logits" and len(batch) == 2:
                small = (batch, out)
        counts = _counts()
        dispatches = svc.n_dispatches - d0
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.stop()
    launches = counts["bidir_scan_fwd"]
    log(f"[serve-v1] bidir_scan_fwd launches {launches} over {dispatches} "
        f"dispatches (expect {cfg.n_layer} each); peak memory "
        f"{peak / 2**30:.2f} GiB")
    check(dispatches == len(plan), f"{dispatches} dispatches for "
          f"{len(plan)} requests")
    want = dict.fromkeys(counts, 0)
    want["bidir_scan_fwd"] = cfg.n_layer * dispatches
    check(counts == want, f"serve launches {counts} != {want}")
    batch, out = small
    ids = torch.full((2, 1024), svc.tok.pad_token_id, dtype=torch.long)
    for i, s_ in enumerate(batch):
        ids[i, :len(s_)] = torch.from_numpy(
            svc.tok.encode(s_).astype(np.int64))
    with torch.inference_mode():
        direct = svc.model(ids.cuda()).cpu().numpy()
    for i, s_ in enumerate(batch):
        err = np.abs(np.asarray(out[i], np.float32)
                     - direct[i, :len(s_)]).max()
        check(err <= 1e-6, f"served v1 /logits differ from the model by {err}")
    long_ids = torch.from_numpy(
        svc.tok.encode(plan[-1][1][0]).astype(np.int64))[None].cuda()
    with torch.inference_mode():
        svc.model(long_ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.model(long_ids)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    log(f"[serve-v1] served bf16 logits equal a direct forward; direct "
        f"forward, 1 x 131072 tokens (no HTTP/JSON): {fwd_s * 1e3:.1f} ms")
    del svc
    torch.cuda.empty_cache()
    return {"requests": requests, "launches": launches,
            "dispatches": dispatches, "peak_mem_bytes": peak,
            "forward_131k_s": fwd_s}


def phase_mamba_mixer_step():
    """The unidirectional v1 mixer (`MambaMixer`, `bidirectional=False`,
    the mixer of configs/hg38_mamba_ntp.yaml) through `make_train_step`:
    full width, 2 layers, L=8192, bf16, accum 2; it runs
    `selective_scan_fwd` (#7) and `selective_scan_bwd`."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.train.optim import make_optimizer
    from caduceus_tpu_torch.train.trainer import TrainState, make_train_step

    cfg = hg38_mlm_config(n_layer=2, bidirectional=False)
    model = CaduceusForMaskedLM(cfg, device="cuda",
                                generator=torch.Generator().manual_seed(5))
    opt, _ = make_optimizer(model.named_parameters(), lr=8e-3, warmup_t=100,
                            t_initial=50_000)
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = {"input_ids": torch.randint(7, 11, (4, 8192), generator=gen,
                                        device="cuda"),
             "targets": torch.randint(0, 12, (4, 8192), generator=gen,
                                      device="cuda")}
    _zero_counts()
    t0 = time.perf_counter()
    _, m = make_train_step(accum_steps=2)(TrainState(model, opt), batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    want = {k: v * 2 for k, v in _per_micro_batch(cfg).items()}
    m = {k: float(v) for k, v in m.items()}
    log(f"[train] MambaMixer (unidirectional v1), 2 layers, L=8192, accum 2: "
        f"loss {m['loss']:.5f}, grad_norm {m['grad_norm']:.4f}, "
        f"{secs:.2f} s (first call); launches {counts}")
    check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
          f"MambaMixer step: {m}")
    check(counts == want, f"MambaMixer launches {counts} != {want}")
    return {"launches": counts, "step_s": secs, **m}


def phase_scan_timing():
    """The scan kernels at the training shape (G=4, L=131072, bf16, d=512,
    N=16) beside their plain versions and bounds; #7 also at the v1
    prefill's shape (G=1, fp32) and with the SiLU(z) gate; #8's two
    sub-launches (main pass, g_B / g_C share sum) each alone beside the
    bytes it must move. The timed outputs are held against the plain
    ones. Exps: one per (row, channel, n) and direction, the dA the
    kernels keep for every walk; beside them, per (row, channel), the
    softplus (an exp and a log1p) and, in the adjoint, its chain's exp."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops import selective_scan as plain

    G, L, d, N = 4, 131072, 512, 16
    T = scan.KERNEL_CHUNK
    rows, nc = G * L, -(-L // T)
    bf16 = TOL[torch.bfloat16]
    car_bytes = G * nc * d * N * 4
    # per row and direction: u, delta read, B, C read (bf16), y written
    io_fwd = rows * (2 * d * 2 + 2 * N * 2 + d * 2)
    res = {}
    f = scan_inputs(G, L, d, N, torch.bfloat16, 401, model_like=True)
    r = scan_inputs(G, L, d, N, torch.bfloat16, 402, model_like=True)
    a, b = _scan_args(f), _scan_args(r)
    outs = {}

    t = _timed(lambda: outs.__setitem__("k", scan.selective_scan_fwd(
                   *a, True, False, T, None, save_carries=True)),
               lambda: outs.__setitem__("p", plain.selective_scan(
                   *a, True, False, T, None, True, True)))
    t["check"] = hold(f"timed selective_scan_fwd + carries G=4 L={L} bf16",
                      bf16, outs.pop("k"), outs.pop("p"), SCAN_FWD_NAMES,
                      tag="scan")
    # fp32 FLOP on the non-tensor-core units; the exps (MUFU, 16 per clock
    # per SM) stand beside the bound, not in it
    t.update(_bound(io_fwd + car_bytes, 5 * rows * d * N, FP32_FLOP_PER_S))
    t["exps"], t["exps_softplus"] = rows * d * N, 2 * rows * d
    res["fwd"] = t

    z = gate_of(f, 403)
    t = _timed(lambda: outs.__setitem__("k", scan.selective_scan_fwd(
                   *a, True, False, T, None, save_carries=True, z=z)),
               lambda: outs.__setitem__("p", plain.selective_scan(
                   *a, True, False, T, None, True, True, z=z)))
    t["check"] = hold(f"timed gated selective_scan_fwd + carries G=4 L={L} "
                      "bf16", bf16, outs.pop("k"), outs.pop("p"),
                      SCAN_FWD_NAMES, tag="scan")
    t.update(_bound(io_fwd + rows * d * 2 + car_bytes,
                    5 * rows * d * N + 4 * rows * d, FP32_FLOP_PER_S))
    t["exps"], t["exps_softplus"] = rows * d * N + rows * d, 2 * rows * d
    res["fwd_gated"] = t
    del z

    # the v1 prefill's call: one sequence, the scan in fp32 (B and C column
    # views of the fp32 x_proj output), from a state
    f1 = scan_inputs(1, L, d, N, torch.float32, 404, model_like=True)
    a1 = _scan_args(f1)
    rows1 = L
    t = _timed(lambda: outs.__setitem__("k", scan.selective_scan_fwd(
                   *a1, True, False, T, f1["h0"])[:2]),
               lambda: outs.__setitem__("p", plain.selective_scan(
                   *a1, True, False, T, f1["h0"], True)))
    t["check"] = hold(f"timed selective_scan_fwd G=1 L={L} fp32 (prefill)",
                      TOL[torch.float32], outs.pop("k"), outs.pop("p"),
                      ("y", "hN"), tag="scan")
    t.update(_bound(rows1 * (2 * d * 4 + 2 * N * 4 + d * 4) + 2 * d * N * 4,
                    5 * rows1 * d * N, FP32_FLOP_PER_S))
    t["exps"], t["exps_softplus"] = rows1 * d * N, 2 * rows1 * d
    res["fwd_G1_fp32"] = t
    del f1, a1
    # the same in bf16 (a prefill whose scan is not promoted): 8-byte rows
    # of the 4-warp blocks' channels, staged by plain loads
    f1 = scan_inputs(1, L, d, N, torch.bfloat16, 405, model_like=True)
    a1 = _scan_args(f1)
    t = _timed(lambda: outs.__setitem__("k", scan.selective_scan_fwd(
                   *a1, True, False, T, f1["h0"])[:2]),
               lambda: outs.__setitem__("p", plain.selective_scan(
                   *a1, True, False, T, f1["h0"], True)))
    t["check"] = hold(f"timed selective_scan_fwd G=1 L={L} bf16", bf16,
                      outs.pop("k"), outs.pop("p"), ("y", "hN"), tag="scan")
    t.update(_bound(rows1 * (3 * d * 2 + 2 * N * 2) + 2 * d * N * 4,
                    5 * rows1 * d * N, FP32_FLOP_PER_S))
    t["exps"], t["exps_softplus"] = rows1 * d * N, 2 * rows1 * d
    res["fwd_G1_bf16"] = t
    del f1, a1

    t = _timed(lambda: outs.__setitem__("k", scan.bidir_scan_fwd(
                   *a[:2], *a[3:5], *b[:2], *b[3:5], a[2], b[2], a[5], b[5],
                   a[6], b[6], save_carries=True)),
               lambda: outs.__setitem__("p", plain.selective_scan(
                   *a, True, False, T, return_carries=True)
                   + plain.selective_scan(*b, True, True, T,
                                          return_carries=True)))
    k = outs.pop("k")
    t["check"] = hold(f"timed bidir_scan_fwd + carries G=4 L={L} bf16", bf16,
                      (k[0], k[2], k[1], k[3]), outs.pop("p"),
                      ("yf", "carf", "yr", "carr"), tag="scan")
    car = k[2]
    del k
    t.update(_bound(2 * (io_fwd + car_bytes), 2 * 5 * rows * d * N,
                    FP32_FLOP_PER_S))
    t["exps"], t["exps_softplus"] = 2 * rows * d * N, 2 * 2 * rows * d
    res["bidir"] = t

    bwd_args = a + [f["g_y"], car, None, True, False, T]
    t = _timed(lambda: outs.__setitem__("k", scan.selective_scan_bwd_cuda(
                   *bwd_args)),
               lambda: outs.__setitem__("p", plain.selective_scan_bwd(
                   *bwd_args)))
    t["check"] = hold(f"timed selective_scan_bwd G=4 L={L} bf16", bf16,
                      outs.pop("k"), outs.pop("p"), SCAN_BWD_NAMES,
                      tag="scan-bwd")
    # reads u, delta, g_y, B, C and the carries; writes g_u, g_delta, g_B,
    # g_C; the fp32 g_B / g_C shares (written by the main pass, read by the
    # share sum) stand beside it as extra_bytes
    t.update(_bound(rows * (3 * d * 2 + 2 * N * 2 + 2 * d * 2 + 2 * N * 2)
                    + car_bytes, 20 * rows * d * N, FP32_FLOP_PER_S))
    nsh = scan.n_bc_shares(d)
    share_bytes = nsh * 2 * rows * N * 4
    t["exps"], t["exps_softplus"] = rows * d * N + rows * d, 2 * rows * d
    t["extra_bytes"] = 2 * share_bytes
    t["bc_shares"] = nsh
    o = scan.bwd_call(*bwd_args)[1]
    t["sub_launches"] = {}
    for name, part, nbytes in (
            ("main pass", scan.PART_MAIN,
             rows * (3 * d * 2 + 2 * N * 2 + 2 * d * 2) + car_bytes
             + share_bytes),
            ("share sum", scan.PART_SUM, share_bytes + rows * 2 * N * 2)):
        ms = _time_cuda(lambda: scan.bwd_call(*bwd_args, parts=part, out=o), 3)
        t["sub_launches"][name] = {"ms": ms, "bytes": nbytes,
                                   "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    log("[time]   scan bwd sub-launches: " + "; ".join(
        f"{k} {v['ms']:.3f} ms ({v['bytes'] / 1e9:.3f} GB, "
        f"{v['bytes_ms']:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)"
        for k, v in t["sub_launches"].items()))
    del o
    res["bwd"] = t
    for name, t in res.items():
        # MUFU exp2: 16 per clock per SM, 132 SMs at 1.98 GHz
        t["exp_ms"] = t["exps"] / (16 * 132 * 1.98e9) * 1e3
        shape = {"fwd_G1_fp32": f"G=1 L={L} fp32",
                 "fwd_G1_bf16": f"G=1 L={L} bf16"}.get(name, f"G=4 L={L} bf16")
        log(f"[time] scan {name} {shape}: kernel {t['ms']:.3f} ms "
            f"(runs {', '.join(f'{v:.3f}' for v in t['kernel_ms_runs'])}), "
            f"plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}: {t['bytes'] / 1e9:.2f} GB, "
            f"{t['flops'] / 1e9:.1f} GFLOP); {t['exps'] / 1e9:.2f}e9 exps "
            f"(one per (row, channel, n){' and the chain' if name == 'bwd' else ''}"
            f"{' and the gate' if name == 'fwd_gated' else ''}) "
            f"= {t['exp_ms']:.3f} ms at the MUFU rate, "
            f"{t['exps_softplus'] / 1e9:.2f}e9 in the softplus")
    return res


# --- generation: the prefill (unfused SSD #2 for v2, #7 for v1), the decode
# step and /generate, for both causal families ---------------------------


def mamba_ntp_config(version: int, n_layer: int = 16,
                     dtype: str = "bfloat16", use_kernel: str = "auto"):
    """The causal models of `cli.py pretrain --model mamba --ntp` (rcps and
    bidirectional off, the `CaduceusConfig` defaults otherwise), written
    out (no YAML). v1: `configs/hg38_mamba_ntp.yaml` (d_model 256, 16
    layers, d_inner 512, d_state 16, dt_rank 16, d_conv 4). v2: the same
    with `--preset configs/hg38_mlm_v2.yaml`'s mixer (d_state 128, headdim
    64, ngroups 1, 8 heads)."""
    from caduceus_tpu_torch.config import CaduceusConfig, SSMConfig
    from caduceus_tpu_torch.tokenization import CaduceusTokenizer

    tok = CaduceusTokenizer()
    ssm = (SSMConfig(version=2, d_state=128, headdim=64, ngroups=1, d_conv=4,
                     expand=2, ssd_chunk_size=128, ssd_seg_chunks=8,
                     use_kernel=use_kernel)
           if version == 2 else SSMConfig(version=1, d_state=16, d_conv=4,
                                          expand=2))
    return CaduceusConfig(
        d_model=256, n_layer=n_layer, vocab_size=tok.vocab_size, rcps=False,
        complement_map=tok.complement_map, bidirectional=False,
        dtype=dtype, param_dtype="float32", remat=True, ssm_cfg=ssm)


def unfused_inputs(G, L, H, P, NG, N, dtype, seed, pad=0):
    """Seeded operands of the unfused SSD on the card: x, B and C are column
    views of one (G, L, pad + H·P + 2·NG·N) tensor (the prefill's conv
    output) and dt a column view of a wider one (the in_proj output); with
    the backward's cotangents g_y and g_hN."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    xc = rnd(G, L, pad + H * P + 2 * NG * N).to(dtype)
    o = pad + H * P
    return dict(
        x=xc[..., pad:o].reshape(G, L, H, P),
        B=xc[..., o:o + NG * N].reshape(G, L, NG, N),
        C=xc[..., o + NG * N:].reshape(G, L, NG, N),
        dt=(rnd(G, L, H + 8) * 0.5).to(dtype)[..., 8:],
        A=-torch.exp(rnd(H, scale=0.5)), D=rnd(H), dt_bias=rnd(H, scale=0.1),
        h_init=rnd(G, H, N, P), g_y=rnd(G, L, H, P).to(dtype),
        g_hN=rnd(G, H, N, P))


def _unfused_args(inp, **over):
    k = {**inp, **over}
    return [k[n] for n in ("x", "dt", "A", "B", "C", "D", "dt_bias")]


def unfused_pair(inp, reverse, **over):
    """`ssd_fwd` and its plain version `ssd_chunked` on the same card
    tensors: (y, hN, carries) of each. ``over`` replaces inputs of the
    kernel's run only."""
    from caduceus_tpu_torch.ops.ssd import ssd_chunked
    from caduceus_tpu_torch.ops.ssd_batched import KERNEL_CHUNK, ssd_fwd

    T = KERNEL_CHUNK[inp["x"].dtype]
    k = {**inp, **over}
    kernel = ssd_fwd(*_unfused_args(inp, **over), True, reverse, T,
                     k["h_init"], save_carries=True)
    torch.cuda.synchronize()
    plain = ssd_chunked(*_unfused_args(inp), True, reverse, T, inp["h_init"],
                        return_carries=True)
    return kernel, plain


def phase_unfused_checks():
    """`ssd_fwd` (TPU kernel #2) against `ssd_chunked`: small shapes, the
    main geometry, and planted faults that must fail."""
    from caduceus_tpu_torch.kernel_check import TOL

    results, faults, seed = [], {}, 500
    for dtype in (torch.float32, torch.bfloat16):
        for NG in (1, 2):
            for reverse in (False, True):
                seed += 1
                inp = unfused_inputs(2, 200, 4, 32, NG, 32, dtype, seed,
                                     pad=16)
                label = (f"unfused small G=2 L=200 H=4 P=32 NG={NG} N=32 "
                         f"{str(dtype)[6:]} rev={reverse}")
                results.append({"case": label, **hold(
                    label, TOL[dtype], *unfused_pair(inp, reverse),
                    tag="ssd-unfused")})
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        inp = unfused_inputs(4, 8192, 8, 64, 1, 128, dtype, seed, pad=0)
        label = (f"unfused main G=4 L=8192 H=8 P=64 N=128 {str(dtype)[6:]} "
                 f"rev={reverse}")
        kernel, plain = unfused_pair(inp, reverse)
        results.append({"case": label, **hold(label, TOL[dtype], kernel,
                                              plain, tag="ssd-unfused")})
        if faults:
            continue
        bf16 = TOL[torch.bfloat16]
        no_d, _ = unfused_pair(inp, reverse, D=torch.zeros_like(inp["D"]))
        planted = {"D term dropped": no_d}
        y = kernel[0].clone()
        t0 = 37 * 64 + 16                 # rows 16..31 of chunk 37
        y[1, t0:t0 + 16, 5, 48:64] = 0
        planted["one y tile (g1, h5, p48-63) zeroed"] = (y,) + kernel[1:]
        no_h0, _ = unfused_pair(inp, reverse, h_init=None)
        planted["h_init ignored"] = no_h0
        for name, out in planted.items():
            faults[name] = hold(f"planted fault: {name}", bf16, out, plain,
                                expect_ok=False, tag="ssd-unfused")
        del planted, no_d, no_h0, y
        del inp, kernel, plain
    return results, faults


def _close(label, got, want, tol):
    """max |got - want| <= tol x max|want|, on the CPU."""
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
    check(err <= tol * scale, f"{label}: {err:.3e} > {tol} x {scale:.3e}")
    return err / max(scale, 1e-30)


def _cache_close(label, got, want, tol):
    return max(_close(f"{label} {k} {n}", got[k]["fwd"][n], want[k]["fwd"][n],
                      tol) for k in want for n in ("conv", "ssm"))


def _scan_counter(cfg):
    """The launch counter of the prefill's scan kernel."""
    if cfg.ssm_cfg.version == 1:
        return "selective_scan_fwd"
    return "ssd_head_fwd" if _per_head(cfg) else "ssd_fwd"


def phase_prefill_vs_cpu(version, use_kernel="auto"):
    """The full-width causal model at 2 layers, fp32: `prefill` on the card
    against the CPU from the same weights (logits and every cache entry), a
    prompt split in two chained prefills against one call, and greedy
    `generate` of 32 tokens against the CPU's tokens and the argmax of the
    card's full forward."""
    from caduceus_tpu_torch.inference import generate, prefill
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM

    cfg = mamba_ntp_config(version, n_layer=2, dtype="float32",
                           use_kernel=use_kernel)
    gen = torch.Generator().manual_seed(40 + version)
    cpu = CaduceusForMaskedLM(cfg, device="cpu", generator=gen)
    card = CaduceusForMaskedLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    B, L, n_new = 2, 1500, 32
    ids = torch.randint(7, 11, (B, L), generator=gen)
    _zero_counts()
    logits, caches = prefill(card, ids.cuda())
    torch.cuda.synchronize()
    counts = _counts()
    want = dict.fromkeys(counts, 0)
    want[_scan_counter(cfg)] = cfg.n_layer
    check(counts == want, f"prefill launches {counts} != {want}")
    t0 = time.perf_counter()
    ref_logits, ref_caches = prefill(cpu, ids)
    t_cpu = time.perf_counter() - t0
    res = {"logits": _close("card vs CPU prefill logits", logits, ref_logits,
                            MODEL_TOL),
           "caches": _cache_close("card vs CPU prefill cache", caches,
                                  ref_caches, MODEL_TOL)}
    # two chained prefills (split inside a chunk, and before d_conv rows)
    chained = {}
    for split in (700, 3):
        _, c1 = prefill(card, ids[:, :split].cuda())
        l2, c2 = prefill(card, ids[:, split:].cuda(), caches=c1)
        chained[split] = max(
            _close(f"chained prefill at {split}: logits", l2, logits, 1e-4),
            _cache_close(f"chained prefill at {split}: cache", c2, caches,
                         1e-4))
    res["chained"] = chained
    out = generate(card, ids.cuda(), n_new).cpu()
    ref = generate(cpu, ids, n_new)
    check(torch.equal(out, ref), f"greedy tokens card {out[:, L:].tolist()} "
          f"vs CPU {ref[:, L:].tolist()}")
    with torch.inference_mode():
        full = card(out[:, :-1].cuda()).argmax(-1).cpu()
    check(torch.equal(full[:, L - 1:], out[:, L:]),
          "greedy tokens differ from the argmax of the card's full forward")
    log(f"[prefill] v{version} causal (use_kernel {use_kernel}), full "
        f"width, 2 layers, fp32, B={B}, "
        f"L={L}: card vs CPU logits {res['logits']:.2e}, caches "
        f"{res['caches']:.2e} of max (tol {MODEL_TOL}); chained prefills "
        f"(split 700, 3) vs one call {max(chained.values()):.2e} of max "
        f"(tol 1e-4); greedy {n_new} tokens equal to the CPU's and to the "
        f"argmax of the card's full forward; launches {counts}; CPU prefill "
        f"{t_cpu:.2f} s")
    return {**res, "launches": counts, "cpu_prefill_s": t_cpu}


def _prefill_bound(cfg, L, B=1):
    """The least time of a bf16 model's prefill of B x L tokens: every
    layer's scan kernel's bytes (as its own bound) plus the layer's hidden
    state in and out, and the operations: the projections at the bf16
    tensor-core peak, the scan at the fp32 peak (with a conv bias the
    scan's operands are fp32, as in the JAX prefill; `inference._conv_tail`)
    or the bf16 one; the conv, norms and the rest add to it."""
    c, s = cfg, cfg.ssm_cfg
    rows = B * L
    d, di = c.d_model, c.d_inner
    es = 4 if s.conv_bias else 2   # bytes per scan operand
    if s.version == 2:
        H, P, NG, N = c.nheads, s.headdim, s.ngroups, s.d_state
        T = 32 if s.conv_bias else 64
        proj = 2 * d * (2 * di + 2 * NG * N + H) + 2 * di * d
        scan_bytes = rows * ((H * P + 2 * NG * N + H) * es + H * P * es)
        scan_ops = rows * (2 * T * N * NG + 2 * T * P * H + 4 * N * P * H)
    else:
        N, R = s.d_state, c.dt_rank
        proj = 2 * d * 2 * di + 2 * di * (R + 2 * N) + 2 * R * di + 2 * di * d
        scan_bytes = rows * (2 * di * es + 2 * N * es + di * es)
        scan_ops = 5 * rows * di * N
    n = c.n_layer
    nbytes = n * (scan_bytes + rows * d * 2 * 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (n * rows * proj / BF16_FLOP_PER_S + n * scan_ops
              / (FP32_FLOP_PER_S if s.conv_bias else BF16_FLOP_PER_S)) * 1e3
    return {"bytes": nbytes, "flops": n * (scan_ops + rows * proj),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _bf16_conv_tail(dparams, x_ext):
    """The prefill's conv with its bias cast to the input's dtype, so that a
    bf16 model's scan runs in bf16: the rule before `inference._conv_tail`
    mirrored the JAX prefill's fp32 promotion; timed beside it."""
    from caduceus_tpu_torch.ops.conv import causal_conv1d

    K = dparams.conv_w.shape[0]
    b = None if dparams.conv_b is None else dparams.conv_b.to(x_ext.dtype)
    return causal_conv1d(x_ext, dparams.conv_w.to(x_ext.dtype), b,
                         activation="silu")[:, K - 1:]


def phase_generate_serve(version):
    """The full-width 16-layer causal model served over HTTP: /generate
    with prompts of 1,000 and 131,072 tokens, 64 new tokens each; the
    prefill launches its scan kernel once per layer and decoding none; a
    bf16 prefill's last logits against the full forward's last position;
    prefill tokens/s, decode ms per token at batch 1 and 8, /generate
    latency, each beside its bound."""
    from caduceus_tpu_torch import inference
    from caduceus_tpu_torch.inference import lm_step, prefill
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.serve import InferenceServer, InferenceService

    cfg = mamba_ntp_config(version)
    model = CaduceusForMaskedLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(60 + version))
    svc = InferenceService(cfg, model.state_dict(), device="cuda",
                           max_batch=4, min_bucket=1024, max_length=131072)
    del model
    server = InferenceServer(svc, port=0).start()
    rng = np.random.default_rng(9 + version)
    prompts = ["".join(rng.choice(list("ACGT"), n)) for n in (1000, 131072)]
    n_new, requests = 64, []
    counter = _scan_counter(cfg)
    try:
        _zero_counts()
        for prompt in prompts:
            t0 = time.perf_counter()
            out = _post(server.port, "/generate",
                        {"prompt": prompt, "max_new_tokens": n_new})
            dt = time.perf_counter() - t0
            check(out["prompt"] == prompt and len(out["generated"]) >= n_new,
                  f"/generate: {str(out)[:200]}")
            requests.append({"prompt_tokens": len(prompt), "new": n_new,
                             "latency_s": dt})
            log(f"[generate] v{version} /generate {len(prompt)} + {n_new} "
                f"tokens: {dt * 1e3:.1f} ms over HTTP")
        counts = _counts()
        # the long request again with the prefill's scan in bf16 (its conv
        # bias cast to bf16, as before the JAX prefill's fp32 promotion was
        # mirrored): a time to compare, not a path of the port
        with mock.patch.object(inference, "_conv_tail", _bf16_conv_tail):
            t0 = time.perf_counter()
            _post(server.port, "/generate",
                  {"prompt": prompts[-1], "max_new_tokens": n_new})
            bf16_generate_s = time.perf_counter() - t0
    finally:
        server.stop()
    want = dict.fromkeys(counts, 0)
    want[counter] = cfg.n_layer * len(prompts)
    check(counts == want, f"/generate launches {counts} != {want} (the "
          f"prefill: {cfg.n_layer} per request; decoding: none)")
    res = {"requests": requests, "launches": counts[counter],
           "bf16_prefill_vs_forward": {}}
    model = svc.model
    tok = svc.tok
    with torch.inference_mode():
        for prompt in prompts:
            ids = torch.from_numpy(tok.encode(prompt).astype(np.int64))[
                None].cuda()
            last, _ = prefill(model, ids)
            full = model(ids)[:, -1]
            res["bf16_prefill_vs_forward"][len(prompt)] = _close(
                f"bf16 prefill vs full forward, last position, L="
                f"{len(prompt)}", last, full, BF16_MODEL_TOL)
        # prefill rate at 131,072 tokens (warm: the requests above ran it)
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(model, ids)
        torch.cuda.synchronize()
        res["prefill_s"] = time.perf_counter() - t0
        check(_counts()[counter] == cfg.n_layer, "prefill launches")
        res["prefill_tokens_per_s"] = ids.shape[1] / res["prefill_s"]
        res["prefill_bound"] = _prefill_bound(cfg, ids.shape[1])
        with mock.patch.object(inference, "_conv_tail", _bf16_conv_tail):
            prefill(model, ids)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(model, ids)
            torch.cuda.synchronize()
            res["prefill_bf16_scan_s"] = time.perf_counter() - t0
        res["generate_bf16_scan_s"] = bf16_generate_s
        log(f"[generate] v{version} with the prefill's scan in bf16 (the "
            f"earlier rule; time only): prefill 1 x {ids.shape[1]} "
            f"{res['prefill_bf16_scan_s'] * 1e3:.1f} ms, /generate "
            f"{ids.shape[1]} + {n_new} over HTTP {bf16_generate_s * 1e3:.1f} "
            f"ms (fp32 scan: {res['prefill_s'] * 1e3:.1f} ms, "
            f"{requests[-1]['latency_s'] * 1e3:.1f} ms)")
        # decode: ms per token after a 1,000-token prompt, batch 1 and 8
        n_params = sum(p.numel() for p in model.parameters())
        for B in (1, 8):
            short = ids[:, :1000].expand(B, -1).contiguous()
            logits, caches = prefill(model, short)
            tok_t = logits.argmax(-1)
            lm_step(model, tok_t, caches)
            _zero_counts()
            steps = 32
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, caches = lm_step(model, tok_t, caches)
                tok_t = logits.argmax(-1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / steps * 1e3
            check(all(v == 0 for v in _counts().values()),
                  "the decode step launched a scan kernel")
            state = sum(t.numel() * t.element_size() for layer in
                        caches.values() for t in layer["fwd"].values())
            # weights read once (fp32), caches read and written once
            bound = _bound(n_params * 4 + 2 * state,
                           2 * n_params * B)
            res[f"decode_B{B}"] = {"ms_per_token": ms, **bound}
            log(f"[generate] v{version} decode, batch {B}: {ms:.3f} ms per "
                f"token ({B * 1e3 / ms:,.0f} tokens/s), bound "
                f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    pb = res["prefill_bound"]
    res["generate_bound_ms"] = pb["bound_ms"] + n_new * res["decode_B1"][
        "bound_ms"]
    log(f"[generate] v{version} prefill 1 x {ids.shape[1]}: "
        f"{res['prefill_s'] * 1e3:.1f} ms, {res['prefill_tokens_per_s']:,.0f} "
        f"tokens/s, bound {pb['bound_ms']:.3f} ms ({pb['bound_by']}); "
        f"/generate {ids.shape[1]} + {n_new} over HTTP "
        f"{requests[-1]['latency_s'] * 1e3:.1f} ms, bound "
        f"{res['generate_bound_ms']:.3f} ms; launches {counts}; bf16 "
        f"prefill vs full forward (last position) at L = "
        + ", ".join(f"{n}: {e:.2e}" for n, e in
                    res["bf16_prefill_vs_forward"].items())
        + f" of max|logit| (tol {BF16_MODEL_TOL})")
    del svc, model
    torch.cuda.empty_cache()
    return res


def phase_unfused_timing():
    """`ssd_fwd` per call at the prefill's batch G=1 and at G=4, L=131072,
    bf16, and at G=1 in fp32 (the dtype of a bf16 model's prefill scan), no
    carries (as the prefill runs it), beside its plain version and bound;
    the timed outputs held against the plain version's."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops.ssd import ssd_chunked
    from caduceus_tpu_torch.ops.ssd_batched import KERNEL_CHUNK, ssd_fwd

    L, H, P, NG, N = 131072, 8, 64, 1, 128
    res = {}
    for G, dtype in ((1, torch.bfloat16), (4, torch.bfloat16),
                     (1, torch.float32)):
        T = KERNEL_CHUNK[dtype]
        es = 2 if dtype == torch.bfloat16 else 4
        inp = unfused_inputs(G, L, H, P, NG, N, dtype, 700 + G + es, pad=16)
        a = _unfused_args(inp)
        outs = {}
        t = _timed(lambda: outs.__setitem__("k", ssd_fwd(
                       *a, True, False, T, inp["h_init"], False)[:2]),
                   lambda: outs.__setitem__("p", ssd_chunked(
                       *a, True, False, T, inp["h_init"],
                       return_final_state=True)))
        dname = str(dtype)[6:]
        t["check"] = hold(f"timed ssd_fwd G={G} L={L} {dname}",
                          TOL[dtype], outs.pop("k"), outs.pop("p"),
                          ("y", "hN"), tag="ssd-unfused")
        rows = G * L
        # x, B, C, dt read once, y written once; h_init and hN fp32; in
        # fp32 the matmul work runs on the fp32 units
        t.update(_bound(rows * (H * P + 2 * NG * N + H) * es
                        + rows * H * P * es + 2 * G * H * N * P * 4,
                        rows * (2 * T * N * NG + 2 * T * P * H
                                + 4 * N * P * H),
                        BF16_FLOP_PER_S if es == 2 else FP32_FLOP_PER_S))
        res[f"G{G}" if es == 2 else f"G{G}_fp32"] = t
        log(f"[time] ssd_fwd G={G} L={L} {dname}: kernel {t['ms']:.3f} ms "
            f"(runs {', '.join(f'{v:.3f}' for v in t['kernel_ms_runs'])}), "
            f"plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}: {t['bytes'] / 1e9:.3f} GB)")
        del inp, a, outs
    return res

# --- the unfused SSD adjoint (#4 / #6), the per-head route (#5 / #6) and the
# paired v1 backward (#10) ----------------------------------------------

UNFUSED_BWD_NAMES = ("g_x", "g_dt", "g_A", "g_B", "g_C", "g_D", "g_dt_bias",
                     "g_h0")
BIDIR_BWD_NAMES = ("g_uf", "g_df", "g_Bf", "g_Cf", "g_ur", "g_dr", "g_Br",
                   "g_Cr", "g_Af", "g_Ar", "g_Df", "g_Dr", "g_biasf",
                   "g_biasr")


def unfused_bwd_pair(inp, reverse, **over):
    """`ssd_bwd` and its plain version `ssd_chunked_bwd` from the same
    carries (the forward kernel's), nonzero h_init and g_hN: the eight
    gradients of each. ``over`` replaces inputs of the kernel's run only."""
    from caduceus_tpu_torch.ops.ssd import ssd_chunked_bwd
    from caduceus_tpu_torch.ops.ssd_batched import (KERNEL_CHUNK, ssd_bwd,
                                                    ssd_fwd)

    T = KERNEL_CHUNK[inp["x"].dtype]
    a = _unfused_args(inp)
    _, _, car = ssd_fwd(*a, True, reverse, T, inp["h_init"], True)
    k = {**inp, **over}
    kernel = ssd_bwd(*_unfused_args(inp, **over), k["g_y"], car, k["g_hN"],
                     True, reverse, T)
    torch.cuda.synchronize()
    plain = ssd_chunked_bwd(*a, inp["g_y"], car, inp["g_hN"], True, reverse,
                            T)
    return kernel, plain


def phase_unfused_bwd_checks():
    """`ssd_bwd` (TPU kernels #4 / #6) against `ssd_chunked_bwd`, all eight
    gradients: small shapes (fp32 and bf16, both directions, ngroups 1 and
    2, x/B/C and dt as strided column views, L not a multiple of the
    chunk), the main geometry, and planted faults that must fail."""
    from caduceus_tpu_torch.kernel_check import TOL

    results, faults, seed = [], {}, 800
    for dtype in (torch.float32, torch.bfloat16):
        for NG in (1, 2):
            for reverse in (False, True):
                seed += 1
                inp = unfused_inputs(2, 200, 4, 32, NG, 32, dtype, seed,
                                     pad=16)
                label = (f"unfused bwd small G=2 L=200 H=4 P=32 NG={NG} N=32 "
                         f"{str(dtype)[6:]} rev={reverse}")
                results.append({"case": label, **hold(
                    label, TOL[dtype], *unfused_bwd_pair(inp, reverse),
                    UNFUSED_BWD_NAMES, tag="ssd-bwd")})
    for dtype, reverse in ((torch.bfloat16, False), (torch.bfloat16, True),
                           (torch.float32, False)):
        seed += 1
        inp = unfused_inputs(4, 8192, 8, 64, 1, 128, dtype, seed, pad=16)
        label = (f"unfused bwd main G=4 L=8192 H=8 P=64 N=128 "
                 f"{str(dtype)[6:]} rev={reverse}")
        kernel, plain = unfused_bwd_pair(inp, reverse)
        results.append({"case": label, **hold(
            label, TOL[dtype], kernel, plain, UNFUSED_BWD_NAMES,
            tag="ssd-bwd")})
        if faults:
            continue
        t0 = 37 * 64 + 16                 # rows 16..31 of chunk 37
        planted = {"g_h0 left at zero": kernel[:7] + (
            torch.zeros_like(kernel[7]),)}
        planted["g_A scaled by 1+2^-4"] = kernel[:2] + (
            kernel[2] * (1 + 2 ** -4),) + kernel[3:]
        g_dt = kernel[1].clone()
        g_dt[1, t0:t0 + 16, 5] = 0
        planted["one 16-row tile of g_dt (g1, h5) zeroed"] = (
            kernel[:1] + (g_dt,) + kernel[2:])
        g_B = kernel[3].clone()
        g_B[1, t0:t0 + 16, 0, 16:32] = 0
        planted["one 16x16 tile of g_B zeroed"] = (
            kernel[:3] + (g_B,) + kernel[4:])
        for name, out in planted.items():
            faults[name] = hold(f"planted fault: {name}", TOL[dtype], out,
                                plain, UNFUSED_BWD_NAMES, expect_ok=False,
                                tag="ssd-bwd")
        del planted, g_dt, g_B
        del inp, kernel, plain
    return results, faults


def phase_chained_grad():
    """Two chained `ssd_batched_chained` calls (the prompt split at row
    1000, inside a chunk) against one call, through autograd on the card
    (`_SSDFn`: `ssd_fwd` + `ssd_bwd`): y, hN and every gradient, g_h0
    among them, by `kernel_check.py`'s fp32 rule. The launches of this
    phase are #4's path: `ssd_batched_chained` under grad."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops.ssd_batched import ssd_batched_chained

    inp = unfused_inputs(2, 4096, 8, 64, 1, 128, torch.float32, 900)
    names = ("x", "dt", "A", "B", "C", "D", "dt_bias", "h_init")
    cut = 1000

    def run(split):
        leaves = [inp[n].detach().clone().requires_grad_() for n in names]
        x, dt, A, B, C, D, bias, h0 = leaves
        if split:
            y1, h1 = ssd_batched_chained(x[:, :cut], dt[:, :cut], A,
                                         B[:, :cut], C[:, :cut], D, bias, h0)
            y2, hN = ssd_batched_chained(x[:, cut:], dt[:, cut:], A,
                                         B[:, cut:], C[:, cut:], D, bias, h1)
            y = torch.cat([y1, y2], 1)
        else:
            y, hN = ssd_batched_chained(x, dt, A, B, C, D, bias, h0)
        loss = (y * inp["g_y"]).sum() + (hN * inp["g_hN"]).sum()
        grads = torch.autograd.grad(loss, leaves)
        return (y.detach(), hN.detach()) + grads

    _zero_counts()
    one = run(False)
    two = run(True)
    torch.cuda.synchronize()
    counts = _counts()
    want = dict.fromkeys(counts, 0)
    want.update({"ssd_fwd": 3, "ssd_bwd": 3})
    check(counts == want, f"chained gradient launches {counts} != {want}")
    res = hold(f"two chained ssd_batched_chained (split at {cut}) vs one "
               "call, G=2 L=4096 H=8 P=64 N=128 fp32", TOL[torch.float32],
               two, one, ("y", "hN") + tuple(f"g_{n}" for n in names),
               tag="ssd-chain")
    return {"checks": res, "launches": counts}


def bidir_bwd_pair(f, r, **over):
    """`bidir_scan_bwd` (one launch), the default two-launch backward
    (`selective_scan_bwd` per set) and the plain adjoints, from the paired
    forward kernel's carries: three 14-tuples in `bidir_scan_bwd_impl`'s
    order. ``over`` replaces the paired kernel's inputs of set r."""
    from caduceus_tpu_torch.ops import scan
    from caduceus_tpu_torch.ops.selective_scan import selective_scan_bwd

    T = scan.KERNEL_CHUNK
    a, b = _scan_args(f), _scan_args(r)
    _, _, carf, carr = scan.bidir_scan_fwd(*a[:2], *a[3:5], *b[:2], *b[3:5],
                                           a[2], b[2], a[5], b[5], a[6], b[6],
                                           save_carries=True)
    rk = {**r, **over}
    b_k = _scan_args(rk)
    paired = scan.bidir_scan_bwd(*a[:2], *a[3:5], *b_k[:2], *b_k[3:5], a[2],
                                 b_k[2], a[5], b_k[5], a[6], b_k[6], f["g_y"],
                                 rk["g_y"], carf, carr)
    order = lambda gf, gr: (*gf[:2], *gf[3:5], *gr[:2], *gr[3:5], gf[2],
                            gr[2], gf[5], gr[5], gf[6], gr[6])
    two = order(scan.selective_scan_bwd_cuda(*a, f["g_y"], carf, None, True,
                                             False, T),
                scan.selective_scan_bwd_cuda(*b, r["g_y"], carr, None, True,
                                             True, T))
    torch.cuda.synchronize()
    plain = order(selective_scan_bwd(*a, f["g_y"], carf, None, True, False, T),
                  selective_scan_bwd(*b, r["g_y"], carr, None, True, True, T))
    return paired, two, plain


def phase_bidir_bwd_checks():
    """`bidir_scan_bwd` (TPU kernel #10) against the two-launch backward and
    the plain adjoints: small shapes and the main geometry (d=512, N=16,
    G=4, L=8192), then planted faults that must fail."""
    from caduceus_tpu_torch.kernel_check import TOL

    res, faults, seed = [], {}, 600
    for dtype in (torch.float32, torch.bfloat16):
        seed += 1
        f = scan_inputs(2, 200, 48, 16, dtype, seed)
        r = scan_inputs(2, 200, 48, 16, dtype, seed + 50, D=False, bias=False)
        paired, two, plain = bidir_bwd_pair(f, r)
        for ref_name, ref in (("two launches", two), ("plain", plain)):
            label = (f"bidir bwd small G=2 L=200 d=48 N=16 {str(dtype)[6:]} "
                     f"vs {ref_name}")
            res.append({"case": label, **hold(label, TOL[dtype], paired, ref,
                                              BIDIR_BWD_NAMES,
                                              tag="scan-bwd")})
    dtype = torch.bfloat16
    f = scan_inputs(4, 8192, 512, 16, dtype, 650, model_like=True)
    r = scan_inputs(4, 8192, 512, 16, dtype, 651, model_like=True)
    paired, two, plain = bidir_bwd_pair(f, r)
    for ref_name, ref in (("two launches", two), ("plain", plain)):
        label = f"bidir bwd main G=4 L=8192 d=512 N=16 bf16 vs {ref_name}"
        res.append({"case": label, **hold(label, TOL[dtype], paired, ref,
                                          BIDIR_BWD_NAMES, tag="scan-bwd")})
    wrong, _, _ = bidir_bwd_pair(f, r, g_y=f["g_y"])
    faults["the reverse set given the forward set's g_y"] = hold(
        "planted fault: the reverse set given the forward set's g_y",
        TOL[dtype], wrong, plain, BIDIR_BWD_NAMES, expect_ok=False,
        tag="scan-bwd")
    g_u = paired[0].clone()
    g_u[1, 37 * 64 + 16:37 * 64 + 32, 80:96] = 0
    faults["one 16-channel tile of g_u zeroed"] = hold(
        "planted fault: one 16-row x 16-channel tile of g_uf zeroed",
        TOL[dtype], (g_u,) + paired[1:], plain, BIDIR_BWD_NAMES,
        expect_ok=False, tag="scan-bwd")
    return res, faults


def phase_head_serve():
    """Serve the full-width 16-layer `use_kernel: pallas` model: /logits at
    bucket 1024 and one 131,072-token /logits; 32 `ssd_head_fwd` launches
    (TPU kernel #5) per dispatch and no other kernel; the served logits
    equal a direct forward."""
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.serve import InferenceServer, InferenceService

    cfg = hg38_mlm_v2_pallas_config()
    model = CaduceusForMaskedLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(4444))
    svc = InferenceService(cfg, model.state_dict(), device="cuda",
                           max_batch=4, min_bucket=1024, max_length=131072)
    del model
    server = InferenceServer(svc, port=0).start()
    rng = np.random.default_rng(10)
    plan = [["".join(rng.choice(list("ACGT"), n)) for n in lengths]
            for lengths in ((900, 1024), (131072,))]
    requests = []
    try:
        torch.cuda.reset_peak_memory_stats()
        d0 = svc.n_dispatches
        _zero_counts()
        outs = []
        for batch in plan:
            t0 = time.perf_counter()
            out = _post(server.port, "/logits", {"sequences": batch})["logits"]
            dt = time.perf_counter() - t0
            ntok = sum(map(len, batch))
            for s_, o in zip(batch, out):
                a = np.asarray(o, np.float32)
                check(a.shape == (len(s_), cfg.padded_vocab_size),
                      f"/logits: shape {a.shape}")
                check(bool(np.isfinite(a).all()), "/logits: non-finite")
            outs.append(out)
            requests.append({"n_seq": len(batch), "tokens": ntok,
                             "latency_s": dt, "tokens_per_s": ntok / dt})
            log(f"[serve-head] /logits {len(batch)} seq, {ntok} tokens: "
                f"{dt * 1e3:.1f} ms, {ntok / dt:,.0f} tokens/s")
        counts = _counts()
        dispatches = svc.n_dispatches - d0
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.stop()
    check(dispatches == len(plan), f"{dispatches} dispatches for "
          f"{len(plan)} requests")
    want = dict.fromkeys(counts, 0)
    want["ssd_head_fwd"] = 2 * cfg.n_layer * dispatches
    check(counts == want, f"per-head serve launches {counts} != {want}")
    batch, out = plan[0], outs[0]
    ids = torch.full((2, 1024), svc.tok.pad_token_id, dtype=torch.long)
    for i, s_ in enumerate(batch):
        ids[i, :len(s_)] = torch.from_numpy(
            svc.tok.encode(s_).astype(np.int64))
    with torch.inference_mode():
        direct = svc.model(ids.cuda()).cpu().numpy()
    for i, s_ in enumerate(batch):
        err = np.abs(np.asarray(out[i], np.float32)
                     - direct[i, :len(s_)]).max()
        check(err <= 1e-6, f"served per-head /logits differ from the model "
              f"by {err}")
    long_ids = torch.from_numpy(
        svc.tok.encode(plan[-1][0]).astype(np.int64))[None].cuda()
    with torch.inference_mode():
        svc.model(long_ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.model(long_ids)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    log(f"[serve-head] ssd_head_fwd launches {counts['ssd_head_fwd']} over "
        f"{dispatches} dispatches (= {2 * cfg.n_layer} each); served logits "
        f"equal a direct forward; direct forward 1 x 131072 (no HTTP/JSON) "
        f"{fwd_s * 1e3:.1f} ms; peak memory {peak / 2**30:.2f} GiB")
    del svc
    torch.cuda.empty_cache()
    return {"requests": requests, "launches": counts["ssd_head_fwd"],
            "dispatches": dispatches, "peak_mem_bytes": peak,
            "forward_131k_s": fwd_s}


def phase_new_timing():
    """At the training shape (G=4, L=131072, bf16, forward direction): the
    per-head forward `ssd_head_fwd` (#5, with carries), the unfused adjoint
    through `ssd_bwd` (#4) and through `ssd_head_bwd` (#6; one kernel, each
    entry timed and held on its own), and the paired scan adjoint
    `bidir_scan_bwd` (#10), each beside its plain version and bound; the
    timed outputs held against the plain ones."""
    from caduceus_tpu_torch.kernel_check import TOL
    from caduceus_tpu_torch.ops import scan, ssd_head
    from caduceus_tpu_torch.ops import selective_scan as plain_scan
    from caduceus_tpu_torch.ops.ssd import ssd_chunked, ssd_chunked_bwd
    from caduceus_tpu_torch.ops.ssd_batched import KERNEL_CHUNK, ssd_bwd

    bf16 = TOL[torch.bfloat16]
    G, L, H, P, NG, N = 4, 131072, 8, 64, 1, 128
    T = KERNEL_CHUNK[torch.bfloat16]
    rows, nc = G * L, -(-L // T)
    res = {}
    inp = unfused_inputs(G, L, H, P, NG, N, torch.bfloat16, 990, pad=16)
    a = _unfused_args(inp)
    outs = {}
    t = _timed(lambda: outs.__setitem__("k", ssd_head.ssd_head_fwd(
                   *a, True, False, T, None, True)),
               lambda: outs.__setitem__("p", ssd_chunked(
                   *a, True, False, T, None, return_carries=True)))
    k, p_ = outs.pop("k"), outs.pop("p")
    t["check"] = hold(f"timed ssd_head_fwd + carries G=4 L={L} bf16", bf16,
                      k, p_, tag="ssd-head")
    car = k[2]
    del k, p_
    car_bytes = G * nc * H * N * P * 2
    # x, B, C, dt read, y and the carries written (bf16); hN fp32
    t.update(_bound(rows * (H * P + 2 * NG * N + H) * 2 + rows * H * P * 2
                    + car_bytes + G * H * N * P * 4,
                    rows * (2 * T * N * NG + 2 * T * P * H + 4 * N * P * H)))
    res["head_fwd"] = t

    bwd_args = a + [inp["g_y"], car, None, True, False, T]
    t = _timed(lambda: outs.__setitem__("k", ssd_bwd(*bwd_args)),
               lambda: outs.__setitem__("p", ssd_chunked_bwd(*bwd_args)))
    t["check"] = hold(f"timed ssd_bwd G=4 L={L} bf16", bf16, outs.pop("k"),
                      outs.pop("p"), UNFUSED_BWD_NAMES, tag="ssd-bwd")
    # reads x, B, C, dt, g_y and the carries; writes g_x, g_dt, g_B, g_C
    # in their inputs' dtype (bf16: the TPU kernels' out_shape; the card's
    # fp32 sums of g_B / g_C are its own design) and g_h0 (fp32); the
    # matmul work of the fused backward's SSD part
    bwd_bound = _bound(rows * ((H * P + 2 * NG * N + H) * 2 + H * P * 2)
                       + car_bytes + rows * (H * P + H + 2 * NG * N) * 2
                       + G * H * N * P * 4,
                       rows * (6 * T * N * NG + H * (4 * T * P + 12 * N * P)))
    t.update(bwd_bound)
    res["unfused_bwd"] = t
    # the per-head entry (#6) on the same inputs, timed and held on its own
    t = _timed(lambda: outs.__setitem__("k", ssd_head.ssd_head_bwd(
                   *bwd_args)),
               lambda: outs.__setitem__("p", ssd_chunked_bwd(*bwd_args)))
    t["check"] = hold(f"timed ssd_head_bwd G=4 L={L} bf16", bf16,
                      outs.pop("k"), outs.pop("p"), UNFUSED_BWD_NAMES,
                      tag="ssd-head")
    t.update(bwd_bound)
    res["head_bwd"] = t
    del inp, a, car, bwd_args

    # the paired scan adjoint, v1 geometry
    d, Ns = 512, 16
    Ts = scan.KERNEL_CHUNK
    ncs = -(-L // Ts)
    f = scan_inputs(G, L, d, Ns, torch.bfloat16, 991, model_like=True)
    r = scan_inputs(G, L, d, Ns, torch.bfloat16, 992, model_like=True)
    fa, ra = _scan_args(f), _scan_args(r)
    _, _, carf, carr = scan.bidir_scan_fwd(*fa[:2], *fa[3:5], *ra[:2],
                                           *ra[3:5], fa[2], ra[2], fa[5],
                                           ra[5], fa[6], ra[6],
                                           save_carries=True)
    pargs = (*fa[:2], *fa[3:5], *ra[:2], *ra[3:5], fa[2], ra[2], fa[5], ra[5],
             fa[6], ra[6], f["g_y"], r["g_y"], carf, carr)

    def plain_pair():
        gf = plain_scan.selective_scan_bwd(*fa, f["g_y"], carf, None, True,
                                           False, Ts)
        gr = plain_scan.selective_scan_bwd(*ra, r["g_y"], carr, None, True,
                                           True, Ts)
        return (*gf[:2], *gf[3:5], *gr[:2], *gr[3:5], gf[2], gr[2], gf[5],
                gr[5], gf[6], gr[6])

    t = _timed(lambda: outs.__setitem__("k", scan.bidir_scan_bwd(*pargs)),
               lambda: outs.__setitem__("p", plain_pair()))
    t["check"] = hold(f"timed bidir_scan_bwd G=4 L={L} bf16", bf16,
                      outs.pop("k"), outs.pop("p"), BIDIR_BWD_NAMES,
                      tag="scan-bwd")
    # twice #8's bytes and operations: per set u, delta, g_y, B, C and the
    # carries read, g_u, g_delta, g_B, g_C written
    t.update(_bound(2 * (rows * (3 * d * 2 + 2 * Ns * 2 + 2 * d * 2
                                 + 2 * Ns * 2) + G * ncs * d * Ns * 4),
                    2 * 20 * rows * d * Ns, FP32_FLOP_PER_S))
    t["two_launch_ms"] = _time_cuda(lambda: (
        scan.selective_scan_bwd_cuda(*fa, f["g_y"], carf, None, True, False,
                                     Ts),
        scan.selective_scan_bwd_cuda(*ra, r["g_y"], carr, None, True, True,
                                     Ts)), 3)
    # per set, as #8: the fp32 g_B / g_C shares written and read again
    t["extra_bytes"] = 2 * 2 * scan.n_bc_shares(d) * 2 * rows * Ns * 4
    t["exps"] = 2 * (rows * d * Ns + rows * d)
    res["bidir_bwd"] = t
    for name, t in res.items():
        log(f"[time] {name} G=4 L={L} bf16: kernel {t['ms']:.3f} ms (runs "
            f"{', '.join(f'{v:.3f}' for v in t['kernel_ms_runs'])}), plain "
            f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}: {t['bytes'] / 1e9:.3f} GB, "
            f"{t['flops'] / 1e12:.3f} TFLOP)"
            + (f"; the default two launches of selective_scan_bwd "
               f"{t['two_launch_ms']:.3f} ms" if "two_launch_ms" in t else ""))
    return res


# -- pretraining through the port's own loop (cli.py pretrain) --------------

PRETRAIN_L, PRETRAIN_BATCH, PRETRAIN_ACCUM = 131072, 4, 2
# synthetic hg38 stand-in: 2 contigs of 2^23 bases cut into the production
# window of 2^20 (train, valid and test rows)
GENOME_CONTIGS, GENOME_CONTIG_LEN, GENOME_WINDOW = 2, 1 << 23, 1 << 20


def _pretrain_argv(fasta, bed, config_path, run_dir):
    return ["pretrain", "--fasta", fasta, "--bed", bed,
            "--config-path", config_path, "--run-dir", run_dir,
            "--max-length", str(PRETRAIN_L),
            "--batch-size", str(PRETRAIN_BATCH),
            "--accum-steps", str(PRETRAIN_ACCUM), "--max-steps", "4",
            "--checkpoint-every", "2", "--log-every", "1", "--eval-every", "4",
            "--eval-batches", "1", "--ema-decay", "0.999"]


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    steps = {r["step"]: r for r in rows if "loss" in r}
    evals = [r for r in rows if "val/loss" in r and "step" not in r]
    return steps, evals


def _run_cli(argv, log_path, kill_when=None):
    """`python -m caduceus_tpu_torch.cli` in a subprocess from the checkout
    (output to ``log_path``); with ``kill_when``, SIGKILL it as soon as that
    path exists. Returns the exit code."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(log_path, "ab") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "caduceus_tpu_torch.cli", *argv],
            cwd=root, stdout=out, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None:
                if kill_when is not None and os.path.exists(kill_when):
                    proc.kill()
                    break
                time.sleep(0.02)
            return proc.wait(timeout=1800)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _tail(path, n=40):
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-n:])


def phase_pretrain(workdir, fasta, bed, config, n_layer):
    """Pretrain through `cli.py pretrain` (the port's data loader, `Trainer`,
    checkpoints): run A in this process (launches counted) with the Python
    loader; run B, the same command with the native loader in a
    subprocess, SIGKILLed as soon as its step-2 checkpoint is in place and
    rerun with ``--resume``. B's steps (1-2 before the kill, 3-4 after it)
    must log A's loss, acc, grad_norm and lr, and the two runs end with
    the same parameters, EMA and eval record, bit for bit."""
    from caduceus_tpu_torch import cli
    from caduceus_tpu_torch.train import checkpoint

    name = config.__name__[:-7]
    cfg = config(n_layer=n_layer)
    cfg_path = os.path.join(workdir, f"{name}_{n_layer}.json")
    cfg.save(cfg_path)
    run_a = os.path.join(workdir, f"{name}_a")
    run_b = os.path.join(workdir, f"{name}_b")
    torch.cuda.empty_cache()
    _zero_counts()
    t0 = time.perf_counter()
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        cli.main(_pretrain_argv(fasta, bed, cfg_path, run_a))
    a_s = time.perf_counter() - t0
    counts = _counts()
    gc.collect()   # run A's model and optimizer, before B takes the card
    torch.cuda.empty_cache()
    n_mb = 4 * PRETRAIN_ACCUM
    want = {k: v * n_mb for k, v in _per_micro_batch(cfg).items()}
    # the eval at step 4: one batch through the weights and one through the
    # EMA, each forward one scan launch per direction and layer
    fwd = "ssd_fused_fwd" if cfg.ssm_cfg.version == 2 else "bidir_scan_fwd"
    want[fwd] += 2 * (2 if cfg.ssm_cfg.version == 2 else 1) * n_layer
    check(counts == want, f"pretrain {name}: launches {counts} != {want}")

    log_b = os.path.join(workdir, f"{name}_b.log")
    argv_b = _pretrain_argv(fasta, bed, cfg_path, run_b) + [
        "--use-native-loader"]
    ck_b = os.path.join(run_b, "checkpoints")
    t0 = time.perf_counter()
    rc = _run_cli(argv_b, log_b,
                  kill_when=os.path.join(ck_b, "2", "meta.json"))
    b1_s = time.perf_counter() - t0
    check(rc == -9, f"run B was not killed (exit {rc}):\n{_tail(log_b)}")
    check(checkpoint.latest_step(ck_b) == 2,
          f"run B killed at step {checkpoint.latest_step(ck_b)}, not 2")
    t0 = time.perf_counter()
    rc = _run_cli(argv_b + ["--resume"], log_b)
    b2_s = time.perf_counter() - t0
    check(rc == 0, f"resumed run B failed ({rc}):\n{_tail(log_b)}")

    steps_a, evals_a = _records(run_a)
    steps_b, evals_b = _records(run_b)
    check(sorted(steps_a) == sorted(steps_b) == [1, 2, 3, 4],
          f"logged steps A {sorted(steps_a)}, B {sorted(steps_b)}")
    for s in (1, 2, 3, 4):
        for k in ("loss", "acc", "grad_norm", "lr"):
            check(steps_a[s][k] == steps_b[s][k],
                  f"{name} step {s} {k}: A {steps_a[s][k]!r} != B "
                  f"{steps_b[s][k]!r}")
        check(math.isfinite(steps_a[s]["loss"]), f"step {s}: loss not finite")
    check(len(evals_a) == len(evals_b) == 1 and evals_a == evals_b,
          f"eval records differ: A {evals_a}, B {evals_b}")
    for f in ("params.npz", "ema_params.npz"):
        za = np.load(os.path.join(run_a, "checkpoints", "4", f))
        zb = np.load(os.path.join(run_b, "checkpoints", "4", f))
        check(sorted(za.files) == sorted(zb.files), f"{f}: keys differ")
        for k in za.files:
            check(np.array_equal(za[k], zb[k]), f"{f} {k}: A != B")

    tokens = PRETRAIN_BATCH * PRETRAIN_L
    step_s = {s: tokens / r["tokens_per_sec"] for s, r in steps_a.items()}
    # steps 2 and 4: no warm-up, checkpoint or eval inside their interval
    loop_s = (step_s[2] + step_s[4]) / 2
    log(f"[pretrain] {name}, {n_layer} layers, L={PRETRAIN_L}, "
        f"{PRETRAIN_BATCH} sequences in {PRETRAIN_ACCUM} micro-batches: run "
        f"A (Python loader, in process) {a_s:.1f} s for 4 steps, seconds "
        f"per logged step {', '.join(f'{step_s[s]:.3f}' for s in (1, 2, 3, 4))}"
        f" (loop step {loop_s:.3f} s, {tokens / loop_s:,.0f} tokens/s); run B "
        f"(native loader, subprocess) killed after its step-2 checkpoint "
        f"({b1_s:.1f} s) and resumed ({b2_s:.1f} s): steps 1-4 and the eval "
        f"equal A's bit for bit, params and EMA at step 4 equal; launches "
        f"{counts}; eval {evals_a[0]}")
    return {"n_layer": n_layer, "step_s": step_s, "loop_step_s": loop_s,
            "loop_tokens_per_s": tokens / loop_s, "run_a_s": a_s,
            "run_b_killed_s": b1_s, "run_b_resumed_s": b2_s,
            "launches": counts, "eval": evals_a[0],
            "steps": {s: {k: r[k] for k in ("loss", "acc", "grad_norm", "lr")}
                      for s, r in steps_a.items()},
            "run_a": run_a}


def phase_loader_timing(fasta, bed, n=6):
    """ms per batch of 4 x 131,072 tokens from the Python and the native
    loader (MLM, shuffled train windows), the first batch left out."""
    from caduceus_tpu_torch.data.hg38 import HG38DataModule

    out = {}
    for native in (False, True):
        dm = HG38DataModule(bed, fasta, max_length=PRETRAIN_L,
                            batch_size=PRETRAIN_BATCH, seed=1,
                            use_native=native)
        loader = dm.train_loader()
        try:
            it = iter(loader)
            next(it)
            t0 = time.perf_counter()
            for _ in range(n - 1):
                b = next(it)
            ms = (time.perf_counter() - t0) / (n - 1) * 1e3
        finally:
            loader.close()
        check(b["input_ids"].shape == (PRETRAIN_BATCH, PRETRAIN_L),
              f"loader batch {b['input_ids'].shape}")
        out["native" if native else "python"] = ms
    log(f"[pretrain] loader, batch of {PRETRAIN_BATCH} x {PRETRAIN_L} "
        f"(MLM): Python {out['python']:.1f} ms, native {out['native']:.1f} ms "
        f"(host, {os.cpu_count()} cores)")
    return out


def phase_pretrain_reads(run_a, fasta, bed):
    """`cli.py eval` of run A's test split on the card, and run A (no
    params.npz, only checkpoints) served: a 1,024-token /logits equals a
    direct forward of its latest EMA weights."""
    import io

    from caduceus_tpu_torch import cli
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
    from caduceus_tpu_torch.params import from_jax_params
    from caduceus_tpu_torch.serve import InferenceServer, InferenceService
    from caduceus_tpu_torch.train.checkpoint import read_latest_params

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["eval", "--fasta", fasta, "--bed", bed, "--run-dir", run_a,
                  "--split", "test", "--max-length", str(PRETRAIN_L),
                  "--batch-size", str(PRETRAIN_BATCH), "--max-batches", "1"])
    ev = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(set(ev) == {"test/loss", "test/acc", "test/ppl"}
          and all(math.isfinite(v) for v in ev.values()),
          f"cli eval: {ev}")
    check(not os.path.exists(os.path.join(run_a, "params.npz")),
          "run A has a params.npz export")
    svc = InferenceService.from_run_dir(run_a, device="cuda", max_batch=1,
                                        min_bucket=1024, max_length=1024)
    server = InferenceServer(svc, port=0).start()
    seq = "".join(np.random.default_rng(3).choice(list("ACGT"), 1024))
    try:
        served = np.asarray(_post(server.port, "/logits",
                                  {"sequences": [seq]})["logits"][0],
                            np.float32)
    finally:
        server.stop()
    flat, step = read_latest_params(run_a)
    model = CaduceusForMaskedLM(svc.cfg, device="cuda")
    model.load_state_dict(from_jax_params(flat, svc.cfg))
    ids = torch.from_numpy(svc.tok.encode(seq).astype(np.int64))[None].cuda()
    with torch.inference_mode():
        direct = model(ids)[0].cpu().numpy()
    err = float(np.abs(served - direct).max())
    check(served.shape == direct.shape and err <= 1e-6,
          f"served /logits of the checkpoint differ from a direct forward "
          f"by {err}")
    del model, svc
    torch.cuda.empty_cache()
    log(f"[pretrain] cli eval of run A, test split, 1 batch: {ev}; run A "
        f"served from checkpoints/{step} (EMA): /logits of 1,024 tokens "
        f"equal a direct forward (max |diff| {err:.1e})")
    return {"eval": ev, "serve_max_abs_err": err, "served_step": step}


def _imports_here(*names):
    out = {}
    for n in names:
        try:
            __import__(n)
            out[n] = True
        except ImportError:
            out[n] = False
    return out


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
    report["conv_checks"], report["conv_planted_faults"] = phase_conv_checks()
    report["model_vs_cpu"] = phase_model_vs_cpu()
    report["serve"] = phase_serve()
    report["train_vs_cpu"] = phase_train_vs_cpu()
    # 8 of the 16 layers: the 16-layer step was measured in earlier runs
    # (PERF.md), and the generation phases need the time
    report["train"] = phase_train_full(n_layer=8)
    report["timing"] = phase_timing()
    report["determinism"] = phase_determinism()
    t_gen = time.perf_counter()
    (report["unfused_checks"],
     report["unfused_planted_faults"]) = phase_unfused_checks()
    report["v2_prefill_vs_cpu"] = phase_prefill_vs_cpu(2)
    report["v2_generate"] = phase_generate_serve(2)
    report["unfused_timing"] = phase_unfused_timing()
    report["v2_generate_phase_s"] = time.perf_counter() - t_gen
    t_v1 = time.perf_counter()
    report["scan_checks"], report["scan_planted_faults"] = phase_scan_checks()
    (report["scan_bwd_checks"],
     report["scan_bwd_planted_faults"]) = phase_scan_bwd_checks()
    report["v1_model_vs_cpu"] = phase_model_vs_cpu(hg38_mlm_config)
    report["v1_serve"] = phase_v1_serve()
    report["v1_train_vs_cpu"] = phase_train_vs_cpu(hg38_mlm_config)
    report["mamba_mixer_step"] = phase_mamba_mixer_step()
    report["v1_train"] = phase_train_full(hg38_mlm_config)
    report["scan_timing"] = phase_scan_timing()
    t_gen = time.perf_counter()
    report["v1_prefill_vs_cpu"] = phase_prefill_vs_cpu(1)
    report["v1_generate"] = phase_generate_serve(1)
    report["v1_generate_phase_s"] = time.perf_counter() - t_gen
    report["v1_phase_s"] = time.perf_counter() - t_v1
    # the unfused SSD adjoint and the per-head v2 route (#4, #5, #6)
    t_new = time.perf_counter()
    (report["unfused_bwd_checks"],
     report["unfused_bwd_planted_faults"]) = phase_unfused_bwd_checks()
    report["chained_grad"] = phase_chained_grad()
    report["head_model_vs_cpu"] = phase_model_vs_cpu(
        hg38_mlm_v2_pallas_config)
    report["head_train_vs_cpu"] = phase_train_vs_cpu(
        hg38_mlm_v2_pallas_config)
    report["head_train"] = phase_train_full(hg38_mlm_v2_pallas_config,
                                            n_layer=8)
    report["head_serve"] = phase_head_serve()
    report["head_prefill_vs_cpu"] = phase_prefill_vs_cpu(2, "pallas")
    # the paired v1 backward (#10)
    (report["bidir_bwd_checks"],
     report["bidir_bwd_planted_faults"]) = phase_bidir_bwd_checks()
    with mock.patch.dict(os.environ, {"CADUCEUS_BIDIR_BWD": "1"}):
        log("[train] v1 with the paired backward (CADUCEUS_BIDIR_BWD=1):")
        report["paired_train_vs_cpu"] = phase_train_vs_cpu(hg38_mlm_config)
        report["paired_train"] = phase_train_full(hg38_mlm_config)
    report["new_timing"] = phase_new_timing()
    report["new_phase_s"] = time.perf_counter() - t_new
    # pretraining through the port's own loop: data, Trainer, checkpoints,
    # the CLI, kill and resume
    t_pre = time.perf_counter()
    from caduceus_tpu_torch.data.synthetic import make_synthetic_genome

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pretrain_") as work:
        fasta, bed = make_synthetic_genome(
            os.path.join(work, "genome"), n_chromosomes=GENOME_CONTIGS,
            chrom_len=GENOME_CONTIG_LEN, window=GENOME_WINDOW)
        report["imports"] = _imports_here("tensorstore", "yaml")
        log(f"[pretrain] importable on this machine: {report['imports']}")
        report["loader"] = phase_loader_timing(fasta, bed)
        log("[pretrain] the bare make_train_step at the loop's geometry:")
        report["pretrain_bare"] = phase_train_full(n_layer=16)
        report["pretrain"] = phase_pretrain(work, fasta, bed,
                                            hg38_mlm_v2_config, 16)
        report["pretrain_reads"] = phase_pretrain_reads(
            report["pretrain"].pop("run_a"), fasta, bed)
        report["v1_pretrain"] = phase_pretrain(work, fasta, bed,
                                               hg38_mlm_config, 4)
        report["v1_pretrain"].pop("run_a")
    pre, bare = report["pretrain"], report["pretrain_bare"]
    pre["overhead"] = pre["loop_step_s"] / bare["step_s"] - 1
    log(f"[pretrain] loop step {pre['loop_step_s']:.3f} s against the bare "
        f"step {bare['step_s']:.3f} s at 16 layers: {pre['overhead']:+.1%}")
    report["pretrain_phase_s"] = time.perf_counter() - t_pre
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

    st, t1 = report["scan_timing"], report["v1_train"]
    v1_ms = {"bidir_scan_fwd": st["bidir"]["ms"],
             "selective_scan_bwd": st["bwd"]["ms"]}
    t1["kernel_s_per_step"] = {
        k: t1["launches"][k] // t1["micro_batches"] * t1["accum"] * v / 1e3
        for k, v in v1_ms.items()}
    t1["kernel_share"] = sum(t1["kernel_s_per_step"].values()) / t1["step_s"]
    shares = ", ".join(f"{k} {v:.2f} s"
                       for k, v in t1["kernel_s_per_step"].items())
    log(f"[train] derived, v1: kernels take {t1['kernel_share']:.1%} of the "
        f"step ({shares})")
    nt, ht = report["new_timing"], report["head_train"]
    head_ms = {"ssd_head_fwd": nt["head_fwd"]["ms"],
               "ssd_head_bwd": nt["head_bwd"]["ms"]}
    ht["kernel_s_per_step"] = {
        k: ht["launches"][k] // ht["micro_batches"] * ht["accum"] * v / 1e3
        for k, v in head_ms.items()}
    ht["kernel_share"] = sum(ht["kernel_s_per_step"].values()) / ht["step_s"]
    shares = ", ".join(f"{k} {v:.2f} s"
                       for k, v in ht["kernel_s_per_step"].items())
    log(f"[train] derived, per-head v2: kernels take {ht['kernel_share']:.1%} "
        f"of the step ({shares})")

    replaces = {
        "ssd_fused_fwd": "caduceus_tpu/ops/ssd_pallas_batched.py:173",
        "ssd_fwd": "caduceus_tpu/ops/ssd_pallas_batched.py:173",
        "ssd_fused_bwd_kernel": "caduceus_tpu/ops/ssd_pallas_batched.py:486",
        "ssd_conv_bwd_kernel": "caduceus_tpu/ops/ssd_pallas_batched.py:486",
        "ssd_head_fwd": "caduceus_tpu/ops/ssd_pallas.py:114",
        "ssd_head_bwd": "caduceus_tpu/ops/ssd_pallas.py:312",
        "ssd_bwd": "caduceus_tpu/ops/ssd_pallas_batched.py:486",
        "selective_scan_fwd": "caduceus_tpu/ops/scan_pallas.py:153",
        "bidir_scan_fwd": "caduceus_tpu/ops/scan_pallas_bidir.py:37",
        "selective_scan_bwd": "caduceus_tpu/ops/scan_pallas.py:462",
        "bidir_scan_bwd": "caduceus_tpu/ops/scan_pallas_bidir.py:210"}

    def entry(name, source, t, launches, err, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces[name],
                "launches": launches, "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "check": "pass", **extra}

    f16 = tm["fwd_G16"]
    ut = report["unfused_timing"]
    # the backward's two kernels split its bound; the workspace traffic of
    # the split stands beside it
    pair = {"function_bound_ms": tm["bwd_function_bound"]["bound_ms"]}
    kernels = {"kernels": [
        entry("ssd_fused_fwd", "caduceus_tpu_torch/csrc/ssd_fused_fwd.cu",
              tm["fwd_G4_carries"], tr["launches"]["ssd_fused_fwd"],
              tm["fwd_G4_carries"]["check"]["y"]["max_abs_err"],
              shape="G=4 L=131072 bf16, carries saved",
              segments=tm["fwd_G4_carries"]["segments"],
              sub_launches=tm["fwd_G4_carries"]["sub_launches"],
              launches_serve=report["serve"]["launches"],
              launches_pretrain=pre["launches"]["ssd_fused_fwd"],
              serve_G16={k: f16[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")}),
        entry("ssd_fwd", "caduceus_tpu_torch/csrc/ssd_fused_fwd.cu", ut["G1"],
              report["v2_generate"]["launches"],
              ut["G1"]["check"]["y"]["max_abs_err"],
              shape="G=1 L=131072 bf16 (one 131k prefill), no carries",
              launches_path="/generate of the v2 causal model: prompts of "
              "1,000 and 131,072 tokens, 16 layers each",
              G4={k: ut["G4"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by")},
              G1_fp32={k: ut["G1_fp32"][k] for k in ("ms", "plain_ms",
                                                      "bound_ms", "bound_by")}),
        entry("ssd_fused_bwd_kernel", "caduceus_tpu_torch/csrc/ssd_fused_bwd.cu",
              tm["bwd_main"], tr["launches"]["ssd_fused_bwd_kernel"],
              tm["bwd_main"]["check"]["g_xc"]["max_abs_err"],
              shape="G=4 L=131072 bf16",
              segments=tm["bwd_main"]["segments"],
              sub_launches=tm["bwd_main"]["sub_launches"],
              extra_bytes=tm["bwd_main"]["extra_bytes"],
              launches_pretrain=pre["launches"]["ssd_fused_bwd_kernel"],
              **pair),
        entry("ssd_conv_bwd_kernel", "caduceus_tpu_torch/csrc/ssd_fused_bwd.cu",
              tm["bwd_conv"], tr["launches"]["ssd_conv_bwd_kernel"],
              tm["bwd_conv"]["check"]["g_xBC"]["max_abs_err"],
              shape="G=4 L=131072 bf16",
              extra_bytes=tm["bwd_conv"]["extra_bytes"],
              floor_ms=tm["bwd_conv"]["floor"]["bound_ms"],
              library_pair_ms=tm["bwd_conv"]["library_pair"]["ms"],
              library_pair="2 calls: torch.ops.aten.silu_backward + "
              "convolution_backward (depthwise, fp32, pre and padded xBC "
              "made beforehand)",
              launches_pretrain=pre["launches"]["ssd_conv_bwd_kernel"],
              **pair),
        entry("selective_scan_fwd",
              "caduceus_tpu_torch/csrc/selective_scan_fwd.cu", st["fwd"],
              report["mamba_mixer_step"]["launches"]["selective_scan_fwd"],
              st["fwd"]["check"]["y"]["max_abs_err"],
              shape="G=4 L=131072 bf16, one direction, carries saved",
              launches_path="MambaMixer train step (2 layers, accum 2)",
              launches_generate=report["v1_generate"]["launches"],
              exps=st["fwd"]["exps"], exp_ms=st["fwd"]["exp_ms"],
              exps_softplus=st["fwd"]["exps_softplus"],
              G1_fp32={k: st["fwd_G1_fp32"][k] for k in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "exps", "exp_ms")},
              G1_bf16={k: st["fwd_G1_bf16"][k] for k in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "exps", "exp_ms")},
              gated={k: st["fwd_gated"][k] for k in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "exps", "exp_ms")}),
        entry("bidir_scan_fwd",
              "caduceus_tpu_torch/csrc/selective_scan_fwd.cu", st["bidir"],
              t1["launches"]["bidir_scan_fwd"],
              st["bidir"]["check"]["yf"]["max_abs_err"],
              shape="G=4 L=131072 bf16, two directions, carries saved",
              launches_serve=report["v1_serve"]["launches"],
              launches_pretrain=report["v1_pretrain"]["launches"][
                  "bidir_scan_fwd"],
              exps=st["bidir"]["exps"], exp_ms=st["bidir"]["exp_ms"],
              exps_softplus=st["bidir"]["exps_softplus"]),
        entry("selective_scan_bwd",
              "caduceus_tpu_torch/csrc/selective_scan_bwd.cu", st["bwd"],
              t1["launches"]["selective_scan_bwd"],
              st["bwd"]["check"]["g_u"]["max_abs_err"],
              shape="G=4 L=131072 bf16, one direction",
              extra_bytes=st["bwd"]["extra_bytes"],
              launches_pretrain=report["v1_pretrain"]["launches"][
                  "selective_scan_bwd"],
              bc_shares=st["bwd"]["bc_shares"],
              sub_launches=st["bwd"]["sub_launches"],
              exps=st["bwd"]["exps"], exp_ms=st["bwd"]["exp_ms"],
              exps_softplus=st["bwd"]["exps_softplus"]),
        entry("ssd_head_fwd", "caduceus_tpu_torch/csrc/ssd_fused_fwd.cu",
              nt["head_fwd"], ht["launches"]["ssd_head_fwd"],
              nt["head_fwd"]["check"]["y"]["max_abs_err"],
              shape="G=4 L=131072 bf16, carries saved (the K = 0 kernel of "
              "ssd_fwd, per-head entry ops/ssd_head.py)",
              launches_path="use_kernel=pallas train step, 8 layers",
              launches_serve=report["head_serve"]["launches"]),
        entry("ssd_head_bwd", "caduceus_tpu_torch/csrc/ssd_fused_bwd.cu",
              nt["head_bwd"], ht["launches"]["ssd_head_bwd"],
              nt["head_bwd"]["check"]["g_x"]["max_abs_err"],
              shape="G=4 L=131072 bf16 (the K = 0 kernel of ssd_bwd, "
              "per-head entry ops/ssd_head.py)",
              launches_path="use_kernel=pallas train step, 8 layers"),
        entry("ssd_bwd", "caduceus_tpu_torch/csrc/ssd_fused_bwd.cu",
              nt["unfused_bwd"], report["chained_grad"]["launches"]["ssd_bwd"],
              nt["unfused_bwd"]["check"]["g_x"]["max_abs_err"],
              shape="G=4 L=131072 bf16",
              launches_path="ssd_batched_chained under autograd: two "
              "chained calls and one whole call"),
        entry("bidir_scan_bwd",
              "caduceus_tpu_torch/csrc/selective_scan_bwd.cu", nt["bidir_bwd"],
              report["paired_train"]["launches"]["bidir_scan_bwd"],
              nt["bidir_bwd"]["check"]["g_uf"]["max_abs_err"],
              shape="G=4 L=131072 bf16, two directions",
              launches_path="v1 train step with CADUCEUS_BIDIR_BWD=1, 16 "
              "layers", two_launch_ms=nt["bidir_bwd"]["two_launch_ms"],
              extra_bytes=nt["bidir_bwd"]["extra_bytes"],
              exps=nt["bidir_bwd"]["exps"]),
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
