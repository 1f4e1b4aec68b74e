#!/usr/bin/env python3
"""Where a chunk's time goes in the SSD kernels' main passes, on the card.

    python3 ssd_phase_cutouts.py

from the root of a checkout on a machine with a CUDA card and nvcc. It
writes copies of `caduceus_tpu_torch/csrc/ssd_fused_fwd.cu` and
`ssd_fused_bwd.cu` into `build/cutouts/`, each with one phase of the main
pass cut out (the x conv, the carries' writes, the WMMA products, the
decays' exps, the g_B / g_C share writes, ...) or changed (`expf` ->
`__expf`), builds them side by side, and times each variant's main pass
(`parts` = the main pass only, on the workspace of a full call) at the
training shape (G=4, L=131072, bf16), in two rounds of opposite order. A
cut-out's saving is an upper bound of what its phase costs: what it leaves
out no longer waits for anything. The variants compute wrong values; they
are timed, never checked, and the port never loads them.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs
from caduceus_tpu_torch import _build
from caduceus_tpu_torch.ops import ssd_batched as sb

OUT = os.path.join("build", "cutouts")
FWD_MAIN = ("ssd_fwd_kernel(const Params p) {", "// Sub-launches of one call")
BWD_MAIN = ("ssd_fused_bwd_kernel(const Params p) {", "// g_B / g_C of every row")


def _cut(src, span, old, new=""):
    """``src`` with ``old`` replaced by ``new`` inside the kernel ``span``."""
    i0 = src.index(span[0])
    i1 = src.index(span[1], i0)
    body = src[i0:i1]
    if old not in body:
        raise ValueError(f"not in the kernel: {old[:60]!r}")
    return src[:i0] + body.replace(old, new) + src[i1:]


def variants():
    """{name: (source file, text)}: the main passes with one phase cut."""
    csrc = _build.SRC_DIR
    fwd = open(os.path.join(csrc, "ssd_fused_fwd.cu")).read()
    bwd = open(os.path.join(csrc, "ssd_fused_bwd.cu")).read()
    fast = '#include "ssd_common.cuh"\n#define expf __expf\n'
    v = {"fwd base": ("ssd_fused_fwd", fwd), "bwd base": ("ssd_fused_bwd", bwd)}
    v["fwd expf -> __expf"] = ("ssd_fused_fwd", fwd.replace(
        '#include "ssd_common.cuh"\n', fast, 1))
    v["fwd no x conv"] = ("ssd_fused_fwd", _cut(
        fwd, FWD_MAIN,
        "conv_x_staged<S, K, T>(sm.xr, P, p.conv_w, p.conv_b, p.Wc, hh * P, "
        "row0, L, rev, sm.xf);",
        "for (int i2 = tid; i2 < T * P; i2 += NTHREADS) "
        "sm.xf[i2] = to_f<S>(sm.xr[i2]);"))
    v["fwd no carries"] = ("ssd_fused_fwd", _cut(fwd, FWD_MAIN,
                                                 "if (car) car[i2] = v;"))
    s = fwd
    for old in ("BlockMM<S, false, false>::run(sm.Cs, sm.ldN, sm.hS, sm.ldhS, "
                "sm.Yf, sm.ldPf, T, P, N,\n                                  "
                "false, 0.f);",
                "BlockMM<S, false, false>::run(sm.MS, sm.ldTS, sm.dxS, sm.ldPS, "
                "sm.Yf, sm.ldPf, T, P, T,\n                                  "
                "true, 1.f);",
                "BlockMM<S, true, false>::run(sm.Bs, sm.ldN, sm.wdxS, sm.ldPS, "
                "sm.h, sm.ldh, N, P, T,\n                                 "
                "true, expf(total));"):
        s = _cut(s, FWD_MAIN, old)
    v["fwd no WMMA products"] = ("ssd_fused_fwd", s)
    s = _cut(fwd, FWD_MAIN, "sm.CB[i2] * expf(sm.cum[t] - sm.cum[s2])",
             "sm.CB[i2]")
    v["fwd no M / y decays"] = ("ssd_fused_fwd", _cut(
        s, FWD_MAIN, "yv = expf(sm.cum[t]) * yv", "yv = yv"))
    v["bwd expf -> __expf"] = ("ssd_fused_bwd", bwd.replace(
        '#include "ssd_common.cuh"\n', fast, 1))
    s = _cut(bwd, BWD_MAIN, "if (r < L) share[r * share_sl + N + nn] = v;")
    v["bwd no share writes"] = ("ssd_fused_bwd", _cut(
        s, BWD_MAIN, "if (r < L) share[r * share_sl + nn] = v;"))
    v["bwd no C @ h_in (carries)"] = ("ssd_fused_bwd", _cut(
        bwd, BWD_MAIN, "BlockMM<S, false, false>::run(sm.Cs, sm.ldN, hin, P, "
        "sm.ChD, sm.ldPf, T, P, N, false, 0.f);"))
    s = bwd
    for old in ("BlockMM<S, false, true>::run(sm.gyS, sm.ldPS, sm.dxS, sm.ldPS, "
                "sm.Gf, sm.ldTf, T, T, P, false,\n                                 "
                "0.f);",
                "BlockMM<S, false, false>::run(sm.Bs, sm.ldN, sm.lamS, sm.ldlS, "
                "sm.Blam, sm.ldPf, T, P, N,\n                                  "
                "false, 0.f);",
                "BlockMM<S, false, false>::run(sm.Cs, sm.ldN, hin, P, sm.ChD, "
                "sm.ldPf, T, P, N, false, 0.f);"):
        s = _cut(s, BWD_MAIN, old)
    v["bwd no phase-B products"] = ("ssd_fused_bwd", s)
    s = bwd
    for old, new in (("i / P", "(i >> 6)"), ("i % P", "(i & 63)")):
        s = _cut(s, BWD_MAIN, old, new)
    v["bwd P = 64 known"] = ("ssd_fused_bwd", s)
    return v


def build(v):
    """Each variant's library, built side by side (its header beside it)."""
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(_build.SRC_DIR, "ssd_common.cuh")) as f:
        header = f.read()
    with open(os.path.join(OUT, "ssd_common.cuh"), "w") as f:
        f.write(header)

    def one(item):
        i, (name, (_, text)) = item
        src = os.path.join(OUT, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"v{i}.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                               src], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        return name, ctypes.CDLL(lib)

    with ThreadPoolExecutor(8) as pool:
        return dict(pool.map(one, enumerate(v.items())))


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_phase_cutouts: needs a CUDA card", file=sys.stderr)
        return 1
    v = variants()
    libs = build(v)

    def use(name):
        def fn(entry):
            f = getattr(libs[name], entry)
            f.argtypes, f.restype = sb._ARGTYPES[entry], ctypes.c_int
            return f
        sb._fn = fn

    G, L, H, P, NG, N, K = 4, 131072, 8, 64, 1, 128, 4
    T = sb.KERNEL_CHUNK[torch.bfloat16]
    inp = cs.ssd_inputs(G, L, H, P, NG, N, K, torch.bfloat16, 98,
                        width_pad=512)
    a7 = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
          inp["D"], inp["dt_bias"])
    fwd_args = a7 + (inp["dims"], True, False, T, None, True)
    use("fwd base")
    _, _, car, ws_f = sb.fused_fwd_call(*fwd_args)
    bwd_args = a7 + (inp["g_y"], car, None, inp["dims"], True, False, T)
    use("bwd base")
    _, ws_b = sb.adjoint_xc_call(*bwd_args)

    def main_pass_ms(name):
        use(name)
        if v[name][0] == "ssd_fused_fwd":
            call = lambda: sb.fused_fwd_call(*fwd_args, parts=sb.PART_MAIN,
                                             ws=ws_f)
        else:
            call = lambda: sb.adjoint_xc_call(*bwd_args, parts=sb.PART_MAIN,
                                              ws=ws_b)
        call()
        return cs._time_cuda(call, 5)

    names = list(v)
    runs = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            runs[n].append(main_pass_ms(n))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[cutouts] main passes at G={G} L={L} bf16, {smi}")
    for n in names:
        base = runs["fwd base" if n.startswith("fwd") else "bwd base"]
        ms = sum(runs[n]) / 2
        print(f"[cutouts] {n}: {ms:.3f} ms (runs "
              f"{', '.join(f'{x:.3f}' for x in runs[n])}); "
              f"{ms - sum(base) / 2:+.3f} ms against the base")
    return 0


if __name__ == "__main__":
    sys.exit(main())
