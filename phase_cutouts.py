#!/usr/bin/env python3
"""Where a chunk's time goes in the port's kernels, on the card.

    python3 phase_cutouts.py [--set ssd|scan|scan-prefill|scan-pr6|conv|
                                    attn|attn-pr12] [--tree DIR] [--only TEXT]

from the root of a checkout on a machine with a CUDA card and nvcc. It
writes copies of kernel sources into `build/cutouts/`, each with one phase
cut out (a product, a reduction, the exps, the barriers, the staging loads,
...) or changed (`expf` -> `__expf`), builds them side by side, and times
each variant in two rounds of opposite order. A cut-out's saving is an upper
bound of what its phase costs: what it leaves out no longer waits for
anything. The variants compute wrong values; they are timed, never checked,
and the port never loads them.

Sets (ssd and scan by default; `--set` repeats, and takes conv too):
- ssd: the main passes of `ssd_fused_fwd.cu` / `ssd_fused_bwd.cu` (`parts` =
  the main pass only, on the workspace of a full call), G=4, L=131072, bf16;
- scan: the selective-scan kernels `selective_scan_fwd.cu` (timed through
  `bidir_scan_fwd`, two sets with carries) and `selective_scan_bwd.cu`
  (`selective_scan_bwd`: main pass and share sum), G=4, L=131072, d=512,
  N=16, bf16; also changed settings (a launch bound, other cluster sizes of
  the g_B / g_C sum, tried alternatives);
- scan-prefill: `selective_scan_fwd` at the v1 prefill's shape (G=1,
  L=131072, d=512, N=16, fp32: 128 blocks of 4 warps), with phases cut and
  settings changed (the state loop's unrolling, the grid of 8-warp blocks),
  and in bf16 the blocks of 8 against blocks of 4;
- conv: the SiLU + conv adjoint `ssd_conv_bwd` (#3b: the streaming kernel
  and its fixed-order weight sum), G=4, L=131072, Wc=768, bf16, with the
  staging, the halo rows, the partial sums, the weight-sum launch, the exps
  or the output stores cut, and settings changed (ring stages, rows a
  stage, warps a block, rows a tile);
- scan-pr6: the same two calls on the scan kernels as they were before their
  redesign (a thread per (channel, n), 64-row chunks walked serially);
  give the root of a checkout of that version with ``--tree``: its package,
  sources and `chip_smoke.py` are the ones imported and cut;
- attn: the bf16 flash-attention kernels (#11: `attn_fwd`, `attn_bwd_dkv`,
  `attn_bwd_dq`, the `wgmma` design) at the Hyena path's shape, G=2,
  L=65536, H=8, hd=32, causal, with one phase cut out each (the exps, each
  product, the ring's loads, the masks) and settings changed (ring slots,
  blocks an SM);
- attn-pr12: the same three calls on the attention kernels before their
  Hopper redesign (commit 40651ec: 4-warp `mma.sync` blocks, P and dS
  through shared memory): give the root of an export of that version with
  ``--tree``; its sources (header inlined) are built and launched through
  this checkout's wrappers, whose C interface is the same, so ``--set attn
  --set attn-pr12 --only base`` times both designs in turns in one process.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

OUT = os.path.join("build", "cutouts")
FWD_MAIN = ("ssd_fwd_kernel(const Params p) {", "// Sub-launches of one call")
BWD_MAIN = ("ssd_fused_bwd_kernel(const Params p) {", "// g_B / g_C of every row")
PR6_FWD = ("selective_scan_fwd_kernel(const Params p) {", "cudaError_t launch(")
PR6_BWD = ("selective_scan_bwd_kernel(const Params p) {", "// Zero each set's")


def _cut(src, span, old, new="", count=None):
    """``src`` with ``old`` replaced by ``new`` inside the kernel ``span``
    (every occurrence, or exactly ``count`` of them)."""
    i0 = src.index(span[0])
    i1 = src.index(span[1], i0)
    body = src[i0:i1]
    n = body.count(old)
    if n == 0 or (count is not None and n != count):
        raise ValueError(f"{n} times in the kernel: {old[:60]!r}")
    return src[:i0] + body.replace(old, new) + src[i1:]


def _cuts(src, span, pairs):
    for old, new in pairs:
        src = _cut(src, span, old, new)
    return src


def ssd_variants(csrc):
    """{name: (library, text)}: the SSD main passes with one phase cut."""
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


def scan_pr6_variants(csrc):
    """The scan kernels before their redesign, one phase cut each."""
    fwd = open(os.path.join(csrc, "selective_scan_fwd.cu")).read()
    bwd = open(os.path.join(csrc, "selective_scan_bwd.cu")).read()
    L, B = "selective_scan_fwd", "selective_scan_bwd"
    sync = "__syncthreads();"
    v = {"scan fwd base": (L, fwd), "scan bwd base": (B, bwd)}
    v["scan fwd no y reduction"] = (L, _cut(
        fwd, PR6_FWD, "if (r < L && cs < d) y[r * d + cs] = from_f<S>(yv + "
        "D_c * us[i]);"))
    v["scan fwd no C h stores"] = (L, _cut(
        fwd, PR6_FWD, "ps[t * NTHREADS + tid] = Cs[t * N + n] * h;",
        "if (k == T - 1) ps[tid] = Cs[t * N + n] * h;"))
    v["scan fwd no barriers"] = (L, _cut(fwd, PR6_FWD, sync, "", 3))
    v["scan fwd exp2f -> constant"] = (L, _cut(
        fwd, PR6_FWD, "exp2f(dd * A2)", "(0.999f + dd * 0.f * A2)"))
    v["scan fwd no next-chunk loads"] = (L, _cut(
        fwd, PR6_FWD, "if (ci + 1 < nc) load_chunk<S>(", "if (ci < 0) "
        "load_chunk<S>("))
    v["scan bwd no g_B / g_C atomics"] = (B, _cuts(bwd, PR6_BWD, (
        ("atomicAdd(&gC_g[r * N + nn], s0 + s1);", ""),
        ("atomicAdd(&gB_g[r * N + nn], s0 + s1);", ""))))
    v["scan bwd exp2f -> constant"] = (B, _cuts(bwd, PR6_BWD, (
        ("ea[j] = exp2f(dd * A2);", "ea[j] = 0.999f + dd * 0.f * A2;"),
        ("ea[j] = exp2f(dd[j] * A2);", "ea[j] = 0.999f + dd[j] * 0.f * A2;"))))
    v["scan bwd no barriers"] = (B, _cuts(bwd, PR6_BWD, (
        ("    __syncthreads();\n\n", "\n\n"),
        ("__syncthreads();  // the walk", "// the walk"),
        ("__syncthreads();  // the next chunk's", "// the next chunk's"))))
    v["scan bwd no chunk loads"] = (B, _cut(
        bwd, PR6_BWD, "load_chunk<S>(q, g, row0, L, c0, CW, d, N, regs);",
        "regs = ChunkRegs<S>{};"))
    return v


NEW_FWD = ("__device__ void walk(", "template <typename S>\ncudaError_t launch_t(")
NEW_BWD = ("__device__ void adjoint(", "// g_B and g_C: the clusters' shares")


def scan_variants(csrc):
    """The redesigned scan kernels, one phase cut each."""
    fwd = open(os.path.join(csrc, "selective_scan_fwd.cu")).read()
    bwd = open(os.path.join(csrc, "selective_scan_bwd.cu")).read()
    F, B = "selective_scan_fwd", "selective_scan_bwd"
    const = ("dA[i] = ex2(dd[a] * A2);", "dA[i] = 0.999f + dd[a] * 0.f * A2;")
    v = {"scan fwd base": (F, fwd), "scan bwd base": (B, bwd)}
    v["scan fwd exp2f -> constant"] = (F, _cut(fwd, NEW_FWD, *const))
    v["scan fwd no warp scan"] = (F, _cut(fwd, NEW_FWD, "scan_up(P, H, lane);"))
    v["scan fwd no next-chunk staging"] = (F, _cut(
        fwd, NEW_FWD, "if (ci + 1 < nc) stage_chunk<S, W>(", "if (ci < 0) "
        "stage_chunk<S, W>("))
    v["scan fwd no B / C transposes"] = (F, _cuts(fwd, NEW_FWD, (
        ("transpose_bc<S, float, NT>(sm.B, Bt, N);", ""),
        ("transpose_bc<S, float, NT>(sm.C, Ct, N);", ""))))
    v["scan fwd no y stores"] = (F, _cut(fwd, NEW_FWD, "if (row0 + t < L)\n",
                                         "if (row0 + t < 0)\n"))
    v["scan bwd exp2f -> constant"] = (B, _cut(bwd, NEW_BWD, *const))
    v["scan bwd no warp scans"] = (B, _cuts(bwd, NEW_BWD, (
        ("scan_up(P, H, lane);", ""), ("scan_down(P, K, lane);", ""))))
    v["scan bwd no next-chunk staging"] = (B, _cut(
        bwd, NEW_BWD, "if (ci + 1 < nc) {", "if (ci < 0) {"))
    v["scan bwd no cluster sum"] = (B, _cuts(bwd, NEW_BWD, (
        ("cluster.sync();\n    {", "{"),
        ("for (int v = rank * per + tid;", "for (int v = rank * per + tid + V;"),
        ("cluster.sync();  // the slices", "// the slices"))))
    v["scan bwd no per-state g_B / g_C sum"] = (B, _cuts(bwd, NEW_BWD, (
        ("      __syncthreads();\n      // g_A's share", "      // g_A's share"),
        ("for (int k = 0; k < WARPS; ++k) {\n          sB",
         "for (int k = 0; k < 0; ++k) {\n          sB"))))
    v["scan bwd no g_A warp sum"] = (B, _cut(
        bwd, NEW_BWD, "for (int off = 16; off > 0; off >>= 1) ga += ",
        "for (int off = 0; off > 0; off >>= 1) ga += "))
    v["scan bwd 1 block per SM (no spills)"] = (B, bwd.replace(
        "__launch_bounds__(NTHREADS, 2) selective", "__launch_bounds__(NTHREADS, 1) selective"))
    v["scan bwd half the states"] = (B, _cut(
        bwd, NEW_BWD, "for (int n = 0; n < N; ++n) {", "for (int n = 0; n < N / 2; ++n) {"))
    v["scan bwd no per-state barrier"] = (B, _cut(
        bwd, NEW_BWD, "      __syncthreads();\n      // g_A's share", "      // g_A's share"))
    # the adjoint's g_B / g_C sum over clusters of up to 1, 4 or 8 blocks
    # (the wrapper's choice is 2): the same source, `ops/scan.py`'s constant
    # patched while the variant is timed
    for cl in (1, 4, 8):
        v[f"scan bwd clusters of up to {cl} block{'s' * (cl > 1)}"] = (
            B, bwd, {"_MAX_CLUSTER": cl})
    v["scan fwd no softplus"] = (F, _cut(
        fwd, NEW_FWD, "if (p.dt_softplus) x = softplus(x);", ""))
    v["scan bwd no softplus"] = (B, _cut(
        bwd, NEW_BWD, "if (p.dt_softplus) x = softplus(x);", ""))
    v["scan bwd no g_u / g_delta stores"] = (B, _cuts(bwd, NEW_BWD, (
        ("store_tile<S>(tu, gu_g, row0, L, c0, d, vec_out);", ""),
        ("store_tile<S>(td, gd_g, row0, L, c0, d, vec_out);", ""))))
    v["scan bwd no B / C transposes"] = (B, _cuts(bwd, NEW_BWD, (
        ("transpose_bc<S, S>(sm.B, sm.Bt, N);", ""),
        ("transpose_bc<S, S>(sm.C, sm.Ct, N);", ""))))
    common = open(os.path.join(csrc, "scan_common.cuh")).read()
    l2 = ("cp.async.cg.shared.global [%0], [%1], 16, %2;",
          "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;")
    # the variants below change the shared header: it is inlined into a copy
    # of each source
    inline = lambda src, hdr: src.replace('#include "scan_common.cuh"', hdr, 1)
    v["scan fwd cp.async with L2::128B prefetch"] = (F, inline(
        fwd, common.replace(*l2)))
    v["scan bwd cp.async with L2::128B prefetch"] = (B, inline(
        bwd, common.replace(*l2)))
    series = common.replace(
        "return fmaxf(x, 0.f) + log1pf(__expf(-fabsf(x)));",
        "const float e = __expf(-fabsf(x)), s = e / (2.f + e), s2 = s * s;\n"
        "  float p = fmaf(s2, 1.f / 15, 1.f / 13);\n"
        "  p = fmaf(s2, p, 1.f / 11); p = fmaf(s2, p, 1.f / 9);"
        " p = fmaf(s2, p, 1.f / 7);\n"
        "  p = fmaf(s2, p, 1.f / 5); p = fmaf(s2, p, 1.f / 3);"
        " p = fmaf(s2, p, 1.f);\n"
        "  return fmaxf(x, 0.f) + 2.f * s * p;")
    v["scan fwd softplus by an atanh series"] = (F, inline(fwd, series))
    v["scan bwd softplus by an atanh series"] = (B, inline(bwd, series))
    v["scan bwd cluster reads 4 at a time"] = (B, _cut(bwd, NEW_BWD, """\
      for (int v = rank * per + tid; v < (rank + 1) * per; v += NTHREADS) {
        const int t = v % CH, qn = v / CH;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < MAX_CLUSTER; ++k)
          if (k < CL) s += cluster.map_shared_rank(sm.Sb, k)[v];
        // v = (q N + n) CH + t -> share (q, g, n, row)
        if (row0 + t < L)
          bc_share[(((long long)(qn / N) * G + g) * N + qn % N) * L + row0 + t] = s;
      }""", """      const int end = (rank + 1) * per;
      for (int v0 = rank * per + tid; v0 < end; v0 += 4 * NTHREADS) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < MAX_CLUSTER; ++k) {
          if (k < CL) {
            const float* src = cluster.map_shared_rank(sm.Sb, k);
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (v0 + u * NTHREADS < end) s[u] += src[v0 + u * NTHREADS];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int v = v0 + u * NTHREADS, t = v % CH, qn = v / CH;
          if (v < end && row0 + t < L)
            bc_share[(((long long)(qn / N) * G + g) * N + qn % N) * L + row0 + t] = s[u];
        }
      }"""))
    v["scan fwd half the states"] = (F, _cut(
        fwd, NEW_FWD, "for (int n = 0; n < N; ++n) {", "for (int n = 0; n < N / 2; ++n) {"))
    v["scan fwd no re-walk (pass 2)"] = (F, _cut(
        fwd, NEW_FWD, "y_[a] = fmaf(c[a], h, y_[a]);",
        "if (i == R - 1) y_[a] = fmaf(c[a], h, y_[a]);"))
    v["scan fwd state loop unrolled by 2"] = (F, _cut(
        fwd, NEW_FWD, UNROLL, "#pragma unroll 2"))
    return v


# the forward's state loop: unrolled by 2 in the 4-warp blocks
UNROLL = "#pragma unroll (W == 4 ? 2 : 1)"


def prefill_variants(csrc):
    """The forward kernel at the v1 prefill's shape (`selective_scan_fwd`,
    G=1, fp32: 128 blocks of 4 warps), one phase cut or one setting changed
    each."""
    fwd = open(os.path.join(csrc, "selective_scan_fwd.cu")).read()
    F = "prefill"
    v = {"prefill fwd base": (F, fwd)}
    v["prefill fwd half the states"] = (F, _cut(
        fwd, NEW_FWD, "for (int n = 0; n < N; ++n) {",
        "for (int n = 0; n < N / 2; ++n) {"))
    v["prefill fwd exp2f -> constant"] = (F, _cut(
        fwd, NEW_FWD, "dA[i] = ex2(dd[a] * A2);",
        "dA[i] = 0.999f + dd[a] * 0.f * A2;"))
    v["prefill fwd no warp scan"] = (F, _cut(fwd, NEW_FWD,
                                             "scan_up(P, H, lane);"))
    v["prefill fwd no next-chunk staging"] = (F, _cut(
        fwd, NEW_FWD, "if (ci + 1 < nc) stage_chunk<S, W>(", "if (ci < 0) "
        "stage_chunk<S, W>("))
    v["prefill fwd no B / C transposes"] = (F, _cuts(fwd, NEW_FWD, (
        ("transpose_bc<S, float, NT>(sm.B, Bt, N);", ""),
        ("transpose_bc<S, float, NT>(sm.C, Ct, N);", ""))))
    v["prefill fwd state loop not unrolled"] = (F, _cut(
        fwd, NEW_FWD, UNROLL, "#pragma unroll 1"))
    v["prefill fwd state loop unrolled by 4"] = (F, _cut(
        fwd, NEW_FWD, UNROLL, "#pragma unroll (W == 4 ? 4 : 1)"))
    # the grid before: 64 blocks of 8 warps, the state loop not unrolled
    v["prefill fwd 8 warps a block (64 blocks)"] = (F, _cut(
        fwd, NEW_FWD, "if (blocks8 < sm_count()) return launch_w<S, Z, N, 4>"
        "(p, nsets, s);\n", ""))
    # in bf16 (blocks of 8 by the rule): blocks of 4, staged by plain loads
    v["prefill-bf16 fwd base"] = ("prefill-bf16", fwd)
    v["prefill-bf16 fwd 4 warps a block (128 blocks)"] = ("prefill-bf16", _cut(
        fwd, NEW_FWD, "if constexpr (sizeof(S) == 4) {", "if constexpr (true) {"))
    return v


CONV = ("ssd_conv_bwd_kernel(const ConvParams p) {", "// g_conv_w / g_conv_b: the tiles")
CONV_LANE = ("struct ConvLane {", "template <typename S, int K, bool REV>\n__global__")


def conv_variants(csrc):
    """The SiLU + conv adjoint (`ssd_conv_bwd`: the streaming kernel and the
    fixed-order weight sum), one phase cut or one setting changed each."""
    bwd = open(os.path.join(csrc, "ssd_fused_bwd.cu")).read()
    C = "conv"
    v = {"conv base": (C, bwd)}
    v["conv no staging (stale rows)"] = (C, _cut(
        bwd, CONV_LANE, "if (q + CONV_NST - 1 < nq) stage(", "if (q < 0) stage("))
    v["conv no halo rows"] = (C, _cut(bwd, CONV_LANE, "E = n + 2 * HK;", "E = n;"))
    v["conv no partial sums"] = (C, _cuts(bwd, CONV_LANE, (
        ("aw[k][j] = fmaf(xw[k][j], gp[j], aw[k][j]);", ";"),
        ("ab[j] += gp[j];", ";"))))
    v["conv no weight-sum launch"] = (C, bwd.replace(
        "  ssd_conv_wsum_kernel<<<", "  if (n < 0) ssd_conv_wsum_kernel<<<", 1))
    v["conv exp -> constant"] = (C, _cut(
        bwd, CONV_LANE, "__expf(-pre)", "(0.5f + 0.f * pre)"))
    v["conv output stores cut"] = (C, _cut(
        bwd, CONV_LANE, "store4(out + (long long)row(qo) * Wc + c, o, vg, c, Wc);",
        "if (o[0] == 1.2345f) store4(out + (long long)row(qo) * Wc + c, o, vg, c, Wc);"))
    # settings: the ring, the warps per block, the tile rows (the wrapper's
    # partial buffer follows `CONV_TILE_ROWS`, patched while timed)
    const = lambda old, new: bwd.replace(old, new, 1)
    v["conv 3 ring stages"] = (C, const("CONV_NST = 4;", "CONV_NST = 3;"))
    v["conv 5 ring stages"] = (C, const("CONV_NST = 4;", "CONV_NST = 5;"))
    v["conv 4-row stages"] = (C, const("CONV_RS = 8;", "CONV_RS = 4;"))
    v["conv 16-row stages"] = (C, const("CONV_RS = 8;", "CONV_RS = 16;"))
    v["conv 2 warps a block"] = (C, const("CONV_WARPS = 4;", "CONV_WARPS = 2;"))
    v["conv 8 warps a block"] = (C, const("CONV_WARPS = 4;", "CONV_WARPS = 8;"))
    v["conv 4-row stages, 4 blocks a SM (128 registers)"] = (C, bwd.replace(
        "CONV_RS = 8;", "CONV_RS = 4;", 1).replace(
        "__launch_bounds__(CONV_WARPS * 32) ssd_conv_bwd_kernel",
        "__launch_bounds__(CONV_WARPS * 32, 4) ssd_conv_bwd_kernel", 1))
    # the 16-byte copies are the shared header's: inlined into the copy
    common = open(os.path.join(csrc, "ssd_common.cuh")).read().replace(
        "cp.async.cg.shared.global [%0]", "cp.async.cg.shared.global.L2::256B [%0]")
    v["conv cp.async with L2::256B prefetch"] = (C, bwd.replace(
        '#include "ssd_common.cuh"', common, 1).replace(
        "cp.async.ca.shared.global [%0]", "cp.async.ca.shared.global.L2::256B [%0]", 1))
    for rows in (512, 2048, 4096):
        v[f"conv {rows}-row tiles"] = (C, const("CONV_TILE = 1024;",
                                                f"CONV_TILE = {rows};"),
                                       {"CONV_TILE_ROWS": rows})
    return v


ATT_FWD = ("attn_fwd_wgmma_kernel(const Args a,", "template <int HD>\nconstexpr size_t wgmma_smem")
ATT_DKV = ("attn_bwd_dkv_wgmma_kernel(const Args a,", "// Shared memory of the dQ kernel")
ATT_DQ = ("attn_bwd_dq_wgmma_kernel(const Args a,", "template <int HD>\nconstexpr size_t wgmma_smem")
# the exps replaced by an FMA-pipe stand-in of the same data flow
NO_EXP = ("fast_exp2(fmaf(", "(1.f + 0.f * fmaf(")
# the ring's TMA loads after the prologue cut: the tiles stay stale, only
# the prologue's are waited for
RING_LOAD = ("if (threadIdx.x == 0 && kt + STAGES - 1 < n_kt) load(kt + STAGES - 1);", "")
RING_WAIT = ("bar_wait(bar(slot), (kt / STAGES) & 1);",
             "if (kt < STAGES - 1) bar_wait(bar(slot), (kt / STAGES) & 1);")


def attn_variants(csrc):
    """The bf16 attention kernels, one phase cut or one setting changed
    each: "attn fwd" (`attn_fwd`), "attn dkv" (`attn_bwd_dkv`: the D
    prologue and the dK / dV kernel) and "attn dq" (`attn_bwd_dq`)."""
    fwd = open(os.path.join(csrc, "attention_fwd.cu")).read()
    bwd = open(os.path.join(csrc, "attention_bwd.cu")).read()
    common = open(os.path.join(csrc, "attention_common.cuh")).read()
    inline = lambda src, hdr: src.replace('#include "attention_common.cuh"', hdr, 1)
    F, K, Q = "attn-fwd", "attn-dkv", "attn-dq"
    v = {"attn fwd base": (F, fwd), "attn dkv base": (K, bwd),
         "attn dq base": (Q, bwd)}
    v["attn fwd exps -> FMA"] = (F, _cut(fwd, ATT_FWD, *NO_EXP))
    v["attn fwd no S = Q K^T product"] = (F, _cut(
        fwd, ATT_FWD, "scores<HD>(s, q_s, k_tile(slot));", "zero(s);"))
    v["attn fwd no O += P V product"] = (F, _cut(
        fwd, ATT_FWD, "accumulate<HD>(o, pa, k_tile(slot) + Lay::TILE);",
        "o[0][0] += __uint_as_float(pa[0][0] ^ pa[3][3]);"))
    v["attn fwd no ring loads (stale tiles)"] = (F, _cuts(fwd, ATT_FWD, (
        ("const bool refill = threadIdx.x == 0 && kt + STAGES - 1 < n_kt;",
         "const bool refill = false;"), RING_WAIT)))
    v["attn fwd no masks"] = (F, _cut(
        fwd, ATT_FWD, "if ((a.causal && kt == last) || k0 + BN > L) {", "if (false) {"))
    v["attn fwd 2 blocks an SM"] = (F, fwd.replace(
        "__launch_bounds__(hop::THREADS, HD <= 32 ? 3 :",
        "__launch_bounds__(hop::THREADS, HD <= 32 ? 2 :", 1))
    v["attn fwd 1 block an SM"] = (F, fwd.replace(
        "constexpr size_t smem = wgmma_smem<HD>();",
        "constexpr size_t smem = 120 * 1024;", 1))
    for n in (2, 4):
        hdr = common.replace("constexpr int STAGES = 3;", f"constexpr int STAGES = {n};", 1)
        for key, lib, src in (("fwd", F, fwd), ("dkv", K, bwd), ("dq", Q, bwd)):
            v[f"attn {key} {n} ring slots"] = (lib, inline(src, hdr))
    v["attn dkv exps -> FMA"] = (K, _cut(bwd, ATT_DKV, *NO_EXP))
    v["attn dkv no S^T, dP^T products"] = (K, _cuts(bwd, ATT_DKV, (
        ("scores<HD>(s, k_s, q_s);", "zero(s);"),
        ("scores<HD>(dp, v_s, o_s);", "zero(dp);"))))
    v["attn dkv no dV, dK products"] = (K, _cuts(bwd, ATT_DKV, (
        ("accumulate<HD>(dv, pa, o_s);",
         "dv[0][0] += __uint_as_float(pa[0][0] ^ pa[3][3]);"),
        ("accumulate<HD>(dk, da, q_s);",
         "dk[0][0] += __uint_as_float(da[0][0] ^ da[3][3]);"))))
    v["attn dkv no ring loads (stale tiles)"] = (K, _cuts(bwd, ATT_DKV, (
        ("if (threadIdx.x < BN && qt + STAGES - 1 < n_qt) load(qt + STAGES - 1);", ""),
        ("bar_wait(bar(slot), (i / STAGES) & 1);",
         "if (i < STAGES - 1) bar_wait(bar(slot), (i / STAGES) & 1);"))))
    v["attn dkv no masks"] = (K, _cut(
        bwd, ATT_DKV, "if (a.causal && qt == mine) {", "if (false) {"))
    v["attn dkv no D prologue"] = (K, bwd.replace(
        "    e = launch_delta<bf16, HD>(a, st);",
        "    e = a.B < 0 ? launch_delta<bf16, HD>(a, st) : cudaSuccess;", 1))
    v["attn dq exps -> FMA"] = (Q, _cut(bwd, ATT_DQ, *NO_EXP))
    v["attn dq no S, dP products"] = (Q, _cuts(bwd, ATT_DQ, (
        ("scores<HD>(s, q_s, k_s);", "zero(s);"),
        ("scores<HD>(dp, o_s, k_s + Lay::TILE);", "zero(dp);"))))
    v["attn dq no dQ product"] = (Q, _cut(
        bwd, ATT_DQ, "accumulate<HD>(dq, da, k_s);",
        "dq[0][0] += __uint_as_float(da[0][0] ^ da[3][3]);"))
    v["attn dq no ring loads (stale tiles)"] = (Q, _cuts(bwd, ATT_DQ, (RING_LOAD, RING_WAIT)))
    v["attn dq no masks"] = (Q, _cut(
        bwd, ATT_DQ, "if (a.causal && kt == last) {", "if (false) {"))
    return v


def attn_pr12_variants(csrc):
    """The attention kernels before their redesign, from the ``--tree``
    export, the header inlined: "pr12 fwd base", "pr12 dkv base", "pr12 dq
    base"."""
    fwd = open(os.path.join(csrc, "attention_fwd.cu")).read()
    bwd = open(os.path.join(csrc, "attention_bwd.cu")).read()
    hdr = open(os.path.join(csrc, "attention_common.cuh")).read()
    inline = lambda src: src.replace('#include "attention_common.cuh"', hdr, 1)
    return {"pr12 fwd base": ("attn-fwd", inline(fwd)),
            "pr12 dkv base": ("attn-dkv", inline(bwd)),
            "pr12 dq base": ("attn-dq", inline(bwd))}


def attn_calls(cs):
    """{library: (module, call)}: the three attention entries at the Hyena
    path's shape, G=2, L=65536, H=8, hd=32, bf16, causal (`chip_smoke.py
    ATTN_*`), O, lse and D from the shipped kernels."""
    from caduceus_tpu_torch.ops import attention as A

    G, L, H, hd = cs.ATTN_G, cs.ATTN_L, cs.ATTN_H, cs.ATTN_HD
    q, k, v, do = cs._attn_inputs(torch.bfloat16, G, L, H, hd, seed=7)
    sc = hd ** -0.5
    o, lse = A.attention_fwd(q, k, v, True, sc)
    _, _, D = A.attention_bwd_dkv(q, k, v, o, lse, do, True, sc)
    return {"attn-fwd": (A, lambda: A.attention_fwd(q, k, v, True, sc)),
            "attn-dkv": (A, lambda: A.attention_bwd_dkv(
                q, k, v, o, lse, do, True, sc)),
            "attn-dq": (A, lambda: A.attention_bwd_dq(
                q, k, v, o, lse, do, D, True, sc))}


SETS = {"ssd": ssd_variants, "scan": scan_variants,
        "scan-pr6": scan_pr6_variants, "scan-prefill": prefill_variants}
SETS["conv"] = conv_variants
SETS["attn"] = attn_variants
SETS["attn-pr12"] = attn_pr12_variants


def build(v, csrc):
    """Each variant's library, built side by side (the headers beside it)."""
    from caduceus_tpu_torch import _build

    os.makedirs(OUT, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            with open(os.path.join(csrc, f)) as src, \
                    open(os.path.join(OUT, f), "w") as dst:
                dst.write(src.read())

    def one(item):
        i, (name, (_, text, *_)) = item
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


def ssd_calls(cs):
    """{library: (module, call)}: each SSD library's main pass, timed alone
    on the workspace of a full call."""
    from caduceus_tpu_torch.ops import ssd_batched as sb

    G, L, H, P, NG, N, K = 4, 131072, 8, 64, 1, 128, 4
    T = sb.KERNEL_CHUNK[torch.bfloat16]
    inp = cs.ssd_inputs(G, L, H, P, NG, N, K, torch.bfloat16, 98,
                        width_pad=512)
    a7 = (inp["xBC"], inp["dt"], inp["A"], inp["conv_w"], inp["conv_b"],
          inp["D"], inp["dt_bias"])
    fwd_args = a7 + (inp["dims"], True, False, T, None, True)
    _, _, car, ws_f = sb.fused_fwd_call(*fwd_args)
    bwd_args = a7 + (inp["g_y"], car, None, inp["dims"], True, False, T)
    _, ws_b = sb.adjoint_xc_call(*bwd_args)
    return {"ssd_fused_fwd": (sb, lambda: sb.fused_fwd_call(
                *fwd_args, parts=sb.PART_MAIN, ws=ws_f)),
            "ssd_fused_bwd": (sb, lambda: sb.adjoint_xc_call(
                *bwd_args, parts=sb.PART_MAIN, ws=ws_b))}


def scan_calls(cs):
    """{library: (module, call)}: `bidir_scan_fwd` (#9, with carries) and
    the adjoint `selective_scan_bwd` (#8) at the training shape."""
    from caduceus_tpu_torch.ops import scan

    G, L, d, N = 4, 131072, 512, 16
    f = cs.scan_inputs(G, L, d, N, torch.bfloat16, 401, model_like=True)
    r = cs.scan_inputs(G, L, d, N, torch.bfloat16, 402, model_like=True)
    a, b = cs._scan_args(f), cs._scan_args(r)
    T = scan.KERNEL_CHUNK
    fargs = (*a[:2], *a[3:5], *b[:2], *b[3:5], a[2], b[2], a[5], b[5], a[6],
             b[6])
    _, _, car = scan.selective_scan_fwd(*a, True, False, T, None,
                                        save_carries=True)
    bargs = a + [f["g_y"], car, None, True, False, T]
    return {"selective_scan_fwd": (scan, lambda: scan.bidir_scan_fwd(
                *fargs, save_carries=True)),
            "selective_scan_bwd": (scan, lambda: scan.selective_scan_bwd_cuda(
                *bargs))}


def prefill_calls(cs):
    """{"prefill": (module, call), "prefill-bf16": ...}: `selective_scan_fwd`
    (#7) as the v1 prefill runs it, G=1, L=131072, d=512, N=16, fp32, from
    h_init; and the same call in bf16."""
    from caduceus_tpu_torch.ops import scan

    calls = {}
    for key, dtype in (("prefill", torch.float32),
                       ("prefill-bf16", torch.bfloat16)):
        f = cs.scan_inputs(1, 131072, 512, 16, dtype, 403, model_like=True)
        calls[key] = (scan, lambda a=cs._scan_args(f), h0=f["h0"]:
                      scan.selective_scan_fwd(*a, True, False,
                                              scan.KERNEL_CHUNK, h0))
    return calls


def conv_calls(cs):
    """{"conv": (module, call)}: `ssd_conv_bwd` (#3b) at the training shape,
    G=4, L=131072, Wc=768, bf16, xBC a column view of the mixer's in_proj
    output, forward direction."""
    from caduceus_tpu_torch.ops import ssd_batched as sb

    inp = cs.ssd_inputs(4, 131072, 8, 64, 1, 128, 4, torch.bfloat16, 98,
                        width_pad=512)
    g = torch.Generator(device="cuda").manual_seed(99)
    g_xc = torch.randn(inp["xBC"].shape, generator=g, device="cuda")
    return {"conv": (sb, lambda: sb.conv_silu_bwd(
        g_xc, inp["xBC"], inp["conv_w"], inp["conv_b"], False))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--set", action="append", choices=sorted(SETS))
    ap.add_argument("--tree", default=".", help="root of the checkout whose "
                    "package and kernel sources are cut and timed")
    ap.add_argument("--only", default="", help="time only the variants whose "
                    "name holds this text (and the bases)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase_cutouts: needs a CUDA card", file=sys.stderr)
        return 1
    sets = args.set or ["ssd", "scan"]
    tree = os.path.abspath(args.tree)
    # attn-pr12 takes only the sources of --tree: its wrappers are this
    # checkout's
    if "attn-pr12" not in sets:
        sys.path.insert(0, tree)
    cs = importlib.import_module("chip_smoke")
    from caduceus_tpu_torch import _build

    v = {}
    for s in sets:
        v.update(SETS[s](os.path.join(tree, "caduceus_tpu_torch", "csrc")
                         if s == "attn-pr12" else _build.SRC_DIR))
    v = {k: x for k, x in v.items() if args.only in k or k.endswith(" base")}
    libs = build(v, _build.SRC_DIR)
    calls = {}
    if "ssd" in sets:
        calls.update(ssd_calls(cs))
    if "scan" in sets or "scan-pr6" in sets:
        calls.update(scan_calls(cs))
    if "scan-prefill" in sets:
        calls.update(prefill_calls(cs))
    if "conv" in sets:
        calls.update(conv_calls(cs))
    if "attn" in sets or "attn-pr12" in sets:
        calls.update(attn_calls(cs))

    def timed(name):
        lib, _, *patch = v[name]
        mod, call = calls[lib]
        patch = {"_fn": lambda entry: fn(entry), **(patch[0] if patch else {})}
        real = {k: getattr(mod, k) for k in patch}

        def fn(entry):
            f = getattr(libs[name], entry)
            argt = mod._ARGTYPES
            f.argtypes = argt if isinstance(argt, list) else argt[entry]
            f.restype = ctypes.c_int
            return f
        for k, val in patch.items():
            setattr(mod, k, val)
        try:
            call()
            return cs._time_cuda(call, 5)
        finally:
            for k, val in real.items():
                setattr(mod, k, val)

    names = list(v)
    runs = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            runs[n].append(timed(n))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[cutouts] {', '.join(sets)} at G=4 L=131072 bf16 (scan-prefill: "
          f"G=1 fp32; attn: G=2 L=65536 H=8 hd=32 causal), {smi}")
    for n in names:
        base = runs[next(b for b in names if b.endswith(" base")
                         and b.split()[:-1] == n.split()[:len(b.split()) - 1])]
        ms = sum(runs[n]) / 2
        print(f"[cutouts] {n}: {ms:.3f} ms (runs "
              f"{', '.join(f'{x:.3f}' for x in runs[n])}); "
              f"{ms - sum(base) / 2:+.3f} ms against the base")
    return 0


if __name__ == "__main__":
    sys.exit(main())
