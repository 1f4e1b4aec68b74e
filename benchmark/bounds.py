"""The least time of a kernel on one H100, from the work its shapes need.

A frozen copy of `chip_smoke.py` at the time this benchmark was written:
the peaks (`chip_smoke.py:353-355`), `_bound` (`:1344`), `_ssd_bounds`
(`:1352`) and `_scan_bounds` (`:1375`). The program may change; this
yardstick does not.

A bound is the larger of bytes / HBM bandwidth and operations / peak
rate, each input read once and each output written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12       # dense tensor-core bf16
FP32_FLOP_PER_S = 67e12        # fp32 outside the tensor cores


def bound(nbytes, flops, flop_per_s=BF16_FLOP_PER_S):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flop_per_s * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def ssd_bounds(G, L, H, P, NG, N, K, T):
    """Bounds of #1 `ssd_fused_fwd` (with carries), #3a (the adjoint's main
    pass) and #3b (the conv adjoint) at (G, L), bf16: bf16 rows, fp32
    parameters and final state, bf16 carries; the matmul work the function
    needs (CB per group, M@dx, C@h, B^T@wdx in the forward; CB, LG@B,
    LG^T@C once per group, G, gdx (T x T x P) and six N x P products per
    head in the adjoint); #3b writes g_xBC with ~6K + 8 fp32 operations an
    element."""
    rows, Wc, nc = G * L, H * P + 2 * NG * N, -(-L // T)
    car_bytes = G * nc * H * N * P * 2
    return {
        "ssd_fused_fwd": bound(
            rows * (Wc + H) * 2 + rows * H * P * 2 + G * H * N * P * 4
            + car_bytes,
            rows * (2 * T * N * NG + 2 * T * P * H + 4 * N * P * H)),
        "ssd_fused_bwd_kernel": bound(
            rows * (Wc * 2 + H * 2 + H * P * 2 + H * 2) + car_bytes,
            rows * (6 * T * N * NG + H * (4 * T * P + 12 * N * P))),
        "ssd_conv_bwd_kernel": bound(rows * Wc * 2, rows * Wc * (6 * K + 8),
                                     FP32_FLOP_PER_S)}


def scan_bounds(G, L, d, N, T):
    """Bounds of #9 `bidir_scan_fwd` (both directions, carries saved) and
    #8 `selective_scan_bwd` (one direction) at (G, L), bf16: per row and
    direction u and delta read, B and C read, y written; the adjoint reads
    u, delta, g_y, B, C and the carries and writes g_u, g_delta, g_B, g_C;
    fp32 operations outside the tensor cores."""
    rows, nc = G * L, -(-L // T)
    car_bytes = G * nc * d * N * 4
    io_fwd = rows * (2 * d * 2 + 2 * N * 2 + d * 2)
    return {
        "bidir_scan_fwd": bound(2 * (io_fwd + car_bytes),
                                2 * 5 * rows * d * N, FP32_FLOP_PER_S),
        "selective_scan_bwd": bound(
            rows * (3 * d * 2 + 2 * N * 2 + 2 * d * 2 + 2 * N * 2)
            + car_bytes, 20 * rows * d * N, FP32_FLOP_PER_S)}
