// Device code shared by selective_scan_fwd.cu and selective_scan_bwd.cu: the
// parameter set of one scan direction, storage-type conversions, the
// cp.async staging of one chunk of rows, the transposed B / C tiles, and the
// warp scans of the (prod dA, h) aggregates of the threads' runs. The
// backward recomputes the forward's state with the same staging, the same
// ex2 and the same scan, so the two kernels see the same bits.
//
// Thread layout of both kernels: a block of WARPS warps (in the forward W,
// 8 or 4) owns a tile of as many channels of one row g (warp w = channel
// c0 + w); lane j of a warp owns a run of R consecutive rows of each chunk
// of CH = 32 R rows (in scan order: lane 0 holds the chunk's first R rows
// the scan visits). A thread loops over the N states: per state n it
// computes the run's dA (one ex2 per row), the run's aggregate, the warp
// scan of the aggregates across the lanes, and re-walks its run from its
// incoming state with the dA it kept in registers. Sums over n (y; g_u,
// g_delta) stay in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace scan {

constexpr int WARPS = 8;                 // channels per block, one per warp
constexpr int NTHREADS = 32 * WARPS;
constexpr int R = 8;                     // rows per thread and chunk (a run)
constexpr int CH = 32 * R;               // rows per chunk: the carry spacing
constexpr int RUNS = CH / R;             // runs per chunk (= lanes)
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
// SCAN_DROP, a define given only to the variant libraries that the checks
// build to plant a fault (0, the kernels as they ship, unless given):
// 1 zeroes the incoming state (forward) or lam (adjoint) of the run
// DROP_LANE (scan order) in every chunk and state; 2 leaves cluster 1's
// share out of g_B.
#ifndef SCAN_DROP
#define SCAN_DROP 0
#endif
constexpr int DROP_LANE = 7;

// N = d_state: 8, 16 or 32 (lane n of a warp keeps the per-(channel, n)
// carries, so N <= 32).
__host__ __device__ inline bool valid_n(int N) { return N == 8 || N == 16 || N == 32; }

template <typename S> __device__ __forceinline__ float to_f(S v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename S> __device__ __forceinline__ S from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// softplus as the plain version computes it: max(x, 0) + log1p(exp(-|x|))
// (exp(-|x|) <= 1 on the MUFU: its error is relative to a term <= log 2)
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(__expf(-fabsf(x)));
}

// One scan direction's operands. u, delta, B, C and z are (G, L, .) in the
// storage dtype with a unit column stride and the given batch / row strides
// (B and C are column slices of the x_proj output, z of the in_proj output);
// the rest is fp32.
struct Dir {
  const void* u; long long u_sg, u_sl;
  const void* delta; long long d_sg, d_sl;
  const void* B; long long b_sg, b_sl;
  const void* C; long long c_sg, c_sl;
  const void* z; long long z_sg, z_sl;  // the SiLU gate of y, or null
  const float* A;       // (d, N)
  const float* D;       // (d,) or null
  const float* bias;    // (d,) or null
  const float* h_init;  // (G, d, N) or null
  void* y;              // (G, L, d) storage dtype, contiguous
  float* hN;            // (G, d, N) or null
  float* carries;       // (G, nc, d, N) or null: state entering each chunk
  long long reverse;
};
constexpr int DIR_WORDS = sizeof(Dir) / sizeof(long long);
static_assert(sizeof(Dir) == DIR_WORDS * sizeof(long long), "Dir is a row of 64-bit words");

// -- staging ---------------------------------------------------------------
// A staged operand keeps the chunk's rows in array order, row t of W
// elements at byte t * W * sizeof(S) + (t / R) * 16: the 16-byte gap after
// each run spreads the lanes' rows over the banks (a lane reads the rows of
// its own run).
template <typename S>
__host__ __device__ constexpr int staged_bytes(int W) {
  return CH * W * (int)sizeof(S) + RUNS * 16;
}
template <typename S>
__device__ __forceinline__ const S* staged_row(const unsigned char* buf, int W, int t) {
  return reinterpret_cast<const S*>(buf + t * W * (int)sizeof(S) + (t / R) * 16);
}
template <typename S>
__device__ __forceinline__ S* staged_row(unsigned char* buf, int W, int t) {
  return reinterpret_cast<S*>(buf + t * W * (int)sizeof(S) + (t / R) * 16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage rows [row0, row0 + CH) x columns [col0, col0 + W) of a row-strided
// operand (`base` = its row g). Rows >= L and columns >= ncols read as zero.
// With `vec` (16-byte aligned rows, all W columns inside) the copies are
// 16-byte cp.async pieces that stay in flight until the caller waits; else
// plain loads and stores. NT: the block's threads.
template <typename S, int NT = NTHREADS>
__device__ __forceinline__ void stage(unsigned char* dst, const S* base, long long sl,
                                      long long row0, int L, int col0, int W, int ncols,
                                      bool vec) {
  const int RB = W * (int)sizeof(S);
  if (vec) {
    const int ppr = RB / 16;
    for (int i = threadIdx.x; i < CH * ppr; i += NT) {
      const int t = i / ppr, k = i % ppr;
      const long long row = row0 + t;
      const bool ok = row < L;
      cp_async16(dst + t * RB + (t / R) * 16 + k * 16,
                 base + (ok ? row : 0) * sl + col0 + k * (16 / (int)sizeof(S)), ok);
    }
  } else {
    for (int i = threadIdx.x; i < CH * W; i += NT) {
      const int t = i / W, e = i % W;
      const long long row = row0 + t;
      S v = from_f<S>(0.f);
      if (row < L && col0 + e < ncols) v = base[row * sl + col0 + e];
      reinterpret_cast<S*>(dst + t * RB + (t / R) * 16)[e] = v;
    }
  }
}

// Whether a row-strided operand's tile can be staged by 16-byte pieces.
template <typename S>
__device__ __forceinline__ bool vec_ok(const S* base, long long sl, int col0, int W, int ncols) {
  return reinterpret_cast<uintptr_t>(base + col0) % 16 == 0 &&
         (sl * (long long)sizeof(S)) % 16 == 0 && (W * (int)sizeof(S)) % 16 == 0 &&
         col0 + W <= ncols;
}

// -- B and C transposed ----------------------------------------------------
// (n, run, item) tiles of element type TT: the R = 8 rows of a run are one
// 16-byte-aligned vector a lane reads with one 16-byte load (bf16) or two
// (fp32, whose two halves swap places in every other group of 4 runs, so
// that the 8 lanes of a load phase hit distinct banks).
static_assert(R == 8, "a run is 8 rows: one bf16 or two fp32 16-byte vectors");
template <typename TT>
__host__ __device__ constexpr int trans_bytes(int N) {
  return N * CH * (int)sizeof(TT);
}
template <typename TT> __device__ __forceinline__ int trans_index(int n, int t);
template <> __device__ __forceinline__ int trans_index<__nv_bfloat16>(int n, int t) {
  return (n * RUNS + t / R) * R + t % R;
}
template <> __device__ __forceinline__ int trans_index<float>(int n, int t) {
  const int r = t / R, a = t % R;
  return (n * RUNS + r) * R + 4 * ((a / 4) ^ ((r >> 2) & 1)) + a % 4;
}
template <typename TT> __device__ __forceinline__ TT to_t(float v);
template <> __device__ __forceinline__ float to_t<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // exact: the staged values are bf16 already
}

// Staged (t, n) rows of storage type S -> the transposed tile, one 16-byte
// piece of a row a step. NT: the block's threads.
template <typename S, typename TT, int NT = NTHREADS>
__device__ __forceinline__ void transpose_bc(const unsigned char* raw, TT* tr, int N) {
  constexpr int EPP = 16 / (int)sizeof(S);
  const int ppr = N / EPP;
  for (int i = threadIdx.x; i < CH * ppr; i += NT) {
    const int t = i / ppr, k = i % ppr;
    const uint4 v = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const unsigned char*>(staged_row<S>(raw, N, t)) + k * 16);
    const S* e = reinterpret_cast<const S*>(&v);
#pragma unroll
    for (int j = 0; j < EPP; ++j) tr[trans_index<TT>(k * EPP + j, t)] = to_t<TT>(to_f(e[j]));
  }
}

// The R values of run `run` of state n, in array order.
template <typename TT>
__device__ __forceinline__ void load_run(const TT* tr, int n, int run, float (&x)[R]);
template <>
__device__ __forceinline__ void load_run<__nv_bfloat16>(const __nv_bfloat16* tr, int n, int run,
                                                        float (&x)[R]) {
  const uint4 v = *reinterpret_cast<const uint4*>(tr + (n * RUNS + run) * R);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < R / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load_run<float>(const float* tr, int n, int run, float (&x)[R]) {
  const float4* p = reinterpret_cast<const float4*>(tr + (n * RUNS + run) * R);
  const int s = (run >> 2) & 1;
  const float4 lo = p[s], hi = p[s ^ 1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// 2^x on the MUFU (denormal results flushed to 0): dA = ex2(delta A log2 e)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -- the runs' channel values ----------------------------------------------
// This thread's R values of channel column `c` from a staged (t, W) tile,
// in array order.
template <typename S, int W = WARPS>
__device__ __forceinline__ void load_channel(const unsigned char* buf, int run, int c,
                                             float (&x)[R]) {
#pragma unroll
  for (int a = 0; a < R; ++a) x[a] = to_f(staged_row<S>(buf, W, run * R + a)[c]);
}

// -- warp scans of the runs' affine maps x -> P x + H ---------------------
// Inclusive scan in lane order (lane 0 first): (P, H) of a lane becomes the
// composition of the maps of lanes 0 .. lane.
__device__ __forceinline__ void scan_up(float& P, float& H, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float Pp = __shfl_up_sync(FULL, P, off);
    const float Hp = __shfl_up_sync(FULL, H, off);
    if (lane >= off) {
      H = fmaf(P, Hp, H);
      P *= Pp;
    }
  }
}
// Inclusive scan against lane order (lane 31 first).
__device__ __forceinline__ void scan_down(float& P, float& H, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float Pn = __shfl_down_sync(FULL, P, off);
    const float Hn = __shfl_down_sync(FULL, H, off);
    if (lane + off < 32) {
      H = fmaf(P, Hn, H);
      P *= Pn;
    }
  }
}

}  // namespace scan
