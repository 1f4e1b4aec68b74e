// Device code shared by selective_scan_fwd.cu and selective_scan_bwd.cu: the
// parameter set of one scan direction, storage-type conversions, and the
// loading (into registers) and staging (into shared memory) of one chunk of
// u, delta, B and C. The backward
// recomputes the forward's state with this same staging and the same exp2f,
// so the two kernels see the same bits.
//
// Thread layout of both kernels: a block of NTHREADS threads owns a tile of
// CW = NTHREADS / N channels of one row g; thread (c, n) = (tid / N, tid % N)
// holds the fp32 state h[c, n]; N lanes of a warp share a channel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace scan {

constexpr int NTHREADS = 256;
constexpr int T = 64;                       // rows per chunk (carry spacing)
constexpr float LOG2E = 1.4426950408889634f;

// N = d_state: a power of two from 8 to 32 (a channel's lanes stay inside
// one warp; CW = 256 / N <= 32 channels keeps the forward's staging under
// 48 KB of static shared memory).
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
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// One scan direction's operands. u, delta, B and C are (G, L, .) in the
// storage dtype with a unit column stride and the given batch / row strides
// (B and C are column slices of the x_proj output); the rest is fp32.
struct Dir {
  const void* u; long long u_sg, u_sl;
  const void* delta; long long d_sg, d_sl;
  const void* B; long long b_sg, b_sl;
  const void* C; long long c_sg, c_sl;
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

// A thread's share of one chunk's operands in registers, as loaded: the
// (row, channel) items i = tid + k NTHREADS of u and delta (T / N of them)
// and the (row, n) items of B and C (N / 4 of them), k < MAXPT.
constexpr int MAXPT = 8;
template <typename S>
struct ChunkRegs {
  S u[MAXPT], d[MAXPT], B[MAXPT], C[MAXPT];
};

// Issue the loads of rows [row0, row0 + T), channels [c0, c0 + CW), all at
// once: they stay in flight until `stage_chunk` reads the registers.
template <typename S>
__device__ __forceinline__ void load_chunk(const Dir& p, int g, long long row0, int L, int c0,
                                           int CW, int d, int N, ChunkRegs<S>& r) {
  const S* u = static_cast<const S*>(p.u) + (long long)g * p.u_sg;
  const S* dl = static_cast<const S*>(p.delta) + (long long)g * p.d_sg;
  const S* B = static_cast<const S*>(p.B) + (long long)g * p.b_sg;
  const S* C = static_cast<const S*>(p.C) + (long long)g * p.c_sg;
  const int nd = T * CW / NTHREADS, nb = T * N / NTHREADS;
#pragma unroll
  for (int k = 0; k < MAXPT; ++k) {
    const int i = threadIdx.x + k * NTHREADS;
    if (k < nd) {
      const long long row = row0 + i / CW;
      const int ch = c0 + i % CW;
      const bool ok = row < L && ch < d;
      r.u[k] = ok ? u[row * p.u_sl + ch] : from_f<S>(0.f);
      r.d[k] = ok ? dl[row * p.d_sl + ch] : from_f<S>(0.f);
    }
    if (k < nb) {
      const long long row = row0 + i / N;
      const bool ok = row < L;
      r.B[k] = ok ? B[row * p.b_sl + i % N] : from_f<S>(0.f);
      r.C[k] = ok ? C[row * p.c_sl + i % N] : from_f<S>(0.f);
    }
  }
}

// Stage a loaded chunk into shared memory: us = u, ds = the resolved delta
// (row-major (T, CW)), Bs / Cs (T, N). Rows >= L and channels >= d are
// zeros: identity steps of the recurrence. A thread's (row, channel) items
// all lie in its staging channel c0 + tid % CW (CW divides NTHREADS), whose
// dt bias is `bias_c`.
template <typename S>
__device__ __forceinline__ void stage_chunk(long long row0, int L, int c0, int CW, int d, int N,
                                            bool dt_softplus, float bias_c,
                                            const ChunkRegs<S>& r, float* us, float* ds,
                                            float* Bs, float* Cs) {
  const int nd = T * CW / NTHREADS, nb = T * N / NTHREADS;
  const bool ch_ok = c0 + (int)threadIdx.x % CW < d;
#pragma unroll
  for (int k = 0; k < MAXPT; ++k) {
    const int i = threadIdx.x + k * NTHREADS;
    if (k < nd) {
      float dd = 0.f;
      if (row0 + i / CW < L && ch_ok) {
        dd = to_f(r.d[k]) + bias_c;
        if (dt_softplus) dd = softplus(dd);
      }
      us[i] = to_f(r.u[k]);
      ds[i] = dd;
    }
    if (k < nb) {
      Bs[i] = to_f(r.B[k]);
      Cs[i] = to_f(r.C[k]);
    }
  }
}

}  // namespace scan
