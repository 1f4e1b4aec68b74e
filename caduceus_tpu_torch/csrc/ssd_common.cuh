// Device code shared by ssd_fused_fwd.cu and ssd_fused_bwd.cu: storage-type
// conversions, block matmuls on shared-memory tiles, the fp32 in-chunk dt
// cumsum, and the two ways a chunk's x, B and C are staged: the fused
// depthwise conv + SiLU (K >= 1) or the post-conv tensors as given (K = 0).
// The backward recomputes the forward's per-chunk values with these same
// functions, so the two kernels see the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace ssd {

using namespace nvcuda;

constexpr int NTHREADS = 512;   // 16 warps per block
constexpr int NWARPS = NTHREADS / 32;
constexpr int RG = 8;           // conv rows per work item (divides T)

// Chunk rows: 64 for bf16; 32 for fp32, whose operand tiles are twice as
// large and would not fit the backward's shared memory at 64.
template <typename S> struct Chunk { static constexpr int T = 64; };
template <> struct Chunk<float> { static constexpr int T = 32; };

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

// C (M x Nn, fp32, row-major, ldc) = (load ? scale * C : 0) + A (M x K) @ B (K x Nn).
// A(i, k) is A[i*lda + k], or A[k*lda + i] when A_COL; B(k, j) is B[k*ldb + j],
// or B[j*ldb + k] when B_COL. Each output tile (bf16) or element (fp32) is
// owned by one warp / thread, so C may be updated in place.
template <typename S, bool A_COL, bool B_COL>
struct BlockMM;

template <bool A_COL, bool B_COL>
struct BlockMM<__nv_bfloat16, A_COL, B_COL> {
  static __device__ void run(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B, int ldb,
                             float* C, int ldc, int M, int Nn, int K, bool load, float scale) {
    using LA = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
    const int nt = Nn / 16;
    for (int tile = warp; tile < (M / 16) * nt; tile += NWARPS) {
      const int i0 = (tile / nt) * 16, j0 = (tile % nt) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (load) {
        wmma::load_matrix_sync(acc, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
        for (int e = 0; e < acc.num_elements; ++e) acc.x[e] *= scale;
      } else {
        wmma::fill_fragment(acc, 0.f);
      }
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
        wmma::load_matrix_sync(a, A_COL ? A + k0 * lda + i0 : A + i0 * lda + k0, lda);
        wmma::load_matrix_sync(b, B_COL ? B + j0 * ldb + k0 : B + k0 * ldb + j0, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + i0 * ldc + j0, acc, ldc, wmma::mem_row_major);
    }
  }
};

template <bool A_COL, bool B_COL>
struct BlockMM<float, A_COL, B_COL> {
  static __device__ void run(const float* A, int lda, const float* B, int ldb, float* C, int ldc,
                             int M, int Nn, int K, bool load, float scale) {
    for (int idx = threadIdx.x; idx < M * Nn; idx += NTHREADS) {
      const int i = idx / Nn, j = idx % Nn;
      float acc = load ? scale * C[i * ldc + j] : 0.f;
      for (int k = 0; k < K; ++k) {
        const float a = A_COL ? A[k * lda + i] : A[i * lda + k];
        const float b = B_COL ? B[j * ldb + k] : B[k * ldb + j];
        acc = fmaf(a, b, acc);
      }
      C[i * ldc + j] = acc;
    }
  }
};

// One product term A (M x K) @ B (K x Nn) of `mm_epi`, laid out as in BlockMM.
template <typename S, bool A_COL, bool B_COL>
struct Term {
  const S* A; int lda; const S* B; int ldb; int K;
};

template <bool A_COL, bool B_COL>
__device__ __forceinline__ void wmma_acc(wmma::fragment<wmma::accumulator, 16, 16, 16, float>& acc,
                                         const Term<__nv_bfloat16, A_COL, B_COL>& t, int i0, int j0) {
  using LA = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
  for (int k0 = 0; k0 < t.K; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
    wmma::load_matrix_sync(a, A_COL ? t.A + k0 * t.lda + i0 : t.A + i0 * t.lda + k0, t.lda);
    wmma::load_matrix_sync(b, B_COL ? t.B + j0 * t.ldb + k0 : t.B + k0 * t.ldb + j0, t.ldb);
    wmma::mma_sync(acc, a, b, acc);
  }
}

template <bool A_COL, bool B_COL>
__device__ __forceinline__ float fma_acc(float acc, const Term<float, A_COL, B_COL>& t, int i,
                                         int j) {
  for (int k = 0; k < t.K; ++k) {
    const float a = A_COL ? t.A[k * t.lda + i] : t.A[i * t.lda + k];
    const float b = B_COL ? t.B[j * t.ldb + k] : t.B[k * t.ldb + j];
    acc = fmaf(a, b, acc);
  }
  return acc;
}

// out = t1 + t2 (M x Nn, fp32 accumulation); epi(i, j, out(i, j)) is called
// once per element, by one thread. The bf16 path passes each 16x16 tile
// through the calling warp's 256 floats of `stage` (NWARPS * 256 in all);
// the fp32 path needs no stage.
template <typename S, typename T1, typename T2, typename Epi>
__device__ void mm_epi(int M, int Nn, const T1& t1, const T2& t2, float* stage, Epi epi) {
  if constexpr (std::is_same<S, float>::value) {
    for (int idx = threadIdx.x; idx < M * Nn; idx += NTHREADS) {
      const int i = idx / Nn, j = idx % Nn;
      epi(i, j, fma_acc(fma_acc(0.f, t1, i, j), t2, i, j));
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* st = stage + warp * 256;
    const int nt = Nn / 16;
    for (int tile = warp; tile < (M / 16) * nt; tile += NWARPS) {
      const int i0 = (tile / nt) * 16, j0 = (tile % nt) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      wmma_acc(acc, t1, i0, j0);
      wmma_acc(acc, t2, i0, j0);
      wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) epi(i0 + e / 16, j0 + e % 16, st[e]);
      __syncwarp();
    }
  }
}

// Resolved dt (softplus(dt_raw + bias), 0 past L) and its inclusive
// in-scan-order cumsum of a = dt * A, for the T rows of one chunk. Called by
// warp 0: lane l holds scan steps E*l .. E*l+E-1 (E = T/32) and an fp32 warp
// scan joins the lanes -- no matmul, so no bf16/TF32 pass touches the cumsum.
template <typename S, int T>
__device__ __forceinline__ void chunk_dt_cum(const S* dtp, long long dt_sl, int hh,
                                             long long row0, int L, float bias_h, float A_h,
                                             bool softplus, bool rev, float* dtv, float* cum) {
  constexpr int E = T / 32;
  const int lane = threadIdx.x;
  float d[E], part[E];
  int t[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int q = E * lane + e;
    t[e] = rev ? T - 1 - q : q;
    const long long row = row0 + t[e];
    float v = 0.f;
    if (row < L) {
      v = to_f<S>(dtp[row * dt_sl + hh]) + bias_h;
      if (softplus) v = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
    }
    d[e] = v;
    run = e == 0 ? v * A_h : run + v * A_h;
    part[e] = run;
  }
  float incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    dtv[t[e]] = d[e];
    cum[t[e]] = excl + part[e];
  }
}

// silu(depthwise conv) of the x columns of head hh and the B/C columns of its
// group, for the T rows of one chunk: xf (T x P fp32, ld P), Bs / Cs (T x N,
// storage type, ld ldN). Zeros past the sequence edges; rows >= L give 0.
// Work item = (column, RG-row group in scan order); its RG + K - 1 raw rows
// are loaded before any is used, so they are in flight together.
template <typename S, int K, int T>
__device__ __forceinline__ void conv_silu_chunk(const S* xBC, long long xbc_sl,
                                                const float* conv_w, const float* conv_b,
                                                int Wc, int L, long long row0, bool rev, int P,
                                                int N, int xcol0, int bcol0, int ccol0,
                                                float* xf, S* Bs, S* Cs, int ldN) {
  const int ncol = P + 2 * N;
  for (int item = threadIdx.x; item < ncol * (T / RG); item += NTHREADS) {
    const int j = item % ncol;
    const int q0 = (item / ncol) * RG;
    const int col = j < P ? xcol0 + j : (j < P + N ? bcol0 + (j - P) : ccol0 + (j - P - N));
    float wk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) wk[k] = conv_w[k * Wc + col];
    const float bj = conv_b ? conv_b[col] : 0.f;
    // raw[i] is the row at scan step q0 - (K-1) + i (negative steps are
    // the K-1 rows before the chunk in scan order; zeros past the edges)
    float raw[RG + K - 1];
#pragma unroll
    for (int i = 0; i < RG + K - 1; ++i) {
      const int q = q0 - (K - 1) + i;
      const long long r = row0 + (rev ? T - 1 - q : q);
      // an unconditional load from a clamped row: guarded loads were
      // issued one after another
      const long long rc = r < 0 ? 0 : (r < L ? r : L - 1);
      const float v = to_f<S>(xBC[rc * xbc_sl + col]);
      raw[i] = (r >= 0 && r < L) ? v : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int t = rev ? T - 1 - (q0 + i) : q0 + i;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) acc += wk[k] * raw[i + k];
      acc += bj;
      const float v = row0 + t < L ? acc * (1.f / (1.f + expf(-acc))) : 0.f;
      if (j < P) {
        xf[t * P + j] = v;
      } else if (j < P + N) {
        Bs[t * ldN + (j - P)] = from_f<S>(v);
      } else {
        Cs[t * ldN + (j - P - N)] = from_f<S>(v);
      }
    }
  }
}

// K = 0: post-conv x (one head's P columns), B and C (one group's N
// columns) of the T rows of one chunk, read through their row strides from
// pointers already offset to the batch row and the columns: xf (T x P
// fp32), Bs / Cs (T x N storage type, ld ldN). Rows >= L give 0 (identity
// steps, with dt = 0 there). Each load reads a clamped row unconditionally
// and the row mask selects after, so a thread's loads are all in flight
// together.
template <typename S, int T>
__device__ __forceinline__ void load_chunk(const S* x, long long x_sl, const S* B,
                                           long long b_sl, const S* C, long long c_sl, int L,
                                           long long row0, int P, int N, float* xf, S* Bs,
                                           S* Cs, int ldN) {
  const int ncol = P + 2 * N;
  for (int i = threadIdx.x; i < T * ncol; i += NTHREADS) {
    const int t = i / ncol, j = i % ncol;
    const long long r = row0 + t;
    const long long rc = r < L ? r : L - 1;
    if (j < P) {
      const float v = to_f<S>(x[rc * x_sl + j]);
      xf[t * P + j] = r < L ? v : 0.f;
    } else if (j < P + N) {
      const S v = B[rc * b_sl + (j - P)];
      Bs[t * ldN + (j - P)] = r < L ? v : from_f<S>(0.f);
    } else {
      const S v = C[rc * c_sl + (j - P - N)];
      Cs[t * ldN + (j - P - N)] = r < L ? v : from_f<S>(0.f);
    }
  }
}

}  // namespace ssd
