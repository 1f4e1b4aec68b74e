// Device code shared by ssd_fused_fwd.cu and ssd_fused_bwd.cu: storage-type
// conversions, block matmuls on shared-memory tiles, the fp32 in-chunk dt
// cumsum, cp.async staging of a chunk's rows, the conv + SiLU of one head's
// x columns from staged raw rows, the segment split of the chunk-parallel
// state passing, and `ssd_prep_kernel`: the B/C conv (or, K = 0, the given
// B and C) and CB = C B^T of every (g, group, chunk), computed once and
// shared by the group's heads. The backward recomputes the forward's
// per-chunk values with these same functions, so the two kernels see the
// same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
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
      // two k-steps per trip: the next fragments load while one multiplies
#pragma unroll 2
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

// The raw dt of one head for the T rows of a chunk, as warp 0 holds it
// before `dt_cum`: lane l holds scan steps E*l .. E*l+E-1 (E = T/32); rows
// >= L give 0. Loads from a clamped row, unconditionally, so they are all in
// flight together; the kernels fetch the next chunk's values while the
// current chunk computes.
template <typename S, int T>
__device__ __forceinline__ void dt_fetch(const S* dtp, long long dt_sl, int hh, long long row0,
                                         int L, bool rev, float (&raw)[T / 32]) {
  constexpr int E = T / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int q = E * lane + e;
    const long long row = row0 + (rev ? T - 1 - q : q);
    const float v = to_f<S>(dtp[(row < L ? row : 0) * dt_sl + hh]);
    raw[e] = row < L ? v : 0.f;
  }
}

// Resolved dt (softplus(dt_raw + bias), 0 past L) and its inclusive
// in-scan-order cumsum of a = dt * A, for the T rows of one chunk, from the
// raw values of `dt_fetch`. Called by warp 0: an fp32 warp scan joins the
// lanes -- no matmul, so no bf16/TF32 pass touches the cumsum.
template <int T>
__device__ __forceinline__ void dt_cum(const float (&raw)[T / 32], long long row0, int L,
                                       float bias_h, float A_h, bool softplus, bool rev,
                                       float* dtv, float* cum) {
  constexpr int E = T / 32;
  const int lane = threadIdx.x % 32;
  float d[E], part[E];
  int t[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int q = E * lane + e;
    t[e] = rev ? T - 1 - q : q;
    float v = 0.f;
    if (row0 + t[e] < L) {
      v = raw[e] + bias_h;
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

// silu(depthwise conv) of one group's B and C columns (from bcol0 and
// ccol0 of xBC) for the T rows of one chunk, into Bs / Cs (T x N, storage
// type, ld ldN). Zeros past the sequence edges; rows >= L give 0. Work item
// = (column, RG-row group in scan order); its RG + K - 1 raw rows are loaded
// before any is used, so they are in flight together.
template <typename S, int K, int T>
__device__ __forceinline__ void conv_silu_bc(const S* xBC, long long xbc_sl,
                                             const float* conv_w, const float* conv_b,
                                             int Wc, int L, long long row0, bool rev, int N,
                                             int bcol0, int ccol0, S* Bs, S* Cs, int ldN) {
  const int ncol = 2 * N;
  for (int item = threadIdx.x; item < ncol * (T / RG); item += NTHREADS) {
    const int j = item % ncol;
    const int q0 = (item / ncol) * RG;
    const int col = j < N ? bcol0 + j : ccol0 + (j - N);
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
      (j < N ? Bs[t * ldN + j] : Cs[t * ldN + (j - N)]) = from_f<S>(v);
    }
  }
}

// K = 0: one group's post-conv B and C rows of a chunk, read through their
// row strides from pointers already offset to the batch row and the group's
// columns, into Bs / Cs (T x N, storage type, ld ldN). Rows >= L give 0.
// Each load reads a clamped row unconditionally and the row mask selects
// after, so a thread's loads are all in flight together.
template <typename S, int T>
__device__ __forceinline__ void load_bc(const S* B, long long b_sl, const S* C, long long c_sl,
                                        int L, long long row0, int N, S* Bs, S* Cs, int ldN) {
  for (int i = threadIdx.x; i < T * 2 * N; i += NTHREADS) {
    const int t = i / (2 * N), j = i % (2 * N);
    const long long r = row0 + t;
    const long long rc = r < L ? r : L - 1;
    const S v = j < N ? B[rc * b_sl + j] : C[rc * c_sl + (j - N)];
    (j < N ? Bs[t * ldN + j] : Cs[t * ldN + (j - N)]) = r < L ? v : from_f<S>(0.f);
  }
}

// -- cp.async: 16-byte global -> shared copies, in flight while the block
// computes; a copy with `valid` false writes 16 zero bytes (src-size 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows r0 .. r0+nrows-1 (columns 0 .. ncols-1) of a row-strided
// matrix into shared memory (row i at dst + i*ldd); rows outside [0, L) are
// zeros. ncols * sizeof(E) is a multiple of 16. With `async` the copies are
// cp.async (the caller commits and waits); without (an operand that is not
// 16-byte aligned) plain loads and stores.
template <typename E>
__device__ __forceinline__ void stage_rows(E* dst, int ldd, const E* src, long long sl,
                                           long long r0, int nrows, int ncols, long long L,
                                           bool async) {
  constexpr int V = 16 / sizeof(E);
  const int per_row = ncols / V;
  for (int i = threadIdx.x; i < nrows * per_row; i += NTHREADS) {
    const int t = i / per_row, v = (i % per_row) * V;
    const long long r = r0 + t;
    const bool ok = r >= 0 && r < L;
    const E* s = src + (ok ? r : 0) * sl + v;
    E* d = dst + t * ldd + v;
    if (async) {
      cp_async16(d, s, ok);
    } else {
      if (ok) {
#pragma unroll
        for (int e = 0; e < V; ++e) d[e] = s[e];
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

// fn(i, r, c) for the elements i = r * C + c of a rows x C tile that this
// thread owns (i = tid, tid + NTHREADS, ...). When C divides NTHREADS a
// thread keeps one column and steps its row, so no element pays for an
// integer division by the runtime C.
template <typename F>
__device__ __forceinline__ void for_rc(int rows, int C, F fn) {
  if (NTHREADS % C == 0) {
    const int c = threadIdx.x % C, step = NTHREADS / C;
    for (int r = threadIdx.x / C; r < rows; r += step) fn(r * C + c, r, c);
  } else {
    for (int i = threadIdx.x; i < rows * C; i += NTHREADS) fn(i, i / C, i % C);
  }
}

// Raw rows staged for one head's x columns of a chunk: T + K - 1 rows for
// the conv (its K - 1 history rows: before the chunk, or after it when the
// scan runs right to left), T rows when K = 0. Raw row i is array row
// `xraw_row0 + i`.
template <int K, int T>
struct XRaw {
  static constexpr int ROWS = T + (K > 0 ? K - 1 : 0);
  static __host__ __device__ long long row0(long long chunk_row0, bool rev) {
    return K > 0 && !rev ? chunk_row0 - (K - 1) : chunk_row0;
  }
};

// xf (T x P fp32) = silu(depthwise conv) of one head's x columns for the T
// rows of a chunk, from the raw rows staged by XRaw (K = 0: the post-conv x
// as staged). Rows >= L give 0. The arithmetic and its order are those of
// `conv_silu_bc`: the K taps summed in order, then the bias, then SiLU.
template <typename S, int K, int T>
__device__ __forceinline__ void conv_x_staged(const S* raw, int P, const float* conv_w,
                                              const float* conv_b, int Wc, int xcol0,
                                              long long row0, int L, bool rev, float* xf) {
  if constexpr (K == 0) {
    for (int i = threadIdx.x; i < T * P; i += NTHREADS)
      xf[i] = to_f<S>(raw[i]);  // rows >= L were staged as zeros
  } else {
    // a thread's K taps and bias, loaded once for the column it keeps
    // (or per element when P does not divide NTHREADS)
    float wk[K], bj = 0.f;
    int jw = -1;
    for_rc(T, P, [&](int i, int t, int j) {
      if (j != jw) {
        jw = j;
#pragma unroll
        for (int k = 0; k < K; ++k) wk[k] = __ldg(conv_w + k * Wc + xcol0 + j);
        bj = conv_b ? __ldg(conv_b + xcol0 + j) : 0.f;
      }
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) acc += wk[k] * to_f<S>(raw[(rev ? t + K - 1 - k : t + k) * P + j]);
      acc += bj;
      xf[i] = row0 + t < L ? acc * (1.f / (1.f + expf(-acc))) : 0.f;
    });
  }
}

// -- chunk-parallel state passing. The nc chunks of a (g, h) sequence are
// cut, in array order, into S segments of sc whole chunks (the last may be
// shorter; the host picks S so that none is empty). A segment's chunks are
// walked in scan order (forward) or against it (backward).
struct Segment {
  int lo, hi;   // array chunks [lo, hi)
  int q;        // position in scan order (0 = the segment the scan enters first)
  __device__ Segment(int s, int S, int sc, int nc, bool rev)
      : lo(s * sc), hi(min(s * sc + sc, nc)), q(rev ? S - 1 - s : s) {}
  // the i-th chunk of the segment in scan order
  __device__ int scan_chunk(int i, bool rev) const { return rev ? hi - 1 - i : lo + i; }
  // array segment at scan position qq
  static __device__ int at(int qq, int S, bool rev) { return rev ? S - 1 - qq : qq; }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block, returned to every thread. `red` holds NWARPS floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < NWARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// -- ssd_prep_kernel: per (chunk, group, g) block, the group's post-conv B
// and C rows of the chunk (K >= 1: conv + SiLU of the pre-conv xBC columns,
// written to the (G, L, 2*NG*N) workspace `bc`: [B of every group | C of
// every group]; K = 0: B and C as given) and CB = C @ B^T (T x T, fp32
// accumulation of storage-type operands) into cb (G, NG, nc, T, T). One
// conv and one CB per (g, group, chunk), read by every head of the group:
// at ngroups 1 the 8 heads of the main geometry shared none before.
struct PrepParams {
  const void* xBC;          // K >= 1: (G, L, Wc), unit column stride
  long long xbc_sg, xbc_sl;
  const float* conv_w;      // (K, Wc)
  const float* conv_b;      // (Wc,) or null
  const void* B;            // K = 0: (G, L, NG*N) views, unit column stride
  long long b_sg, b_sl;
  const void* C;
  long long c_sg, c_sl;
  void* bc;                 // K >= 1: (G, L, 2*NG*N) storage dtype
  float* cb;                // (G, NG, nc, T, T)
  int L, H, P, NG, N, Wc, reverse;
};

template <typename S>
struct PrepSmem {
  static constexpr int T = Chunk<S>::T;
  static constexpr int PAD_S = sizeof(S) == 2 ? 8 : 4;
  static __host__ __device__ size_t bytes(int N) {
    return 2 * align128((size_t)T * (N + PAD_S) * sizeof(S)) + (size_t)T * (T + 4) * 4;
  }
};

template <typename S, int K>
__global__ void __launch_bounds__(NTHREADS) ssd_prep_kernel(const PrepParams p) {
  constexpr int T = Chunk<S>::T;
  constexpr int PAD_S = PrepSmem<S>::PAD_S;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int N = p.N, L = p.L, NG = p.NG, ldN = N + PAD_S, ldT = T + 4;
  S* Bs = reinterpret_cast<S*>(smem_raw);
  S* Cs = reinterpret_cast<S*>(smem_raw + align128((size_t)T * ldN * sizeof(S)));
  float* CBf = reinterpret_cast<float*>(smem_raw + 2 * align128((size_t)T * ldN * sizeof(S)));
  const int c = blockIdx.x, grp = blockIdx.y, g = blockIdx.z;
  const int nc = gridDim.x;
  const long long row0 = (long long)c * T;
  if constexpr (K >= 1) {
    const int bcol0 = p.H * p.P + grp * N, ccol0 = p.H * p.P + NG * N + grp * N;
    conv_silu_bc<S, K, T>(static_cast<const S*>(p.xBC) + (long long)g * p.xbc_sg, p.xbc_sl,
                          p.conv_w, p.conv_b, p.Wc, L, row0, p.reverse != 0, N, bcol0, ccol0,
                          Bs, Cs, ldN);
  } else {
    load_bc<S, T>(static_cast<const S*>(p.B) + (long long)g * p.b_sg + (long long)grp * N, p.b_sl,
                  static_cast<const S*>(p.C) + (long long)g * p.c_sg + (long long)grp * N, p.c_sl,
                  L, row0, N, Bs, Cs, ldN);
  }
  __syncthreads();
  if constexpr (K >= 1) {
    S* bc = static_cast<S*>(p.bc) + (long long)g * L * 2 * NG * N;
    for (int i = threadIdx.x; i < T * 2 * N; i += NTHREADS) {
      const int t = i / (2 * N), j = i % (2 * N);
      const long long r = row0 + t;
      if (r < L)
        bc[r * 2 * NG * N + (j < N ? grp * N + j : NG * N + grp * N + j - N)] =
            j < N ? Bs[t * ldN + j] : Cs[t * ldN + j - N];
    }
  }
  BlockMM<S, false, true>::run(Cs, ldN, Bs, ldN, CBf, ldT, T, T, N, false, 0.f);
  __syncthreads();
  float* cb = p.cb + (((long long)g * NG + grp) * nc + c) * T * T;
  for (int i = threadIdx.x; i < T * T; i += NTHREADS) cb[i] = CBf[(i / T) * ldT + i % T];
}

// Set a kernel's dynamic shared memory and check it against the device's
// opt-in maximum.
template <typename F>
__host__ cudaError_t set_smem(F* kernel, size_t smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename S, int K>
__host__ cudaError_t launch_prep(const PrepParams& p, int G, cudaStream_t stream) {
  constexpr int T = Chunk<S>::T;
  const size_t smem = PrepSmem<S>::bytes(p.N);
  cudaError_t err = set_smem(ssd_prep_kernel<S, K>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.L + T - 1) / T, p.NG, G);
  ssd_prep_kernel<S, K><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Whether a row-strided operand can be staged by 16-byte cp.async: base
// address, batch and row strides (in bytes) multiples of 16.
__host__ inline bool aligned16(const void* ptr, long long sg, long long sl, size_t esize) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (sg * (long long)esize) % 16 == 0 &&
         (sl * (long long)esize) % 16 == 0;
}

// The shapes both entries take: P and N multiples of 16 (the tensor-core
// tile), H a multiple of NG, and S segments of sc = ceil(nc / S) chunks,
// none empty.
__host__ inline bool valid_shape(int G, int L, int H, int P, int NG, int N, int S, int T) {
  if (P % 16 != 0 || N % 16 != 0 || NG <= 0 || H % NG != 0 || L <= 0 || G <= 0 || S < 1)
    return false;
  const int nc = (L + T - 1) / T;
  const int sc = (nc + S - 1) / S;
  return S <= nc && (S - 1) * sc < nc;
}

}  // namespace ssd
