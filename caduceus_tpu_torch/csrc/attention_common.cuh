// attention_common.cuh: what the flash-attention kernels of
// attention_fwd.cu and attention_bwd.cu share: the tile sizes, the view of
// a (B, L, H, hd) operand, the tile loads into shared memory and the
// warp-level tile products.
//
// A block is 4 warps; each warp owns 16 rows of the block's 64-row tile.
// The products run on the operands in shared memory and leave their result
// in the registers of the m16n8 accumulator layout of `mma.sync`: lane
// (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 2t and
// 2t + 1 of every 8-column slice. In bf16 each 16 x 8 x 16 step is one
// `mma.sync.m16n8k16` (bf16 in, fp32 accumulators); in fp32 each thread
// computes the same accumulator elements with FMAs, so the code around the
// products (softmax, masks, stores) is one for both types.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int WARPS = 4;      // 16 rows each
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;        // elements added to every shared-memory row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One operand in the JAX layout (B, L, H, hd), the head dimension
// contiguous; strides in elements.
struct View {
  char* p;
  long long sb, sl, sh;
};

struct Args {
  View q, k, v, o, dout, dq, dk, dv;
  float* lse;     // (B, H, L) fp32: log of each row's softmax denominator
  float* delta;   // (B, H, L) fp32: rowsum(dO * O), the adjoint's prologue
  int B, L, H, causal;
  float scale;
};

inline View view_of(const long long* w) {
  return View{reinterpret_cast<char*>(w[0]), w[1], w[2], w[3]};
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// Rows [r0, r0 + ROWS) of head h of sequence b into a (ROWS, HD + PAD) tile,
// 16 bytes a thread a step; rows at or past L are zeros.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(T* s, const View& v, int b, int h, int r0, int L) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;
  constexpr int LD = HD + PAD;
  const T* base = reinterpret_cast<const T*>(v.p) + (long long)b * v.sb + (long long)h * v.sh;
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * VEC, row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < L) val = *reinterpret_cast<const uint4*>(base + (long long)row * v.sl + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

// Two consecutive k of an operand: one 32-bit load where it is contiguous
// along k, else two 16-bit loads `ks` apart.
template <bool KC>
__device__ __forceinline__ uint32_t pair(const bf16* p, int ks) {
  if (KC) return *reinterpret_cast<const uint32_t*>(p);
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + ks);
  return lo | (hi << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C (16 x 8 NT) += A (16 x KD) B (KD x 8 NT), both in shared memory:
// A(m, k) = A[m * a_rs + k * a_ks], B(k, n) = B[k * b_ks + n * b_ns].
// A_KC / B_KC: a_ks == 1 / b_ks == 1 (contiguous along k).
template <int NT, int KD, bool A_KC, bool B_KC>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const bf16* A, int a_rs, int a_ks,
                                         const bf16* B, int b_ks, int b_ns) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < KD; k0 += 16) {
    const int ka = k0 + 2 * t;
    uint32_t a[4];
    a[0] = pair<A_KC>(A + g * a_rs + ka * a_ks, a_ks);
    a[1] = pair<A_KC>(A + (g + 8) * a_rs + ka * a_ks, a_ks);
    a[2] = pair<A_KC>(A + g * a_rs + (ka + 8) * a_ks, a_ks);
    a[3] = pair<A_KC>(A + (g + 8) * a_rs + (ka + 8) * a_ks, a_ks);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* bp = B + (8 * j + g) * b_ns;
      uint32_t bb[2];
      bb[0] = pair<B_KC>(bp + ka * b_ks, b_ks);
      bb[1] = pair<B_KC>(bp + (ka + 8) * b_ks, b_ks);
      mma_bf16(c[j], a, bb);
    }
  }
}

template <int NT, int KD, bool A_KC, bool B_KC>
__device__ __forceinline__ void warp_mma(float (&c)[NT][4], const float* A, int a_rs, int a_ks,
                                         const float* B, int b_ks, int b_ns) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    const float a0 = A[g * a_rs + k * a_ks], a1 = A[(g + 8) * a_rs + k * a_ks];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = B[k * b_ks + (8 * j + 2 * t) * b_ns];
      const float b1 = B[k * b_ks + (8 * j + 2 * t + 1) * b_ns];
      c[j][0] = fmaf(a0, b0, c[j][0]);
      c[j][1] = fmaf(a0, b1, c[j][1]);
      c[j][2] = fmaf(a1, b0, c[j][2]);
      c[j][3] = fmaf(a1, b1, c[j][3]);
    }
  }
}

// Accumulator pair (x, y) -> two consecutive elements of type T.
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// A warp's 16 x 8 NT accumulators into a (16, ld) tile of T (rounded to T:
// the next product's operand).
template <int NT, typename T>
__device__ __forceinline__ void store_acc(T* s, int ld, const float (&c)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store2(s + g * ld + 8 * j + 2 * t, c[j][0], c[j][1]);
    store2(s + (g + 8) * ld + 8 * j + 2 * t, c[j][2], c[j][3]);
  }
}

template <typename T>
__device__ __forceinline__ T* row_ptr(const View& v, int b, int h, int row) {
  return reinterpret_cast<T*>(v.p) + (long long)b * v.sb + (long long)row * v.sl +
         (long long)h * v.sh;
}

// A warp's 16 x HD accumulators (times `mul`) to rows row0 and row0 + 8 of
// an output view, rows at or past L left out.
template <int NT, typename T>
__device__ __forceinline__ void store_rows(const View& v, int b, int h, int row0, int L,
                                           const float (&c)[NT][4], float mul0, float mul1) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  if (row0 < L) {
    T* p = row_ptr<T>(v, b, h, row0);
#pragma unroll
    for (int j = 0; j < NT; ++j) store2(p + 8 * j + 2 * t, c[j][0] * mul0, c[j][1] * mul0);
  }
  if (row0 + 8 < L) {
    T* p = row_ptr<T>(v, b, h, row0 + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) store2(p + 8 * j + 2 * t, c[j][2] * mul1, c[j][3] * mul1);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

}  // namespace attn
