// attention_common.cuh: what the flash-attention kernels of
// attention_fwd.cu and attention_bwd.cu share.
//
// Two designs, one per storage type:
//
// - bf16, the path's type (`hop` below): Hopper's warpgroup products fed
//   by the Tensor Memory Accelerator. A block is two warpgroups (256
//   threads); each warpgroup owns 64 rows of the block's 128-row tile and
//   runs its products as `wgmma.mma_async` m64nNk16 (bf16 in, fp32
//   accumulators in registers). The block's fixed rows (Q in the forward;
//   K and V in dK / dV; Q and dO in dQ) and the tiles it walks over (K / V;
//   Q, dO, lse and D) arrive by TMA: one thread arms a slot's mbarrier with
//   the bytes due and issues one copy a tile (any row stride through a 4-d
//   tensor map, so q, k, v may be strided views of one packed tensor; rows
//   past L arrive as zeros); the consumers wait on the slot's phase. The
//   walked tiles use a ring of STAGES slots, two tiles in flight while one
//   is used, and one block barrier a tile frees the slot read last (a
//   release barrier a slot instead, which lets the warpgroups drift apart,
//   measured slower: PERF.md §6). Tiles
//   land in the swizzled layout wgmma reads (128-, 64- or 32-byte rows of
//   up to 64 head elements, `Sw`), read K-major (rows along M / N, the head
//   dimension along K) by S = Q K^T and MN-major (rows along K) by
//   O += P V. The second product of each pair takes its A operand (P, dS)
//   from registers: the first product's accumulators, rounded to bf16, are
//   already laid out as wgmma's A fragments, so P and dS never touch
//   shared memory.
//
// - fp32 (`warp_mma` below): the first design, kept as it was. A block is 4
//   warps; each warp owns 16 rows of a 64-row tile and computes the
//   accumulators of the m16n8 layout with FMAs (wgmma has no fp32
//   operands, and TF32 would miss the fp32 tolerance). It serves the
//   fp32 model and the small-shape checks.
//
// Both designs hold their accumulators in the m16n8 layout per warp: lane
// (g = lane / 4, t = lane % 4) of the warp owning rows w16 .. w16 + 15
// holds rows w16 + g and w16 + g + 8, columns 2t and 2t + 1 of every
// 8-column slice (`c[j][0..3]`), so the stores and the softmax are one
// for both.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

using bf16 = __nv_bfloat16;

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

// Accumulator pair (x, y) -> two consecutive elements of type T.
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

template <typename T>
__device__ __forceinline__ T* row_ptr(const View& v, int b, int h, int row) {
  return reinterpret_cast<T*>(v.p) + (long long)b * v.sb + (long long)row * v.sl +
         (long long)h * v.sh;
}

// A warp's 16 x 8 NT accumulators (times `mul`) to rows row0 and row0 + 8 of
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

// ---- fp32: the FMA design ------------------------------------------------

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int WARPS = 4;      // 16 rows each
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;        // elements added to every shared-memory row

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

// C (16 x 8 NT) += A (16 x KD) B (KD x 8 NT), both in shared memory:
// A(m, k) = A[m * a_rs + k * a_ks], B(k, n) = B[k * b_ks + n * b_ns]; each
// thread computes its own accumulator elements with FMAs.
template <int NT, int KD>
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

// A warp's 16 x 8 NT accumulators into a (16, ld) tile.
template <int NT>
__device__ __forceinline__ void store_acc(float* s, int ld, const float (&c)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store2(s + g * ld + 8 * j + 2 * t, c[j][0], c[j][1]);
    store2(s + (g + 8) * ld + 8 * j + 2 * t, c[j][2], c[j][3]);
  }
}

// ---- bf16: the Hopper design ---------------------------------------------

namespace hop {

constexpr int WGS = 2;                 // warpgroups a block
constexpr int THREADS = WGS * 128;
constexpr int BM = 64;                 // rows a warpgroup owns (wgmma's M)
constexpr int BT = WGS * BM;           // rows a block owns
constexpr int BN = 64;                 // rows of a ring tile (keys, or queries in dK / dV)
constexpr int NS = BN / 8;             // 8-column slices of a score tile
constexpr int STAGES = 3;              // ring slots: two tiles in flight while one is used
constexpr int ALIGN = 1024;            // a swizzled tile's alignment in shared memory

// Blocks an SM by head width where a kernel sets no count of its own: two
// while the accumulators fit 128 registers a thread.
constexpr int blocks_per_sm(int hd) { return hd <= 64 ? 2 : 1; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A tile in shared memory as TMA writes it and wgmma reads it: column
// blocks of CB = min(HD, 64) head elements, each ROWS rows of SW = 2 CB
// bytes (32, 64 or 128), the 16-byte chunks of each row swizzled by its
// row within 8-row atoms (TMA's SWIZZLE_<SW>B, wgmma's B<SW> layout).
template <int HD>
struct Sw {
  static constexpr int CB = HD < 64 ? HD : 64;
  static constexpr int SW = 2 * CB;
  static constexpr int NCB = HD / CB;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
};

// Shared-memory matrix descriptor: start address, LBO and SBO in bytes,
// the swizzle layout.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}
// Rows from `start` of a ROWS-row tile read K-major (rows along M or N, HD
// along K): the k16 step s is 32 bytes into column block 16 s / CB; SBO
// steps 8 rows.
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t start, int s) {
  using W = Sw<HD>;
  const int col = 16 * s;
  return desc(start + (col / W::CB) * ROWS * W::SW + (col % W::CB) * 2, 16, 8 * W::SW, W::LAYOUT);
}
// A ROWS-row tile read MN-major (rows along K, HD along N): the k16 step s
// is rows 16 s .. 16 s + 15; LBO steps a column block, SBO 8 rows.
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int s) {
  using W = Sw<HD>;
  return desc(tile + 16 * W::SW * s, ROWS * W::SW, 8 * W::SW, W::LAYOUT);
}

// -- mbarriers: one thread arms a slot's barrier with the bytes its TMA
// loads bring; the consumers wait for the phase of the tile they need.
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// After the inits, before a barrier: the barriers visible to the other
// threads and to the async proxy (the TMA unit).
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits for the phase of parity `parity`, spinning until it completes, as
// CUTLASS's ClusterBarrier::wait does: a tile whose load never lands hangs
// the block rather than letting it compute on what the slot held before
// (a bounded wait that fell through returned wrong values and no error).
// The loop is in the PTX, so a warp leaves it together and meets the
// warpgroup instructions after it converged.
//
// Probe builds (-D defines; chip_smoke.py [attn_kernels],
// attn_wait_probe.py), never the shipped library:
// - ATTN_POLLS: the same wait as a counted C loop; lane 0 of every warp
//   raises the largest poll count one wait took into attn_poll_stats[0]
//   and adds its waits and polls to [1] and [2] (`attn_polls` reads and
//   clears them);
// - ATTN_WAIT_TRAP=1: the wait these kernels first had, bounded at 2^24 polls and
//   then `__trap()`; =2: the same with a `__syncwarp()` before it returns
//   from a wait that completed;
// - ATTN_LOST (attention_fwd.cu, with ATTN_WAIT_TRAP only): key tile 1's
//   loads are announced on its barrier and never issued, a lost load.
#ifdef ATTN_POLLS
__device__ unsigned long long attn_poll_stats[3];
#endif
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
#if defined(ATTN_WAIT_TRAP)
  for (uint32_t n = 0; n < (1u << 24); ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) {
#if ATTN_WAIT_TRAP == 2
      __syncwarp();
#endif
      return;
    }
  }
  __trap();
#elif defined(ATTN_POLLS)
  uint32_t done = 0;
  unsigned long long n = 0;
  while (!done) {
    ++n;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&attn_poll_stats[0], n);
    atomicAdd(&attn_poll_stats[1], 1ull);
    atomicAdd(&attn_poll_stats[2], n);
  }
#else
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
#endif
}

// -- TMA: (B, L, H, hd) views through 4-d maps (hd, H, L, B) with boxes of
// (CB, 1, ROWS, 1); rows past L arrive as zeros. Per-row fp32 values (lse,
// D) go by `cp4`, a thread a row.
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c,
                                       int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(h), "r"(row), "r"(b)
      : "memory");
}
// 4 bytes global -> shared (zeros where !valid), and an arrival on `bar`
// once this thread's copies have landed (counted in the barrier's init).
__device__ __forceinline__ void cp4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// ROWS rows of head h of sequence b from row r0 (every column block) into
// the tile at `dst`; 2 ROWS HD bytes on `bar`.
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar, int b,
                                          int h, int r0) {
  using W = Sw<HD>;
#pragma unroll
  for (int c = 0; c < W::NCB; ++c) tma_4d(dst + c * ROWS * W::SW, map, bar, c * W::CB, h, r0, b);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of accumulators across the
// asynchronous products' issue and wait.
template <int NT>
__device__ __forceinline__ void pin(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(c[j][e])::"memory");
}

// D (64 x 64) (+)= A B^T, both K-major tiles in shared memory (`acc` 0: D =).
__device__ __forceinline__ void mma_ss(float (&d)[8][4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x N) += A (registers, 64 x 16) B (an MN-major tile, 16 x N), N = 16, 32,
// 64 or 128.
__device__ __forceinline__ void mma_rs(float (&d)[2][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[4][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A warpgroup's 64 x 64 accumulators of one product as the bf16 A operand
// of the next (K = the 64 columns, four k16 steps): the m16n8 accumulator
// pairs are wgmma's A fragments.
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void to_a(uint32_t (&a)[NS / 2][4], const float (&c)[NS][4]) {
#pragma unroll
  for (int k = 0; k < NS / 2; ++k) {
    a[k][0] = pack2(c[2 * k][0], c[2 * k][1]);
    a[k][1] = pack2(c[2 * k][2], c[2 * k][3]);
    a[k][2] = pack2(c[2 * k + 1][0], c[2 * k + 1][1]);
    a[k][3] = pack2(c[2 * k + 1][2], c[2 * k + 1][3]);
  }
}

// D (64 x 64) = A B^T over the head dimension: A the 64 rows from `a` of a
// BT-row tile, B a BN-row tile, both K-major; HD / 16 k16 steps.
template <int HD>
__device__ __forceinline__ void scores(float (&d)[NS][4], uint32_t a, uint32_t b) {
#pragma unroll
  for (int s = 0; s < HD / 16; ++s) mma_ss(d, desc_k<HD, BT>(a, s), desc_k<HD, BN>(b, s), s > 0);
}

// D (64 x HD) += A (registers, 64 x 64) B (a BN-row tile read MN-major).
template <int HD>
__device__ __forceinline__ void accumulate(float (&d)[HD / 8][4], const uint32_t (&a)[NS / 2][4],
                                           uint32_t b) {
#pragma unroll
  for (int k = 0; k < NS / 2; ++k) mma_rs(d, a[k], desc_mn<HD, BN>(b, k));
}

// ---- host: the tensor maps (the encoder is looked up at run time, so the
// library links to the CUDA runtime alone) --------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 (B, L, H, hd) view: boxes of `rows` rows by CB head elements,
// swizzled (see `Sw`).
inline bool tile_map(CUtensorMap* m, const View& v, int B, int L, int H, int hd, int rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const int cb = hd < 64 ? hd : 64;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)v.sh * 2, (cuuint64_t)v.sl * 2, (cuuint64_t)v.sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cb, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = cb == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : cb == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, v.p, dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hop

}  // namespace attn

#ifdef ATTN_POLLS
// The probe build's counters (see `bar_wait`): out[0] the largest poll
// count of one wait, out[1] the waits, out[2] the polls, by lane 0 of
// each warp since the last call; cleared. Returns a cudaError_t.
extern "C" int attn_polls(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, attn::hop::attn_poll_stats, 3 * sizeof(unsigned long long));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[3] = {0, 0, 0};
  return (int)cudaMemcpyToSymbol(attn::hop::attn_poll_stats, zero, sizeof(zero));
}
#endif
