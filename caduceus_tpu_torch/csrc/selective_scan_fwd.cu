// selective_scan_fwd: the Mamba-1 selective scan forward for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute one function:
// - `_fwd_kernel` of caduceus_tpu/ops/scan_pallas.py (launched by
//   `selective_scan_pallas_fwd_impl`): one direction, h_init in, hN out,
//   optional chunk carries -- entry point `selective_scan_fwd`;
// - `_bidir_fwd_kernel` of caduceus_tpu/ops/scan_pallas_bidir.py (launched
//   by `bidir_scan_fwd_impl`): two parameter sets in one launch, set 1
//   scanned left to right and set 2 right to left -- entry point
//   `bidir_scan_fwd`.
// Plain version: caduceus_tpu_torch/ops/selective_scan.py `selective_scan`;
// Python wrappers: caduceus_tpu_torch/ops/scan.py.
//
// Per row t in scan order (right to left when `reverse`), channel c, state n:
//   delta = softplus(delta_raw + bias)                 (optional softplus)
//   h     = exp(delta A) h + delta u B                 fp32 state
//   y     = sum_n C h + D u
//
// Design, translated from the TPU structure rather than copied:
// - Parallelism. A thread owns one (g, set, channel, n): 16 lanes hold a
//   channel at N = 16. A block of 256 threads is a tile of 16 channels; the
//   grid is (d / 16, G, sets). At the training shape (G = 4, d = 512, 2
//   sets) that is 256 blocks, 65,536 threads: about 2 blocks (16 warps) per
//   SM on 132 SMs.
//   One thread per (g, set, channel) with 16 states in registers would give
//   4,096 threads, 32 of them per SM: a few SMs' worth.
// - Each block walks all of its chunks in a loop (the TPU's sequential grid
//   axis): a chunk of T = 64 rows of u, delta (resolved once per (row,
//   channel)), B and C is staged in shared memory, and the serial walk of a
//   chunk carries only the FMA chain h = dA h + v from row to row. C h of
//   every (row, thread) goes to shared memory (64 KB) and y's sum over n is
//   a block-wide pass after the walk, which also adds D u and writes whole
//   rows of the tile: no row of the walk waits on a reduction. The next
//   chunk's operands are loaded into registers before this chunk
//   is walked, so their latency overlaps the walk.
// - B and C are read through their row strides: they are column slices of
//   the (G, L, dt_rank + 2N) x_proj output, 32 bytes a row each in bf16, so
//   no copy is made.
// - Rows >= L are identity steps (delta = u = B = C = 0 in the staging) and
//   are not written: no padded copy, and hN is the true final state for a
//   ragged L in both directions.
// - dA = exp2f(delta * A log2(e)), A pre-scaled once per thread: one MUFU
//   op per (row, channel, n).
// - Carries: the fp32 state entering each chunk, (G, nc, d, N) indexed by
//   array chunk (a deliberate difference: the TPU kernel stores them in
//   bf16). 4 bytes x N x d / T = 512 B per row at d = 512.
//
// Bound on the card: bytes. Per row and set it reads u and delta (2 x 1024
// B in bf16 at d = 512) and B and C (2 x 32 B) and writes y (1024 B), and
// does ~5 FLOP per (channel, n); the exps (one per (row, channel, n), 16
// per clock per SM) take longer than either. Known costs of this version:
// the walk is serial over L within a block, so a long sequence keeps few
// SMs busy, and the loads are 32-byte row segments.

#include <cstring>

#include "scan_common.cuh"

using namespace scan;

namespace {

struct Params {
  Dir sets[2];
  int G, L, d, N, dt_softplus;
};

template <typename S>
__global__ void __launch_bounds__(NTHREADS) selective_scan_fwd_kernel(const Params p) {
  constexpr int CWMAX = NTHREADS / 8;
  __shared__ float us[T * CWMAX], ds[T * CWMAX];
  __shared__ float Bs[T * 32], Cs[T * 32];
  extern __shared__ float ps[];  // (T, NTHREADS): C h of every row and thread
  const Dir& q = p.sets[blockIdx.z];
  const int N = p.N, d = p.d, L = p.L;
  const int CW = NTHREADS / N;
  const int tid = threadIdx.x;
  const int c = tid / N, n = tid % N;
  const int c0 = blockIdx.x * CW;
  const int ch = c0 + c;
  const int g = blockIdx.y;
  const bool valid = ch < d;
  const bool rev = q.reverse != 0;
  const long long sidx = ((long long)g * d + ch) * N + n;
  const float A2 = valid ? q.A[ch * N + n] * LOG2E : 0.f;
  float h = (valid && q.h_init) ? q.h_init[sidx] : 0.f;
  S* y = static_cast<S*>(q.y) + (long long)g * L * d;
  const int nc = (L + T - 1) / T;
  // the channel of every (row, channel) item this thread stages or sums
  const int cs = c0 + tid % CW;
  const float bias_c = (q.bias && cs < d) ? q.bias[cs] : 0.f;
  const float D_c = (q.D && cs < d) ? q.D[cs] : 0.f;
  ChunkRegs<S> next;
  load_chunk<S>(q, g, (long long)(rev ? nc - 1 : 0) * T, L, c0, CW, d, N, next);

  for (int ci = 0; ci < nc; ++ci) {
    const int chunk = rev ? nc - 1 - ci : ci;
    const long long row0 = (long long)chunk * T;
    stage_chunk<S>(row0, L, c0, CW, d, N, p.dt_softplus != 0, bias_c, next, us, ds, Bs, Cs);
    if (q.carries && valid) q.carries[(((long long)g * nc + chunk) * d + ch) * N + n] = h;
    __syncthreads();
    // the next chunk's loads fly while this one is walked
    if (ci + 1 < nc) load_chunk<S>(q, g, row0 + (rev ? -T : T), L, c0, CW, d, N, next);
    // the serial walk: only the FMA chain through h is carried from row to
    // row; C h is stored and summed over n after the chunk
#pragma unroll 8
    for (int k = 0; k < T; ++k) {
      const int t = rev ? T - 1 - k : k;
      const float dd = ds[t * CW + c];
      h = fmaf(exp2f(dd * A2), h, dd * us[t * CW + c] * Bs[t * N + n]);
      ps[t * NTHREADS + tid] = Cs[t * N + n] * h;
    }
    __syncthreads();
    // y[t, c] = sum_n C h + D u, one (row, channel) per item; the start of
    // the n loop turns with c so that a warp's reads spread over the banks
    for (int i = tid; i < T * CW; i += NTHREADS) {
      const long long r = row0 + i / CW;
      const int cl = i % CW;
      const float* pr = ps + (i / CW) * NTHREADS + cl * N;
      float yv = 0.f;
      for (int j = 0; j < N; ++j) yv += pr[(j + cl) & (N - 1)];
      if (r < L && cs < d) y[r * d + cs] = from_f<S>(yv + D_c * us[i]);
    }
    __syncthreads();  // the next chunk's staging and walk overwrite us, ps
  }
  if (q.hN && valid) q.hN[sidx] = h;
}

cudaError_t launch(int dtype, int nsets, const long long* sets, int G, int L, int d, int N,
                   int dt_softplus, void* stream) {
  if (!valid_n(N) || G <= 0 || L <= 0 || d <= 0 || nsets < 1 || nsets > 2)
    return cudaErrorInvalidValue;
  Params p;
  std::memset(&p, 0, sizeof(p));
  std::memcpy(p.sets, sets, sizeof(Dir) * nsets);
  p.G = G; p.L = L; p.d = d; p.N = N; p.dt_softplus = dt_softplus;
  const int CW = NTHREADS / N;
  dim3 grid((d + CW - 1) / CW, G, nsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = (int)(sizeof(float) * T * NTHREADS);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(selective_scan_fwd_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    selective_scan_fwd_kernel<__nv_bfloat16><<<grid, NTHREADS, smem, s>>>(p);
  } else if (dtype == 0) {
    err = cudaFuncSetAttribute(selective_scan_fwd_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    selective_scan_fwd_kernel<float><<<grid, NTHREADS, smem, s>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `set` is one Dir as DIR_WORDS 64-bit
// words (pointers as integers; null = 0). Returns the cudaError_t of the
// launch.
extern "C" int selective_scan_fwd(int dtype, const long long* set, int G, int L, int d, int N,
                                  int dt_softplus, void* stream) {
  return (int)launch(dtype, 1, set, G, L, d, N, dt_softplus, stream);
}

// Two sets, 2 x DIR_WORDS words: set 1 is scanned left to right, set 2
// right to left (their `reverse` words are overwritten to say so).
extern "C" int bidir_scan_fwd(int dtype, const long long* sets, int G, int L, int d, int N,
                              int dt_softplus, void* stream) {
  long long s[2 * DIR_WORDS];
  std::memcpy(s, sets, sizeof(s));
  s[DIR_WORDS - 1] = 0;
  s[2 * DIR_WORDS - 1] = 1;
  return (int)launch(dtype, 2, s, G, L, d, N, dt_softplus, stream);
}
