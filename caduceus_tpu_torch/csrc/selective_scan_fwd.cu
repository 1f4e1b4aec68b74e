// selective_scan_fwd: the Mamba-1 selective scan forward for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute one function:
// - `_fwd_kernel` of caduceus_tpu/ops/scan_pallas.py (launched by
//   `selective_scan_pallas_fwd_impl`, TPU kernel #7): one direction, h_init
//   in, hN out, optional chunk carries, optional SiLU(z) gate of y
//   (`has_z`) -- entry point `selective_scan_fwd`;
// - `_bidir_fwd_kernel` of caduceus_tpu/ops/scan_pallas_bidir.py (launched
//   by `bidir_scan_fwd_impl`, #9): two parameter sets in one launch, set 1
//   scanned left to right and set 2 right to left -- entry point
//   `bidir_scan_fwd`.
// Plain version: caduceus_tpu_torch/ops/selective_scan.py `selective_scan`
// (the decomposition below: `selective_scan_runs`); Python wrappers:
// caduceus_tpu_torch/ops/scan.py.
//
// Per row t in scan order (right to left when `reverse`), channel c, state n:
//   delta = softplus(delta_raw + bias)                 (optional softplus)
//   h     = exp(delta A) h + delta u B                 fp32 state
//   y     = (sum_n C h + D u) * z sigmoid(z)           (gate optional)
//
// Design (scan_common.cuh): a warp per (g, set, channel), its lane j owning
// a run of R = 8 consecutive rows of each chunk of CH = 256 rows. Per chunk
// and state n a thread computes its run's dA = 2^(delta A log2 e) (the
// only exp of that (row, channel, n); ex2.approx, denormals flushed) and the run's affine aggregate
// (prod dA, h from 0); a warp scan of the 32 aggregates (5 shuffle steps)
// gives each run its incoming state from the chunk's, and the thread re-walks
// its run from it with the dA it kept in registers, adding C h to its y in
// registers: y's sum over n needs no shared memory and no barrier.
// - Parallelism: G x d x sets warps, each walking L / 256 chunks, in blocks
//   of W warps (W channels), grid (d / W, G, sets). W = 8: 512 blocks of 256
//   threads at the training shape. Where blocks of 8 would be fewer than the
//   SMs, in fp32, W = 4: a 131k prefill (G = 1) runs 128 blocks of 128 threads
//   instead of 64 of 256, each thread with up to 255 registers, which the
//   state loop, unrolled by 2, uses to walk two states interleaved (its
//   512 warps are latency-bound: fewer warps per SM and two independent
//   chains per warp each help: on an H100 SXM 3.65 -> 2.75 ms,
//   `phase_cutouts.py --set scan-prefill`).
// - Staging: the next chunk's u, delta, z (16 bytes a row for the tile's 8
//   channels in bf16), B and C (column slices of the x_proj output, read
//   through their row strides, no copy) are 16-byte cp.async copies issued
//   right after this chunk's are consumed, so they land while the chunk is
//   walked. B and C are transposed once per chunk into fp32 (n, run, item)
//   tiles a lane reads in two 16-byte loads per state; each thread reads its
//   own rows of u and delta and resolves delta once per (row, channel).
// - y (and the gate) leave through a staged tile, one 16-byte store a row.
// - Rows >= L are identity steps (delta = u = B = C = 0) and are not
//   written: no padded copy, and hN is the true final state for a ragged L
//   in both directions.
// - Carries: the fp32 state entering each chunk, (G, nc, d, N), one per
//   256 rows (128 B a row at d = 512, N = 16); lane n of a warp keeps
//   state n's carry.
//
// Bound on the card: bytes (u, delta, z read, y written, B and C) against
// fp32 FLOP on the non-tensor-core units; the exps (MUFU, 16 per clock per
// SM) take longer than either, and so does the issue of the ~12
// instructions a (row, channel, n) costs.

#include <cstring>

#include "scan_common.cuh"

using namespace scan;

namespace {

struct Params {
  Dir sets[2];
  int G, L, d, N, dt_softplus;
};

// B and C are transposed into fp32 tiles (no conversion in the walk). W:
// channels (warps) per block.
template <typename S, int W>
struct Smem {
  unsigned char *u, *dl, *z, *B, *C, *ys;
  float *Bt, *Ct;
  static size_t bytes(int N, bool gate) {
    return (size_t)(gate ? 4 : 3) * staged_bytes<S>(W) + 2 * (size_t)staged_bytes<S>(N) +
           2 * (size_t)trans_bytes<float>(N);
  }
  __device__ Smem(unsigned char* p, int N, bool gate) {
    const int cb = staged_bytes<S>(W);
    u = p; p += cb;
    dl = p; p += cb;
    ys = p; p += cb;
    z = p; p += gate ? cb : 0;
    B = p; p += staged_bytes<S>(N);
    C = p; p += staged_bytes<S>(N);
    Bt = reinterpret_cast<float*>(p); p += trans_bytes<float>(N);
    Ct = reinterpret_cast<float*>(p);
  }
};

template <typename S, int W>
__device__ __forceinline__ void stage_chunk(const Smem<S, W>& sm, const Dir& q, int g,
                                            long long row0, int L, int c0, int d, int N,
                                            const bool (&vec)[5]) {
  constexpr int NT = 32 * W;
  stage<S, NT>(sm.u, static_cast<const S*>(q.u) + g * q.u_sg, q.u_sl, row0, L, c0, W, d, vec[0]);
  stage<S, NT>(sm.dl, static_cast<const S*>(q.delta) + g * q.d_sg, q.d_sl, row0, L, c0, W, d,
               vec[1]);
  stage<S, NT>(sm.B, static_cast<const S*>(q.B) + g * q.b_sg, q.b_sl, row0, L, 0, N, N, vec[2]);
  stage<S, NT>(sm.C, static_cast<const S*>(q.C) + g * q.c_sg, q.c_sl, row0, L, 0, N, N, vec[3]);
  if (q.z)
    stage<S, NT>(sm.z, static_cast<const S*>(q.z) + g * q.z_sg, q.z_sl, row0, L, c0, W, d,
                 vec[4]);
  cp_async_commit();
}

template <typename S, bool REV, bool Z, int N, int W>
__device__ void walk(const Params& p, const Dir& q, unsigned char* smem) {
  constexpr int NT = 32 * W;
  const int d = p.d, L = p.L;
  const bool gate = Z && q.z != nullptr;
  Smem<S, W> sm(smem, N, Z);
  float* Bt = sm.Bt;
  float* Ct = sm.Ct;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int c0 = blockIdx.x * W, ch = c0 + w, g = blockIdx.y;
  const bool valid = ch < d;
  // scan-order run j = lane covers the array run `run`, walked backwards
  // when REV
  const int run = REV ? RUNS - 1 - lane : lane;
  const long long sidx = ((long long)g * d + ch) * N + lane;
  // lane n keeps state n's A log2(e) and carry
  const float A2n = (valid && lane < N) ? q.A[ch * N + lane] * LOG2E : 0.f;
  float hc = (valid && lane < N && q.h_init) ? q.h_init[sidx] : 0.f;
  const float bias = (valid && q.bias) ? q.bias[ch] : 0.f;
  const float Dc = (valid && q.D) ? q.D[ch] : 0.f;
  S* y = static_cast<S*>(q.y) + (long long)g * L * d;
  const int nc = (L + CH - 1) / CH;
  const bool vec[5] = {
      vec_ok(static_cast<const S*>(q.u) + g * q.u_sg, q.u_sl, c0, W, d),
      vec_ok(static_cast<const S*>(q.delta) + g * q.d_sg, q.d_sl, c0, W, d),
      vec_ok(static_cast<const S*>(q.B) + g * q.b_sg, q.b_sl, 0, N, N),
      vec_ok(static_cast<const S*>(q.C) + g * q.c_sg, q.c_sl, 0, N, N),
      gate && vec_ok(static_cast<const S*>(q.z) + g * q.z_sg, q.z_sl, c0, W, d)};
  const bool vec_y = vec_ok(y, (long long)d, c0, W, d);

  stage_chunk<S, W>(sm, q, g, (long long)(REV ? nc - 1 : 0) * CH, L, c0, d, N, vec);
  for (int ci = 0; ci < nc; ++ci) {
    const int chunk = REV ? nc - 1 - ci : ci;
    const long long row0 = (long long)chunk * CH;
    cp_async_wait_all();
    __syncthreads();
    transpose_bc<S, float, NT>(sm.B, Bt, N);
    transpose_bc<S, float, NT>(sm.C, Ct, N);
    // the run's channel values: resolved delta, delta u, and y's start D u
    float dd[R], du[R], y_[R], gz[Z ? R : 1];
    {
      float uu[R], dr[R];
      load_channel<S, W>(sm.u, run, w, uu);
      load_channel<S, W>(sm.dl, run, w, dr);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        float x = 0.f;
        if (row0 + run * R + a < L && valid) {
          x = dr[a] + bias;
          if (p.dt_softplus) x = softplus(x);
        }
        dd[a] = x;
        du[a] = x * uu[a];
        y_[a] = Dc * uu[a];
      }
      if constexpr (Z) {
        if (gate) {
          load_channel<S, W>(sm.z, run, w, gz);
#pragma unroll
          for (int a = 0; a < R; ++a) gz[a] = gz[a] / (1.f + expf(-gz[a]));
        }
      }
    }
    if (q.carries && valid && lane < N)
      q.carries[(((long long)g * nc + chunk) * d + ch) * N + lane] = hc;
    __syncthreads();  // the tiles are transposed; the staging is free
    if (ci + 1 < nc) stage_chunk<S, W>(sm, q, g, row0 + (REV ? -CH : CH), L, c0, d, N, vec);

    // two states interleaved in the 4-warp blocks, whose threads may take
    // twice the registers
#pragma unroll (W == 4 ? 2 : 1)
    for (int n = 0; n < N; ++n) {
      const float A2 = __shfl_sync(FULL, A2n, n);
      const float h_in = __shfl_sync(FULL, hc, n);
      float b[R], dA[R], v[R];
      load_run<float>(Bt, n, run, b);
      float P = 1.f, H = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {  // scan step i of the run, array row a
        const int a = REV ? R - 1 - i : i;
        dA[i] = ex2(dd[a] * A2);
        v[i] = du[a] * b[a];
        H = fmaf(dA[i], H, v[i]);
        P *= dA[i];
      }
      scan_up(P, H, lane);
      const float Pe = __shfl_up_sync(FULL, P, 1), He = __shfl_up_sync(FULL, H, 1);
      float h = lane == 0 ? h_in : fmaf(Pe, h_in, He);
      if (SCAN_DROP == 1 && lane == DROP_LANE) h = 0.f;
      const float h_out = __shfl_sync(FULL, fmaf(P, h_in, H), 31);
      if (lane == n) hc = h_out;
      float c[R];
      load_run<float>(Ct, n, run, c);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int a = REV ? R - 1 - i : i;
        h = fmaf(dA[i], h, v[i]);
        y_[a] = fmaf(c[a], h, y_[a]);
      }
    }

    // y (gated) through the staged tile, one row a piece
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int t = run * R + a;
      float yv = y_[a];
      if constexpr (Z) {
        if (gate) yv *= gz[a];
      }
      staged_row<S>(sm.ys, W, t)[w] = from_f<S>(yv);
    }
    __syncthreads();
    if (vec_y) {
      constexpr int ppr = W * (int)sizeof(S) >= 16 ? W * (int)sizeof(S) / 16 : 1;
      for (int i = threadIdx.x; i < CH * ppr; i += NT) {
        const int t = i / ppr, k = i % ppr;
        if (row0 + t < L)
          reinterpret_cast<uint4*>(y + (row0 + t) * d + c0)[k] = reinterpret_cast<const uint4*>(
              staged_row<S>(sm.ys, W, t))[k];
      }
    } else {
      for (int i = threadIdx.x; i < CH * W; i += NT) {
        const int t = i / W, e = i % W;
        if (row0 + t < L && c0 + e < d)
          y[(row0 + t) * d + c0 + e] = staged_row<S>(sm.ys, W, t)[e];
      }
    }
  }
  if (q.hN && valid && lane < N) q.hN[sidx] = hc;
}

template <typename S, bool Z, int N, int W>
__global__ void __launch_bounds__(32 * W, 2) selective_scan_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dir& q = p.sets[blockIdx.z];
  if (q.reverse)
    walk<S, true, Z, N, W>(p, q, smem);
  else
    walk<S, false, Z, N, W>(p, q, smem);
}

template <typename S, bool Z, int N, int W>
cudaError_t launch_w(const Params& p, int nsets, cudaStream_t s) {
  const size_t smem = Smem<S, W>::bytes(N, Z);
  cudaError_t err = cudaFuncSetAttribute(selective_scan_fwd_kernel<S, Z, N, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.d + W - 1) / W, p.G, nsets);
  selective_scan_fwd_kernel<S, Z, N, W><<<grid, 32 * W, smem, s>>>(p);
  return cudaGetLastError();
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// Blocks of 8 channels, or in fp32 of 4 where blocks of 8 would be fewer
// than the SMs (the v1 prefill's G = 1: 128 blocks of 4 instead of 64 of
// 8). In bf16 the 4 channels' rows are 8 bytes, which the 16-byte cp.async
// staging does not take.
template <typename S, bool Z, int N>
cudaError_t launch_n(const Params& p, int nsets, cudaStream_t s) {
  if constexpr (sizeof(S) == 4) {
    const long long blocks8 = (long long)((p.d + 7) / 8) * p.G * nsets;
    if (blocks8 < sm_count()) return launch_w<S, Z, N, 4>(p, nsets, s);
  }
  return launch_w<S, Z, N, 8>(p, nsets, s);
}

template <typename S, bool Z>
cudaError_t launch_z(const Params& p, int nsets, cudaStream_t s) {
  if (p.N == 8) return launch_n<S, Z, 8>(p, nsets, s);
  if (p.N == 16) return launch_n<S, Z, 16>(p, nsets, s);
  return launch_n<S, Z, 32>(p, nsets, s);
}

// the gated instantiation only when a set has a gate
template <typename S>
cudaError_t launch_t(const Params& p, int nsets, cudaStream_t s) {
  bool gate = false;
  for (int k = 0; k < nsets; ++k) gate = gate || p.sets[k].z != nullptr;
  return gate ? launch_z<S, true>(p, nsets, s) : launch_z<S, false>(p, nsets, s);
}

cudaError_t launch(int dtype, int nsets, const long long* sets, int G, int L, int d, int N,
                   int dt_softplus, void* stream) {
  if (!valid_n(N) || G <= 0 || L <= 0 || d <= 0 || nsets < 1 || nsets > 2)
    return cudaErrorInvalidValue;
  Params p;
  std::memset(&p, 0, sizeof(p));
  std::memcpy(p.sets, sets, sizeof(Dir) * nsets);
  p.G = G; p.L = L; p.d = d; p.N = N; p.dt_softplus = dt_softplus;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_t<__nv_bfloat16>(p, nsets, s);
  if (dtype == 0) return launch_t<float>(p, nsets, s);
  return cudaErrorInvalidValue;
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
// right to left (their `reverse` words are overwritten to say so); no gate.
extern "C" int bidir_scan_fwd(int dtype, const long long* sets, int G, int L, int d, int N,
                              int dt_softplus, void* stream) {
  long long s[2 * DIR_WORDS];
  std::memcpy(s, sets, sizeof(s));
  s[DIR_WORDS - 1] = 0;
  s[2 * DIR_WORDS - 1] = 1;
  return (int)launch(dtype, 2, s, G, L, d, N, dt_softplus, stream);
}
