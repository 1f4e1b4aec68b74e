// selective_scan_bwd: adjoint of the Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute one function:
// - `_bwd_kernel` of caduceus_tpu/ops/scan_pallas.py (launched by
//   `selective_scan_pallas_bwd_impl`, TPU kernel #8): one direction, with
//   the chained contract of `selective_scan_pallas_chained` (`:784-834`):
//   g_hN in, g_h0 out -- entry point `selective_scan_bwd`;
// - `_bidir_bwd_kernel` of caduceus_tpu/ops/scan_pallas_bidir.py (launched
//   by `bidir_scan_bwd_impl`, #10): both BiMamba directions' adjoints in one
//   launch, set 1 left to right and set 2 right to left, from zero states
//   -- entry point `bidir_scan_bwd`, the same kernel over a third grid
//   dimension, as `bidir_scan_fwd` is `selective_scan_fwd`'s. Each set has
//   its own outputs and its own g_BC / shares / tickets scratch, so the two
//   directions' sums never meet.
// Plain version: caduceus_tpu_torch/ops/selective_scan.py
// `selective_scan_bwd` (twice for the pair); Python wrappers:
// caduceus_tpu_torch/ops/scan.py `selective_scan_bwd_cuda` (behind
// `_SelectiveScanFn`, and `_BidirScanFn` by default) and `bidir_scan_bwd`
// (behind `_BidirScanFn` when CADUCEUS_BIDIR_BWD=1).
//
// Per chunk of T rows, walked against the scan order from the forward's
// carries (`scan_pallas.py:26-36`):
//   recompute  h[t] = dA[t] h[t-1] + delta u B over the chunk from its carry
//   sweep      li[t] = lam + C[t] g_y[t];  lam = dA[t] li[t]   (scan-backward)
//              g_C[t,n]  = sum_c g_y h[t]        g_B[t,n] = sum_c li delta u
//              g_du[t,c] = sum_n li B            g_dd[t,c] = sum_n li dA A h[t-1]
//              g_A[c,n] += li dA h[t-1] delta
//   epilogue   g_delta = (g_dd + u g_du) (1 - exp(-delta))   (softplus chain)
//              g_u = D g_y + delta g_du;  g_D += g_y u;  g_bias += g_delta
// After the first chunk in scan order, lam is d loss / d h_init.
//
// Design:
// - The forward's thread layout (scan_common.cuh): thread (c, n) of a
//   256-thread block owns one (g, channel, n) of a 16-channel tile; grid
//   (d / 16, G, sets): 128 blocks a set at G = 4, d = 512.
// - Recompute, then sweep: the recomputed h of the chunk stays in shared
//   memory, one fp32 slot per thread and row (T x 256 x 4 B = 64 KB at
//   T = 64); dA is recomputed in the sweep (exp2f, the forward's bits).
//   lam, g_A and the thread's shares of g_D / g_bias live in registers for
//   the whole walk, and the walk carries only lam from row to row: it
//   stores li per (row, thread) (another 64 KB) and li dA h_prev A in the
//   slot of h that no later row of the walk reads; ~153 KB in all at
//   N = 16, one block per SM.
// - Every sum is a block-wide pass over a whole chunk, outside the walk:
//   g_C (over channels, from h, before the walk), g_du and g_dd (over n),
//   g_B (over channels, from li). g_B and g_C then cross the d / 16 tiles
//   by fp32 global atomics into a (2, G, L, N) workspace the launcher
//   zeroes: they are the only outputs whose summation order changes from
//   run to run.
// - The walks take RB = 8 rows a step: operands and exps first, then the
//   chain, so that a row's shared-memory loads do not wait on the previous
//   row's stores; a chunk's global loads are all issued at once.
// - Sums over G L rows: g_A (d, N), g_D and g_bias. Each block writes its
//   row g's share to a (G, ...) workspace; the last block of a tile to
//   finish (an atomic ticket) adds the G shares in the order g = 0, 1, ...:
//   these sums are deterministic.
// - Rows >= L are identity steps (zero delta, u, B, C, g_y): lam passes
//   them unchanged and they are masked out of every store and sum.
//
// Bound on the card, per launch and direction: it reads u, delta, g_y
// (3 x 1024 B/row in bf16 at d = 512), B, C (64 B) and the carries, and
// writes g_u, g_delta (2 x 1024 B) and g_B, g_C (64 B); the recompute and
// the adjoint are ~20 FLOP per (row, channel, n), and two exps. The
// (2, G, L, N) fp32 workspace (256 B/row read-modify-written by 32 tiles
// through L2) is a cost of the design, beside the bound.

#include <cstring>

#include "scan_common.cuh"

using namespace scan;

namespace {

constexpr int RB = 8;  // rows of a walk step (T % RB == 0)

// One set's cotangents, outputs and scratch.
struct Out {
  const void* g_y;          // (G, L, d) storage dtype, contiguous
  const float* g_hN;        // (G, d, N) or null
  void* g_u;                // (G, L, d) storage dtype
  void* g_delta;            // (G, L, d) storage dtype
  float* g_BC;              // (2, G, L, N), zeroed by the launcher
  float* g_h0;              // (G, d, N) or null
  float* shares;            // (G, d N + 2 d): per-row g shares of g_A, g_D, g_bias
  unsigned int* tickets;    // (d tiles,), zeroed by the launcher
  float* g_A;               // (d, N)
  float* g_D;               // (d,)
  float* g_bias;            // (d,)
};
constexpr int OUT_WORDS = sizeof(Out) / sizeof(long long);
static_assert(sizeof(Out) == OUT_WORDS * sizeof(long long), "Out is a row of 64-bit words");

struct Params {
  Dir q[2];                 // y / hN unused; carries read
  Out o[2];
  int G, L, d, N, dt_softplus;
};

struct Smem {
  float *us, *ds, *gys, *Bs, *Cs, *hs, *lis, *red;
  static size_t bytes(int N) {
    const int CW = NTHREADS / N;
    return sizeof(float) *
           ((size_t)3 * T * CW + (size_t)2 * T * N + (size_t)2 * T * NTHREADS + NTHREADS);
  }
  __device__ Smem(float* p, int N) {
    const int CW = NTHREADS / N;
    us = p; p += T * CW;
    ds = p; p += T * CW;
    gys = p; p += T * CW;
    Bs = p; p += T * N;
    Cs = p; p += T * N;
    hs = p; p += T * NTHREADS;
    lis = p; p += T * NTHREADS;
    red = p;
  }
};

template <typename S>
__global__ void __launch_bounds__(NTHREADS) selective_scan_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem_raw[];
  const int N = p.N, d = p.d, L = p.L, G = p.G;
  Smem sm(smem_raw, N);
  const Dir& q = p.q[blockIdx.z];
  const Out& o = p.o[blockIdx.z];
  const int CW = NTHREADS / N;
  const int tid = threadIdx.x;
  const int c = tid / N, n = tid % N;
  const int c0 = blockIdx.x * CW;
  const int ch = c0 + c;
  const int g = blockIdx.y;
  const bool valid = ch < d;
  const bool rev = q.reverse != 0;
  const long long sidx = ((long long)g * d + ch) * N + n;
  const float A_ = valid ? q.A[ch * N + n] : 0.f;
  const float A2 = A_ * LOG2E;
  const S* gy_g = static_cast<const S*>(o.g_y) + (long long)g * L * d;
  S* gu_g = static_cast<S*>(o.g_u) + (long long)g * L * d;
  S* gd_g = static_cast<S*>(o.g_delta) + (long long)g * L * d;
  float* gB_g = o.g_BC + (long long)g * L * N;
  float* gC_g = o.g_BC + ((long long)G + g) * L * N;
  const int nc = (L + T - 1) / T;

  float lam = (valid && o.g_hN) ? o.g_hN[sidx] : 0.f;
  float gA = 0.f, gDp = 0.f, gbp = 0.f;
  // the channel of every (row, channel) item this thread stages or sums
  const int cs = c0 + tid % CW;
  const float bias_c = (q.bias && cs < d) ? q.bias[cs] : 0.f;
  const float D_c = (q.D && cs < d) ? q.D[cs] : 0.f;
  const int nd = T * CW / NTHREADS, m = N - 1;

  for (int ci = 0; ci < nc; ++ci) {
    // scan-backward order: the scan's last chunk first
    const int chunk = rev ? ci : nc - 1 - ci;
    const long long row0 = (long long)chunk * T;
    {
      // all of the chunk's loads in flight at once, then the staging
      ChunkRegs<S> regs;
      S gyr[MAXPT];
      load_chunk<S>(q, g, row0, L, c0, CW, d, N, regs);
#pragma unroll
      for (int k = 0; k < MAXPT; ++k) {
        const long long r = row0 + (tid + k * NTHREADS) / CW;
        if (k < nd) gyr[k] = (r < L && cs < d) ? gy_g[r * d + cs] : from_f<S>(0.f);
      }
      stage_chunk<S>(row0, L, c0, CW, d, N, p.dt_softplus != 0, bias_c, regs, sm.us, sm.ds,
                     sm.Bs, sm.Cs);
#pragma unroll
      for (int k = 0; k < MAXPT; ++k)
        if (k < nd) sm.gys[tid + k * NTHREADS] = to_f(gyr[k]);
    }
    __syncthreads();

    // recompute h over the chunk from its carry (thread-private slots), RB
    // rows a step: operands and exps first, then the chain
    const float h0 = valid ? q.carries[(((long long)g * nc + chunk) * d + ch) * N + n] : 0.f;
    float h = h0;
    for (int k0 = 0; k0 < T; k0 += RB) {
      float ea[RB], v[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int t = rev ? T - 1 - k0 - j : k0 + j;
        const float dd = sm.ds[t * CW + c];
        ea[j] = exp2f(dd * A2);
        v[j] = dd * sm.us[t * CW + c] * sm.Bs[t * N + n];
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        h = fmaf(ea[j], h, v[j]);
        sm.hs[(rev ? T - 1 - k0 - j : k0 + j) * NTHREADS + tid] = h;
      }
    }
    __syncthreads();

    // g_C[t, n] = sum over the tile's channels of g_y h, one (row, n) per
    // item, in 2 partial sums
    for (int i = tid; i < T * N; i += NTHREADS) {
      const int t = i / N, nn = i % N;
      const long long r = row0 + t;
      if (r >= L) continue;
      const float* hr = sm.hs + t * NTHREADS + nn;
      const float* gr = sm.gys + t * CW;
      float s0 = 0.f, s1 = 0.f;
      for (int cl = 0; cl < CW; cl += 2) {
        s0 = fmaf(gr[cl], hr[cl * N], s0);
        s1 = fmaf(gr[cl + 1], hr[(cl + 1) * N], s1);
      }
      atomicAdd(&gC_g[r * N + nn], s0 + s1);
    }
    __syncthreads();  // the walk overwrites hs

    // the adjoint walk, against the scan order, RB rows a step: operands,
    // h_prev and exps first, then the chain -- only lam is carried from row
    // to row. li goes to `lis`, li dA h_prev A to the row's own slot of h
    // (the row before it in the walk has read it; no later row does; a
    // step reads all of its h_prev before it writes).
    for (int k0 = T - 1; k0 >= 0; k0 -= RB) {
      float ea[RB], dd[RB], cg[RB], hp[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int k = k0 - j;
        const int t = rev ? T - 1 - k : k;
        dd[j] = sm.ds[t * CW + c];
        ea[j] = exp2f(dd[j] * A2);
        cg[j] = sm.Cs[t * N + n] * sm.gys[t * CW + c];
        hp[j] = k == 0 ? h0 : sm.hs[(rev ? t + 1 : t - 1) * NTHREADS + tid];
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int k = k0 - j;
        const int t = rev ? T - 1 - k : k;
        const float li = lam + cg[j];
        const float w = li * ea[j] * hp[j];
        gA = fmaf(w, dd[j], gA);
        lam = ea[j] * li;
        sm.lis[t * NTHREADS + tid] = li;
        sm.hs[t * NTHREADS + tid] = w * A_;
      }
    }
    __syncthreads();

    // per (row, channel): g_du = sum_n li B, g_dd = sum_n li dA h_prev A,
    // then the softplus chain; the n loop's start turns with the channel
    // (banks). The thread's channel is `cs` for every item it takes.
    for (int i = tid; i < T * CW; i += NTHREADS) {
      const int t = i / CW, cl = i % CW;
      const long long r = row0 + t;
      if (r >= L || cs >= d) continue;
      const float* li = sm.lis + t * NTHREADS + cl * N;
      const float* wa = sm.hs + t * NTHREADS + cl * N;
      const float* Bt = sm.Bs + t * N;
      float u0 = 0.f, u1 = 0.f, w0 = 0.f, w1 = 0.f;
      for (int j = cl; j < cl + N; j += 2) {
        u0 = fmaf(li[j & m], Bt[j & m], u0);
        u1 = fmaf(li[(j + 1) & m], Bt[(j + 1) & m], u1);
        w0 += wa[j & m];
        w1 += wa[(j + 1) & m];
      }
      const float gdu = u0 + u1;
      const float dl = sm.ds[i], uu = sm.us[i], gy = sm.gys[i];
      float gdl = fmaf(uu, gdu, w0 + w1);
      if (p.dt_softplus) gdl *= 1.f - expf(-dl);
      gu_g[r * d + cs] = from_f<S>(fmaf(D_c, gy, dl * gdu));
      gd_g[r * d + cs] = from_f<S>(gdl);
      gDp = fmaf(gy, uu, gDp);
      gbp += gdl;
    }
    // g_B[t, n] = sum over the tile's channels of li delta u
    for (int i = tid; i < T * N; i += NTHREADS) {
      const int t = i / N, nn = i % N;
      const long long r = row0 + t;
      if (r >= L) continue;
      const float* lr = sm.lis + t * NTHREADS + nn;
      const float* dr = sm.ds + t * CW;
      const float* ur = sm.us + t * CW;
      float s0 = 0.f, s1 = 0.f;
      for (int cl = 0; cl < CW; cl += 2) {
        s0 = fmaf(lr[cl * N], dr[cl] * ur[cl], s0);
        s1 = fmaf(lr[(cl + 1) * N], dr[cl + 1] * ur[cl + 1], s1);
      }
      atomicAdd(&gB_g[r * N + nn], s0 + s1);
    }
    __syncthreads();  // the next chunk's staging overwrites the tiles
  }

  // this row g's shares, then the tile's last block adds them in g order
  const long long W = (long long)d * N + 2 * d;
  float* share = o.shares + g * W;
  if (valid) {
    if (o.g_h0) o.g_h0[sidx] = lam;
    share[ch * N + n] = gA;
  }
  const int per = NTHREADS / CW;
  for (int j = 0; j < 2; ++j) {
    sm.red[tid] = j == 0 ? gDp : gbp;
    __syncthreads();
    if (tid < CW && c0 + tid < d) {
      float s = 0.f;
      for (int k = 0; k < per; ++k) s += sm.red[tid + k * CW];
      share[(long long)d * N + j * d + c0 + tid] = s;
    }
    __syncthreads();
  }
  __threadfence();  // every thread's shares are visible before the ticket
  __syncthreads();
  __shared__ bool last;
  if (tid == 0) last = atomicAdd(&o.tickets[blockIdx.x], 1u) == (unsigned)(G - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (valid) {
    float s = 0.f;
    for (int gg = 0; gg < G; ++gg) s += __ldcg(o.shares + gg * W + ch * N + n);
    o.g_A[ch * N + n] = s;
  }
  if (tid < 2 * CW) {
    const int j = tid / CW, cc = c0 + tid % CW;
    if (cc < d) {
      float s = 0.f;
      for (int gg = 0; gg < G; ++gg) s += __ldcg(o.shares + gg * W + (long long)d * N + j * d + cc);
      (j == 0 ? o.g_D : o.g_bias)[cc] = s;
    }
  }
}

// Zero each set's g_BC and tickets, then launch over `nsets` sets.
cudaError_t launch(int dtype, Params& p, int nsets, cudaStream_t s) {
  const int G = p.G, L = p.L, d = p.d, N = p.N;
  if (!valid_n(N) || G <= 0 || L <= 0 || d <= 0 || nsets < 1 || nsets > 2)
    return cudaErrorInvalidValue;
  const int CW = NTHREADS / N;
  const int tiles = (d + CW - 1) / CW;
  cudaError_t err;
  for (int k = 0; k < nsets; ++k) {
    if (!p.q[k].carries) return cudaErrorInvalidValue;
    err = cudaMemsetAsync(p.o[k].g_BC, 0, sizeof(float) * 2 * (size_t)G * L * N, s);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(p.o[k].tickets, 0, sizeof(unsigned int) * tiles, s);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = Smem::bytes(N);
  dim3 grid(tiles, G, nsets);
  if (dtype == 1) {
    err = cudaFuncSetAttribute(selective_scan_bwd_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    selective_scan_bwd_kernel<__nv_bfloat16><<<grid, NTHREADS, smem, s>>>(p);
  } else if (dtype == 0) {
    err = cudaFuncSetAttribute(selective_scan_bwd_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    selective_scan_bwd_kernel<float><<<grid, NTHREADS, smem, s>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `set` is the direction's Dir as
// DIR_WORDS 64-bit words (its carries word points at the forward's fp32
// carries; y and hN are not read). g_BC, shares and tickets are scratch of
// the launcher's making: (2, G, L, N) fp32, (G, d N + 2 d) fp32, (d tiles,)
// uint32; g_BC and tickets are zeroed here. Returns the cudaError_t.
extern "C" int selective_scan_bwd(int dtype, const long long* set, const void* g_y,
                                  const void* g_hN, void* g_u, void* g_delta, void* g_BC,
                                  void* g_h0, void* shares, void* tickets, void* g_A, void* g_D,
                                  void* g_bias, int G, int L, int d, int N, int dt_softplus,
                                  void* stream) {
  Params p;
  std::memset(&p, 0, sizeof(p));
  std::memcpy(&p.q[0], set, sizeof(Dir));
  Out& o = p.o[0];
  o.g_y = g_y;
  o.g_hN = static_cast<const float*>(g_hN);
  o.g_u = g_u;
  o.g_delta = g_delta;
  o.g_BC = static_cast<float*>(g_BC);
  o.g_h0 = static_cast<float*>(g_h0);
  o.shares = static_cast<float*>(shares);
  o.tickets = static_cast<unsigned int*>(tickets);
  o.g_A = static_cast<float*>(g_A);
  o.g_D = static_cast<float*>(g_D);
  o.g_bias = static_cast<float*>(g_bias);
  p.G = G; p.L = L; p.d = d; p.N = N; p.dt_softplus = dt_softplus;
  return (int)launch(dtype, p, 1, static_cast<cudaStream_t>(stream));
}

// Both directions' adjoints in one launch: `sets` is 2 x DIR_WORDS words
// (set 1 walked as scanned left to right, set 2 right to left: their
// `reverse` words are overwritten to say so), `outs` 2 x OUT_WORDS words,
// each set's `Out` (g_hN and g_h0 null: the pair scans from zero states).
// Scratch and return value as `selective_scan_bwd`.
extern "C" int bidir_scan_bwd(int dtype, const long long* sets, const long long* outs, int G,
                              int L, int d, int N, int dt_softplus, void* stream) {
  Params p;
  std::memset(&p, 0, sizeof(p));
  std::memcpy(p.q, sets, 2 * sizeof(Dir));
  std::memcpy(p.o, outs, 2 * sizeof(Out));
  p.q[0].reverse = 0;
  p.q[1].reverse = 1;
  p.G = G; p.L = L; p.d = d; p.N = N; p.dt_softplus = dt_softplus;
  return (int)launch(dtype, p, 2, static_cast<cudaStream_t>(stream));
}
