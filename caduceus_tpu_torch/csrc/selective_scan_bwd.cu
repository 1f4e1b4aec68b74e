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
//   -- entry point `bidir_scan_bwd`, the same kernels over a third grid
//   dimension. Each set has its own outputs and scratch, so the two
//   directions' sums never meet.
// Plain version: caduceus_tpu_torch/ops/selective_scan.py
// `selective_scan_bwd` (the decomposition below: `selective_scan_runs_bwd`);
// Python wrappers: caduceus_tpu_torch/ops/scan.py.
//
// Per chunk, walked against the scan order from the forward's carries
// (`scan_pallas.py:26-36`), per channel c and state n:
//   recompute  h[t] = dA[t] h[t-1] + delta u B            from the chunk's carry
//   adjoint    li[t] = lam + C[t] g_y[t];  lam = dA[t] li[t]   (scan-backward)
//              g_C[t,n]  = sum_c g_y h[t]        g_B[t,n] = sum_c li delta u
//              g_du[t,c] = sum_n li B            g_dd[t,c] = sum_n li dA A h[t-1]
//              g_A[c,n] += li dA h[t-1] delta
//   epilogue   g_delta = (g_dd + u g_du) (1 - exp(-delta))   (softplus chain)
//              g_u = D g_y + delta g_du;  g_D += g_y u;  g_bias += g_delta
// After the scan's first chunk, lam is d loss / d h_init.
//
// Design: the forward's layout (scan_common.cuh), a warp per (g, set,
// channel) and a run of R = 8 rows per lane in chunks of CH = 256 rows (the
// carry spacing). Per chunk and state n a thread computes its run's dA once
// and keeps it in registers for the three walks that need it: the
// recompute of h (run aggregate, warp scan up from the chunk's carry,
// re-walk), and the adjoint (run aggregate of lam, warp scan down from the
// later chunk's lam, re-walk). g_du and g_dd (sums over n) stay in
// registers; g_A's share goes through a warp sum into lane n.
// - g_B and g_C are sums over all d channels, so they cross warps, blocks
//   and clusters, each in a fixed order: per state n the 8 warps' terms meet
//   in shared memory and one thread per row adds them in warp order into
//   the block's chunk tile; at the chunk's end the blocks of a thread-block
//   cluster add their tiles in rank order through distributed shared
//   memory, each block a slice of the rows, into one fp32 share per
//   cluster; `bc_share_sum_kernel` adds the shares in cluster order and
//   writes g_B, g_C in the storage dtype. No float atomics: every output
//   repeats bit for bit from run to run. The wrapper picks clusters of 2
//   blocks (16 channels): (G, L, 2 N) x 32 shares = 2.15 GB at G = 4,
//   L = 131072, d = 512. Clusters of 8 (0.54 GB) co-schedule worse at two
//   113 KB blocks per SM: 24.94 ms against 16.50 (`phase_cutouts.py`,
//   H100 80GB HBM3).
// - Sums over G L rows (g_A (d, N), g_D, g_bias): each block writes its row
//   g's share; the last block of a tile to finish (an integer ticket) adds
//   the G shares in the order g = 0, 1, ...
// - Loads in flight: the next chunk's u, delta, g_y, B and C are 16-byte
//   cp.async copies issued once this chunk's are consumed, and the next
//   chunk's carry is loaded a chunk ahead.
// - Rows >= L are identity steps (zero delta, u, B, C, g_y): lam passes them
//   unchanged and they are masked out of every store and sum.
//
// Bound on the card, per launch and direction: it reads u, delta, g_y
// (3 x 1024 B/row in bf16 at d = 512), B, C (64 B) and the carries, and
// writes g_u, g_delta (2 x 1024 B) and g_B, g_C (64 B); ~20 FLOP per (row,
// channel, n) and one exp. The fp32 g_B / g_C shares stand beside it.

#include <cooperative_groups.h>

#include <cstring>

#include "scan_common.cuh"

using namespace scan;
namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 8;
constexpr int PART_MAIN = 1, PART_SUM = 2;

// One set's cotangents, outputs and scratch.
struct Out {
  const void* g_y;          // (G, L, d) storage dtype, contiguous
  const float* g_hN;        // (G, d, N) or null
  void* g_u;                // (G, L, d) storage dtype
  void* g_delta;            // (G, L, d) storage dtype
  void* g_B;                // (G, L, N) storage dtype
  void* g_C;                // (G, L, N) storage dtype
  float* g_h0;              // (G, d, N) or null
  float* bc_shares;         // (nsh, 2, G, N, L): per-cluster g_B / g_C sums
  float* shares;            // (G, d N + 2 d): per-row g shares of g_A, g_D, g_bias
  unsigned int* tickets;    // (d tiles,), zeroed by the launcher
  float* g_A;               // (d, N)
  float* g_D;               // (d,)
  float* g_bias;            // (d,)
};
constexpr int OUT_WORDS = sizeof(Out) / sizeof(long long);
static_assert(sizeof(Out) == OUT_WORDS * sizeof(long long), "Out is a row of 64-bit words");

struct Params {
  Dir q[2];                 // y / hN / z unused; carries read
  Out o[2];
  int G, L, d, N, dt_softplus, nsh;
};

// B and C are transposed into tiles of the storage type (bf16 keeps the
// block inside the 113 KB that two blocks per SM leave).
template <typename S>
struct Smem {
  unsigned char *u, *dl, *gy, *B, *C;
  S *Bt, *Ct;
  float* T;    // (2 buffers, 2, WARPS, CH): the warps' g_B / g_C terms of a state
  float* Sb;   // (2, N, CH): the block's g_B / g_C sums of the chunk
  static size_t bytes(int N) {
    return 3 * (size_t)staged_bytes<S>(WARPS) + 2 * (size_t)staged_bytes<S>(N) +
           2 * (size_t)trans_bytes<S>(N) + sizeof(float) * (4 * WARPS * CH + 2 * (size_t)N * CH);
  }
  __device__ Smem(unsigned char* p, int N) {
    const int cb = staged_bytes<S>(WARPS);
    u = p; p += cb;
    dl = p; p += cb;
    gy = p; p += cb;
    B = p; p += staged_bytes<S>(N);
    C = p; p += staged_bytes<S>(N);
    Bt = reinterpret_cast<S*>(p); p += trans_bytes<S>(N);
    Ct = reinterpret_cast<S*>(p); p += trans_bytes<S>(N);
    T = reinterpret_cast<float*>(p); p += sizeof(float) * 4 * WARPS * CH;
    Sb = reinterpret_cast<float*>(p);
  }
};

template <typename S>
__device__ __forceinline__ void stage_chunk(const Smem<S>& sm, const Dir& q, const S* gy,
                                            int g, long long row0, int L, int c0, int d, int N,
                                            const bool (&vec)[5]) {
  stage<S>(sm.u, static_cast<const S*>(q.u) + g * q.u_sg, q.u_sl, row0, L, c0, WARPS, d, vec[0]);
  stage<S>(sm.dl, static_cast<const S*>(q.delta) + g * q.d_sg, q.d_sl, row0, L, c0, WARPS, d,
           vec[1]);
  stage<S>(sm.gy, gy, (long long)d, row0, L, c0, WARPS, d, vec[4]);
  stage<S>(sm.B, static_cast<const S*>(q.B) + g * q.b_sg, q.b_sl, row0, L, 0, N, N, vec[2]);
  stage<S>(sm.C, static_cast<const S*>(q.C) + g * q.c_sg, q.c_sl, row0, L, 0, N, N, vec[3]);
  cp_async_commit();
}

// A thread's R values (array order) into a staged (t, WARPS) tile's column
// w, then the tile's rows < L to global memory, one 16-byte piece a step.
template <typename S>
__device__ __forceinline__ void put(unsigned char* tile, int run, int w, const float (&x)[R]) {
#pragma unroll
  for (int a = 0; a < R; ++a) staged_row<S>(tile, WARPS, run * R + a)[w] = from_f<S>(x[a]);
}
template <typename S>
__device__ __forceinline__ void store_tile(const unsigned char* tile, S* dst, long long row0,
                                           int L, int c0, int d, bool vec) {
  if (vec) {
    constexpr int ppr = WARPS * (int)sizeof(S) / 16;
    for (int i = threadIdx.x; i < CH * ppr; i += NTHREADS) {
      const int t = i / ppr, k = i % ppr;
      if (row0 + t < L)
        reinterpret_cast<uint4*>(dst + (row0 + t) * d + c0)[k] =
            reinterpret_cast<const uint4*>(staged_row<S>(tile, WARPS, t))[k];
    }
  } else {
    for (int i = threadIdx.x; i < CH * WARPS; i += NTHREADS) {
      const int t = i / WARPS, e = i % WARPS;
      if (row0 + t < L && c0 + e < d)
        dst[(row0 + t) * d + c0 + e] = staged_row<S>(tile, WARPS, t)[e];
    }
  }
}

template <typename S, bool REV, int N>
__device__ void adjoint(const Params& p, const Dir& q, const Out& o, unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int d = p.d, L = p.L, G = p.G;
  Smem<S> sm(smem, N);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, tid = threadIdx.x;
  const int c0 = blockIdx.x * WARPS, ch = c0 + w, g = blockIdx.y;
  const bool valid = ch < d;
  const int run = REV ? RUNS - 1 - lane : lane;
  const long long sidx = ((long long)g * d + ch) * N + lane;
  const bool ln = valid && lane < N;
  // lane n keeps state n's A, carry, lam and g_A
  const float An = ln ? q.A[ch * N + lane] : 0.f;
  float lam = (ln && o.g_hN) ? o.g_hN[sidx] : 0.f;
  float gA = 0.f, gDp = 0.f, gbp = 0.f;
  const float bias = (valid && q.bias) ? q.bias[ch] : 0.f;
  const float Dc = (valid && q.D) ? q.D[ch] : 0.f;
  const S* gy_g = static_cast<const S*>(o.g_y) + (long long)g * L * d;
  S* gu_g = static_cast<S*>(o.g_u) + (long long)g * L * d;
  S* gd_g = static_cast<S*>(o.g_delta) + (long long)g * L * d;
  const int nc = (L + CH - 1) / CH;
  const bool vec[5] = {
      vec_ok(static_cast<const S*>(q.u) + g * q.u_sg, q.u_sl, c0, WARPS, d),
      vec_ok(static_cast<const S*>(q.delta) + g * q.d_sg, q.d_sl, c0, WARPS, d),
      vec_ok(static_cast<const S*>(q.B) + g * q.b_sg, q.b_sl, 0, N, N),
      vec_ok(static_cast<const S*>(q.C) + g * q.c_sg, q.c_sl, 0, N, N),
      vec_ok(gy_g, (long long)d, c0, WARPS, d)};
  const bool vec_out = vec_ok(static_cast<const S*>(gu_g), (long long)d, c0, WARPS, d);
  const int CL = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  float* bc_share = o.bc_shares + (long long)(blockIdx.x / CL) * 2 * G * N * L;
  auto carry = [&](int chunk) {
    return ln ? q.carries[(((long long)g * nc + chunk) * d + ch) * N + lane] : 0.f;
  };

  // scan-backward order: the scan's last chunk first
  int chunk = REV ? 0 : nc - 1;
  stage_chunk<S>(sm, q, gy_g, g, (long long)chunk * CH, L, c0, d, N, vec);
  float hc = carry(chunk);
  for (int ci = 0; ci < nc; ++ci) {
    chunk = REV ? ci : nc - 1 - ci;
    const long long row0 = (long long)chunk * CH;
    cp_async_wait_all();
    __syncthreads();
    transpose_bc<S, S>(sm.B, sm.Bt, N);
    transpose_bc<S, S>(sm.C, sm.Ct, N);
    float uu[R], dd[R], du[R], gy[R], gdu[R], gdd[R];
    {
      float dr[R];
      load_channel<S>(sm.u, run, w, uu);
      load_channel<S>(sm.dl, run, w, dr);
      load_channel<S>(sm.gy, run, w, gy);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        float x = 0.f;
        if (row0 + run * R + a < L && valid) {
          x = dr[a] + bias;
          if (p.dt_softplus) x = softplus(x);
        }
        dd[a] = x;
        du[a] = x * uu[a];
        gdu[a] = gdd[a] = 0.f;
      }
    }
    __syncthreads();  // the tiles are transposed; the staging is free
    float hc_next = 0.f;
    if (ci + 1 < nc) {
      const int next = REV ? chunk + 1 : chunk - 1;
      stage_chunk<S>(sm, q, gy_g, g, (long long)next * CH, L, c0, d, N, vec);
      hc_next = carry(next);
    }

    for (int n = 0; n < N; ++n) {
      const float A = __shfl_sync(FULL, An, n), A2 = A * LOG2E;
      const float h_in = __shfl_sync(FULL, hc, n);
      const float l_in = __shfl_sync(FULL, lam, n);
      float b[R], c[R], dA[R], hp[R];
      load_run<S>(sm.Bt, n, run, b);
      // recompute: the run's aggregate, the warp scan from the chunk's carry
      float P = 1.f, H = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int a = REV ? R - 1 - i : i;
        dA[i] = ex2(dd[a] * A2);
        H = fmaf(dA[i], H, du[a] * b[a]);
        P *= dA[i];
      }
      const float Prun = P;
      scan_up(P, H, lane);
      {
        const float Pe = __shfl_up_sync(FULL, P, 1), He = __shfl_up_sync(FULL, H, 1);
        H = lane == 0 ? h_in : fmaf(Pe, h_in, He);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {  // hp[i]: the state before step i
        const int a = REV ? R - 1 - i : i;
        hp[i] = H;
        H = fmaf(dA[i], H, du[a] * b[a]);
      }
      // the adjoint: lam's run aggregate lam -> Prun lam + K over the run
      // walked backwards, the warp scan down from the later chunk's lam
      load_run<S>(sm.Ct, n, run, c);
      float K = 0.f;
#pragma unroll
      for (int i = R - 1; i >= 0; --i) {
        const int a = REV ? R - 1 - i : i;
        K = dA[i] * fmaf(c[a], gy[a], K);
      }
      P = Prun;
      scan_down(P, K, lane);
      float l;
      {
        const float Pn = __shfl_down_sync(FULL, P, 1), Kn = __shfl_down_sync(FULL, K, 1);
        l = lane == 31 ? l_in : fmaf(Pn, l_in, Kn);
      }
      if (SCAN_DROP == 1 && lane == DROP_LANE) l = 0.f;
      const float l_out = __shfl_sync(FULL, fmaf(P, l_in, K), 0);
      if (lane == n) lam = l_out;
      // g_B / g_C terms of this state go to the T buffer 4 rows at a time,
      // as the walk completes them
      float* Tb = sm.T + (n & 1) * 2 * WARPS * CH;
      float4* tb = reinterpret_cast<float4*>(Tb + w * CH + run * R);
      float4* tc = reinterpret_cast<float4*>(Tb + (WARPS + w) * CH + run * R);
      float ga = 0.f, tB[R], tC[R];
#pragma unroll
      for (int i = R - 1; i >= 0; --i) {
        const int a = REV ? R - 1 - i : i;
        const float li = fmaf(c[a], gy[a], l);
        const float wv = li * dA[i] * hp[i];
        ga = fmaf(wv, dd[a], ga);
        gdd[a] = fmaf(wv, A, gdd[a]);
        gdu[a] = fmaf(li, b[a], gdu[a]);
        tB[a] = li * du[a];
        tC[a] = gy[a] * (i == R - 1 ? H : hp[i + 1]);
        l = dA[i] * li;
        if (a % 4 == (REV ? 3 : 0)) {
          const int k = a / 4;
          tb[k] = make_float4(tB[4 * k], tB[4 * k + 1], tB[4 * k + 2], tB[4 * k + 3]);
          tc[k] = make_float4(tC[4 * k], tC[4 * k + 1], tC[4 * k + 2], tC[4 * k + 3]);
        }
      }
      __syncthreads();
      // g_A's share of this state (the warp's sum), while the terms meet
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ga += __shfl_xor_sync(FULL, ga, off);
      if (lane == n) gA += ga;
      // g_B / g_C: the 8 warps' terms of this state, added in warp order
      {
        float sB = 0.f, sC = 0.f;
#pragma unroll
        for (int k = 0; k < WARPS; ++k) {
          sB += Tb[k * CH + tid];
          sC += Tb[(WARPS + k) * CH + tid];
        }
        sm.Sb[n * CH + tid] = sB;
        sm.Sb[(N + n) * CH + tid] = sC;
      }
    }

    // the epilogue per (row, channel), then g_u and g_delta through staged
    // tiles in the T buffers
    float gu[R], gdl[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      float x = fmaf(uu[a], gdu[a], gdd[a]);
      if (p.dt_softplus) x *= 1.f - expf(-dd[a]);
      gdl[a] = x;
      gu[a] = fmaf(Dc, gy[a], dd[a] * gdu[a]);
      if (row0 + run * R + a < L && valid) {
        gDp = fmaf(gy[a], uu[a], gDp);
        gbp += x;
      }
    }
    unsigned char* tu = reinterpret_cast<unsigned char*>(sm.T);
    unsigned char* td = tu + staged_bytes<S>(WARPS);
    __syncthreads();  // every warp's last T reads are done
    put<S>(tu, run, w, gu);
    put<S>(td, run, w, gdl);
    __syncthreads();
    store_tile<S>(tu, gu_g, row0, L, c0, d, vec_out);
    store_tile<S>(td, gd_g, row0, L, c0, d, vec_out);

    // the cluster's tiles, added in rank order; this block takes a slice
    cluster.sync();
    {
      const int V = 2 * N * CH, per = V / CL;
      for (int v = rank * per + tid; v < (rank + 1) * per; v += NTHREADS) {
        const int t = v % CH, qn = v / CH;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < MAX_CLUSTER; ++k)
          if (k < CL) s += cluster.map_shared_rank(sm.Sb, k)[v];
        // v = (q N + n) CH + t -> share (q, g, n, row)
        if (row0 + t < L)
          bc_share[(((long long)(qn / N) * G + g) * N + qn % N) * L + row0 + t] = s;
      }
    }
    cluster.sync();  // the slices are read; the next chunk may write Sb
    hc = hc_next;
  }

  // this row g's shares, then the tile's last block adds them in g order
  const long long W = (long long)d * N + 2 * d;
  float* share = o.shares + g * W;
  if (ln) {
    if (o.g_h0) o.g_h0[sidx] = lam;
    share[ch * N + lane] = gA;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    gDp += __shfl_xor_sync(FULL, gDp, off);
    gbp += __shfl_xor_sync(FULL, gbp, off);
  }
  if (valid && lane == 0) {
    share[(long long)d * N + ch] = gDp;
    share[(long long)d * N + d + ch] = gbp;
  }
  __threadfence();  // every thread's shares are visible before the ticket
  __syncthreads();
  __shared__ bool last;
  if (tid == 0) last = atomicAdd(&o.tickets[blockIdx.x], 1u) == (unsigned)(G - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (ln) {
    float s = 0.f;
    for (int gg = 0; gg < G; ++gg) s += __ldcg(o.shares + gg * W + ch * N + lane);
    o.g_A[ch * N + lane] = s;
  }
  if (tid < 2 * WARPS) {
    const int j = tid / WARPS, cc = c0 + tid % WARPS;
    if (cc < d) {
      float s = 0.f;
      for (int gg = 0; gg < G; ++gg)
        s += __ldcg(o.shares + gg * W + (long long)d * N + j * d + cc);
      (j == 0 ? o.g_D : o.g_bias)[cc] = s;
    }
  }
}

template <typename S, int N>
__global__ void __launch_bounds__(NTHREADS, 2) selective_scan_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dir& q = p.q[blockIdx.z];
  const Out& o = p.o[blockIdx.z];
  if (q.reverse)
    adjoint<S, true, N>(p, q, o, smem);
  else
    adjoint<S, false, N>(p, q, o, smem);
}

// g_B and g_C: the clusters' shares added in cluster order, written in the
// storage dtype. Block (row tile of 64, g, set x {B, C}); a thread adds 4
// rows of one state at a time (16-byte loads when L % 4 == 0). SCAN_DROP 2
// leaves out share 1 of g_B (a planted fault the checks must catch).
constexpr int SUM_ROWS = 64;
template <typename S>
__global__ void __launch_bounds__(NTHREADS) bc_share_sum_kernel(const Params p) {
  __shared__ float tile[SUM_ROWS * 33];
  const int N = p.N, L = p.L, G = p.G, g = blockIdx.y;
  const int set = blockIdx.z / 2, qq = blockIdx.z % 2;
  const Out& o = p.o[set];
  const long long r0 = (long long)blockIdx.x * SUM_ROWS;
  const long long stride = 2LL * G * N * L;  // from one share to the next
  const bool vec = L % 4 == 0;
  for (int i = threadIdx.x; i < N * SUM_ROWS / 4; i += NTHREADS) {
    const int n = i / (SUM_ROWS / 4), t = (i % (SUM_ROWS / 4)) * 4;
    const float* src = o.bc_shares + (((long long)qq * G + g) * N + n) * L + r0 + t;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (vec && r0 + t < L) {
#pragma unroll 4
      for (int k = 0; k < p.nsh; ++k) {
        if (SCAN_DROP == 2 && qq == 0 && k == 1) continue;
        const float4 v = __ldcs(reinterpret_cast<const float4*>(src + k * stride));
        s[0] += v.x; s[1] += v.y; s[2] += v.z; s[3] += v.w;
      }
    } else if (!vec) {
      for (int k = 0; k < p.nsh; ++k) {
        if (SCAN_DROP == 2 && qq == 0 && k == 1) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (r0 + t + e < L) s[e] += src[k * stride + e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) tile[(t + e) * 33 + n] = s[e];
  }
  __syncthreads();
  S* out = static_cast<S*>(qq == 0 ? o.g_B : o.g_C) + ((long long)g * L + r0) * N;
  for (int i = threadIdx.x; i < N * SUM_ROWS; i += NTHREADS) {
    const int t = i / N, n = i % N;
    if (r0 + t < L) out[(long long)t * N + n] = from_f<S>(tile[t * 33 + n]);
  }
}

template <typename S, int N>
cudaError_t launch_n(const Params& p, int nsets, int parts, cudaStream_t s) {
  const int tiles = (p.d + WARPS - 1) / WARPS;
  cudaError_t err;
  if (parts & PART_MAIN) {
    for (int k = 0; k < nsets; ++k) {
      err = cudaMemsetAsync(p.o[k].tickets, 0, sizeof(unsigned int) * tiles, s);
      if (err != cudaSuccess) return err;
    }
    const size_t smem = Smem<S>::bytes(N);
    err = cudaFuncSetAttribute(selective_scan_bwd_kernel<S, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles, p.G, nsets);
    cfg.blockDim = dim3(NTHREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = tiles / p.nsh;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, selective_scan_bwd_kernel<S, N>, p);
    if (err != cudaSuccess) return err;
  }
  if (parts & PART_SUM) {
    dim3 grid((p.L + SUM_ROWS - 1) / SUM_ROWS, p.G, 2 * nsets);
    bc_share_sum_kernel<S><<<grid, NTHREADS, 0, s>>>(p);
  }
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_t(const Params& p, int nsets, int parts, cudaStream_t s) {
  if (p.N == 8) return launch_n<S, 8>(p, nsets, parts, s);
  if (p.N == 16) return launch_n<S, 16>(p, nsets, parts, s);
  return launch_n<S, 32>(p, nsets, parts, s);
}

// Check the shape and the cluster split, then launch over `nsets` sets.
cudaError_t launch(int dtype, Params& p, int nsets, int parts, cudaStream_t s) {
  const int G = p.G, L = p.L, d = p.d, N = p.N;
  if (!valid_n(N) || G <= 0 || L <= 0 || d <= 0 || nsets < 1 || nsets > 2 || p.nsh < 1)
    return cudaErrorInvalidValue;
  const int tiles = (d + WARPS - 1) / WARPS;
  const int CL = tiles / p.nsh;
  if (tiles % p.nsh != 0 || CL > MAX_CLUSTER || (CL & (CL - 1)) != 0)
    return cudaErrorInvalidValue;
  for (int k = 0; k < nsets; ++k)
    if (!p.q[k].carries) return cudaErrorInvalidValue;
  if (dtype == 1) return launch_t<__nv_bfloat16>(p, nsets, parts, s);
  if (dtype == 0) return launch_t<float>(p, nsets, parts, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `set` is the direction's Dir as
// DIR_WORDS 64-bit words (its carries word points at the forward's fp32
// carries; y, hN and z are not read), `out` its Out as OUT_WORDS words (the
// scratch of the caller's making: bc_shares (nsh, 2, G, N, L) fp32, shares
// (G, d N + 2 d) fp32, tickets (d / 8 tiles,) uint32, zeroed here). `nsh`:
// the number of clusters along d, dividing the d / 8 tiles into clusters of
// 1, 2, 4 or 8 blocks. `parts`: 1 the main pass, 2 the g_B / g_C share sum
// (3 both; the sum alone reads the shares of an earlier main pass). Returns
// the cudaError_t.
extern "C" int selective_scan_bwd(int dtype, const long long* set, const long long* out,
                                  int G, int L, int d, int N, int dt_softplus, int nsh,
                                  int parts, void* stream) {
  Params p;
  std::memset(&p, 0, sizeof(p));
  std::memcpy(&p.q[0], set, sizeof(Dir));
  std::memcpy(&p.o[0], out, sizeof(Out));
  p.G = G; p.L = L; p.d = d; p.N = N; p.dt_softplus = dt_softplus; p.nsh = nsh;
  return (int)launch(dtype, p, 1, parts, static_cast<cudaStream_t>(stream));
}

// Both directions' adjoints in one launch of each kernel: `sets` is 2 x
// DIR_WORDS words (set 1 walked as scanned left to right, set 2 right to
// left: their `reverse` words are overwritten to say so), `outs` 2 x
// OUT_WORDS words, each set's `Out` (g_hN and g_h0 null: the pair scans from
// zero states). The rest as `selective_scan_bwd`.
extern "C" int bidir_scan_bwd(int dtype, const long long* sets, const long long* outs, int G,
                              int L, int d, int N, int dt_softplus, int nsh, int parts,
                              void* stream) {
  Params p;
  std::memset(&p, 0, sizeof(p));
  std::memcpy(p.q, sets, 2 * sizeof(Dir));
  std::memcpy(p.o, outs, 2 * sizeof(Out));
  p.q[0].reverse = 0;
  p.q[1].reverse = 1;
  p.G = G; p.L = L; p.d = d; p.N = N; p.dt_softplus = dt_softplus; p.nsh = nsh;
  return (int)launch(dtype, p, 2, parts, static_cast<cudaStream_t>(stream));
}
