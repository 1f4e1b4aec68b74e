// ssd_fused_bwd: adjoint of the SSD (Mamba-2) forward for Hopper (sm_90a).
// Two __global__ kernels:
//
//   ssd_fused_bwd_kernel  the chunked SSD adjoint, one block per (g, h),
//                         templated on the conv width K like the forward
//   ssd_conv_bwd_kernel   the SiLU and depthwise-conv adjoints over all rows
//
// - K >= 1, entry `ssd_fused_bwd`, then `ssd_conv_bwd`: together they
//   replace the TPU kernel `_bwd_kernel(fused=True)` of
//   caduceus_tpu/ops/ssd_pallas_batched.py (launched by
//   `ssd_pallas_batched_fused_bwd_impl`, TPU kernel #3), without its
//   context-parallel `emit_pend` output. Plain version:
//   caduceus_tpu_torch/ops/ssd.py `ssd_chunked_fused_bwd`; wrapper:
//   caduceus_tpu_torch/ops/ssd_batched.py `ssd_fused_bwd`.
// - K = 0, entry `ssd_bwd`: the adjoint of the unfused forward `ssd_fwd` on
//   post-conv x, B and C, read through their own batch and row strides
//   (the per-head model path passes column views of one conv output). It
//   replaces two TPU kernels that compute one function in two VMEM layouts:
//   `_bwd_kernel` of caduceus_tpu/ops/ssd_pallas.py (launched by
//   `ssd_pallas_bwd_impl`, TPU kernel #6, state (H*N, P)) and
//   `_bwd_kernel(fused=False)` of ops/ssd_pallas_batched.py (launched by
//   `ssd_pallas_batched_bwd_impl`, #4, state (N, H*P)). It writes g_x in x's
//   dtype and g_B / g_C as fp32 sums over the heads of a group; no conv
//   adjoint follows (on that path the conv is a PyTorch op outside the
//   kernel, as it is an XLA op outside every Pallas kernel in JAX). Plain
//   version: ops/ssd.py `ssd_chunked_bwd`; wrappers: ops/ssd_batched.py
//   `ssd_bwd` (#4) and ops/ssd_head.py `ssd_head_bwd` (#6).
//
// ssd_fused_bwd_kernel walks the chunks of its head against the scan order
// from the saved chunk-entry states (the forward kernel's carries), with
// lambda = d loss / d (state leaving the chunk), g_hN at the scan's end.
// Per chunk, recomputing dt, cum and silu(conv) with the forward's own code
// (ssd_common.cuh), with G_ts = g_y_t . dx_s and LG = Lm * G:
//   g_dx  = (CB * Lm)^T @ g_y + w * (B @ lambda)
//   g_C  += LG @ B + (exp(cum) * g_y) @ h_in^T       (atomics over heads)
//   g_B  += LG^T @ C + (w * dx) @ lambda^T           (atomics over heads)
//   g_cum = rowsum(LG*CB) - colsum(LG*CB) + exp(cum) sum_p g_y (C @ h_in)
//           - w sum_p dx (B @ lambda) + [t = last] sum lambda h_out
//   g_a   = suffix sum of g_cum in scan order (fp32 warp scan)
//   g_dt  = (A g_a + sum_p x g_dx) * (1 - exp(-dt))   (softplus chain)
//   g_x   = dt g_dx + D g_y
//   lambda <- exp(sum a) lambda + C^T @ (exp(cum) * g_y)
// It writes g_x and accumulates g_B / g_C into an fp32 (G, L, Wc) workspace
// of d loss / d silu(pre) (K = 0: g_x in x's dtype and g_B / g_C into an fp32
// (2, G, L, NG*N) output), writes g_dt, g_h0 = the last lambda, and adds its
// g_A, g_dt_bias and g_D shares with atomics. ssd_conv_bwd_kernel then
// recomputes pre = conv(xBC), takes g_pre = g_xc * silu'(pre) and the conv
// transpose g_xBC[j] = sum_k w[k] g_pre[j + dir (K-1-k)] over the whole array
// (so the TPU kernel's chunk-to-chunk `pend` spillover is not needed), and
// the g_conv_w / g_conv_b sums.
//
// Precision: the forward's policy. Matmul operands are rounded to the storage
// dtype (bf16 WMMA with fp32 accumulation; fp32 FMA loops, no TF32); cumsums,
// decays, lambda, every reduction and the workspace are fp32. Each head
// rounds its own LG (the TPU kernel rounds the group's sum of LG): the plain
// version does the same. Rows >= L are identity steps (dt = 0, x = B = C = 0)
// and contribute exactly 0 to every output.
//
// Why two kernels: g_B / g_C are shared by the rep = H / NG heads of a group
// (all 8 at ngroups 1), and the (N, H*P) lambda of all heads (256 KB fp32)
// does not fit one block's 227 KB, so the heads' shares meet in device
// memory (atomicAdd), and the conv adjoint can only start once every head
// has added its share.
//
// Bound on the card: bytes. Per row at the main geometry (bf16, T = 64) the
// first kernel reads xBC (1536 B), dt (16), g_y (1024) and the carries
// (2048) and writes the workspace (3072 B fp32) and g_dt (16); the second
// reads xBC and the workspace and writes g_xBC (1536). Matmul work is
// ~1 MFLOP/row, a third of the bytes' time at 989 TF/s vs 3.35 TB/s. The
// unfused form (K = 0) reads x (1024 B), B and C (512), dt, g_y and the
// carries and writes g_x (1024), g_dt and the fp32 g_B / g_C (1024). Known
// costs of this first version: G*H blocks walk their chunks in sequence
// (32 of 132 SMs at G = 4); every head recomputes the B/C conv and CB; the
// g_B / g_C atomics (rep adds per element); the fp32 workspace round trip.

#include "ssd_common.cuh"

using namespace ssd;

namespace {

constexpr int CONV_THREADS = 256;  // conv adjoint: one column per thread
constexpr int CONV_ROWS = 256;     // rows per conv-adjoint block

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block, returned to every thread. `red` holds NWARPS floats.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < NWARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

struct Params {
  const void* xBC;          // K >= 1: (G, L, Wc) storage dtype, unit column stride
  long long xbc_sg, xbc_sl;
  const void* x;            // K = 0: (G, L, H*P), unit column stride
  long long x_sg, x_sl;
  const void* B;            // K = 0: (G, L, NG*N), unit column stride
  long long b_sg, b_sl;
  const void* C;            // K = 0: (G, L, NG*N), unit column stride
  long long c_sg, c_sl;
  const void* dt;           // (G, L, H) storage dtype, unit column stride
  long long dt_sg, dt_sl;
  const float* A;           // (H,)
  const float* D;           // (H,) or null
  const float* dt_bias;     // (H,) or null
  const float* conv_w;      // (K, Wc); null when K = 0
  const float* conv_b;      // (Wc,) or null
  const void* g_y;          // (G, L, H, P) storage dtype, contiguous
  const void* carries;      // (G, nc, H, N, P) storage dtype
  const float* g_hN;        // (G, H, N, P) or null
  float* g_xc;              // K >= 1: (G, L, Wc) fp32 workspace (B/C columns zeroed)
  void* g_x;                // K = 0: (G, L, H*P) storage dtype, contiguous
  float* g_BC;              // K = 0: (2, G, L, NG*N) fp32 [g_B, g_C], zeroed
  void* g_dt;               // (G, L, H) storage dtype, contiguous
  float* g_h0;              // (G, H, N, P)
  float* g_heads;           // [g_A (H), g_dt_bias (H), g_D (H)], zeroed
  int L, H, P, NG, N, Wc;
  int dt_softplus, reverse;
};

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// Shared memory carve-up; the host computes the same total (~215 KB in bf16
// at T=64, N=128, P=64; ~136 KB in fp32 at T=32). Lifetimes within a chunk
// let three regions be reused: CBf/Gf (phases B-C) then MS/LGS (C-D);
// Ch (B-C) then gdx (D-E); dxS (B) then the per-warp WMMA stage (D).
template <typename S>
struct Smem {
  static constexpr int T = Chunk<S>::T;
  static constexpr int PAD_S = sizeof(S) == 2 ? 8 : 4;
  static constexpr bool F32 = std::is_same<S, float>::value;
  float* lam; S* lamS; S* Bs; S* Cs; float* xf; S* gyS; S* wdxS; S* geS;
  float* CBf; float* Gf; S* MS; S* LGS; float* Blam; float* ChD; S* dxS; float* stage;
  float* dtv; float* cum; float* rowcol; float* qs; float* us; float* r3; float* gcum;
  float* red;
  int ldl, ldlS, ldN, ldPS, ldTf, ldTS, ldPf;

  static __host__ __device__ size_t region_r1() { return 2 * align128((size_t)T * (T + 4) * 4); }
  static __host__ __device__ size_t region_scratch(int P) {
    const size_t dx = (size_t)T * (P + PAD_S) * sizeof(S);
    const size_t st = F32 ? 0 : (size_t)NWARPS * 256 * 4;
    return align128(dx > st ? dx : st);
  }
  static __host__ __device__ size_t bytes(int P, int N) {
    size_t b = align128((size_t)N * (P + 4) * 4);                          // lam
    if (!F32) b += align128((size_t)N * (P + PAD_S) * sizeof(S));          // lamS
    b += 2 * align128((size_t)T * (N + PAD_S) * sizeof(S));                // Bs, Cs
    b += align128((size_t)T * P * 4);                                      // xf
    b += 3 * align128((size_t)T * (P + PAD_S) * sizeof(S));                // gyS, wdxS, geS
    b += region_r1();                                                      // CBf|Gf, MS|LGS
    b += 2 * align128((size_t)T * (P + 4) * 4);                            // Blam, ChD
    b += region_scratch(P);                                                // dxS | stage
    b += align128((size_t)(7 * T + NWARPS) * 4);                           // small
    return b;
  }

  __device__ Smem(unsigned char* base, int P, int N)
      : ldl(P + 4), ldlS(F32 ? P + 4 : P + PAD_S), ldN(N + PAD_S), ldPS(P + PAD_S),
        ldTf(T + 4), ldTS(T + PAD_S), ldPf(P + 4) {
    unsigned char* p = base;
    auto take = [&](size_t n) { unsigned char* r = p; p += align128(n); return r; };
    lam = reinterpret_cast<float*>(take((size_t)N * ldl * 4));
    lamS = F32 ? reinterpret_cast<S*>(lam)  // fp32 operands need no rounded copy
               : reinterpret_cast<S*>(take((size_t)N * ldlS * sizeof(S)));
    Bs = reinterpret_cast<S*>(take((size_t)T * ldN * sizeof(S)));
    Cs = reinterpret_cast<S*>(take((size_t)T * ldN * sizeof(S)));
    xf = reinterpret_cast<float*>(take((size_t)T * P * 4));
    gyS = reinterpret_cast<S*>(take((size_t)T * ldPS * sizeof(S)));
    wdxS = reinterpret_cast<S*>(take((size_t)T * ldPS * sizeof(S)));
    geS = reinterpret_cast<S*>(take((size_t)T * ldPS * sizeof(S)));
    unsigned char* r1 = take(region_r1());
    CBf = reinterpret_cast<float*>(r1);
    Gf = reinterpret_cast<float*>(r1 + align128((size_t)T * ldTf * 4));
    MS = reinterpret_cast<S*>(r1);
    LGS = reinterpret_cast<S*>(r1 + align128((size_t)T * ldTS * sizeof(S)));
    Blam = reinterpret_cast<float*>(take((size_t)T * ldPf * 4));
    ChD = reinterpret_cast<float*>(take((size_t)T * ldPf * 4));
    unsigned char* sc = take(region_scratch(P));
    dxS = reinterpret_cast<S*>(sc);
    stage = reinterpret_cast<float*>(sc);
    float* s = reinterpret_cast<float*>(p);
    dtv = s; cum = s + T; rowcol = s + 2 * T; qs = s + 3 * T; us = s + 4 * T;
    r3 = s + 5 * T; gcum = s + 6 * T; red = s + 7 * T;
  }
};

template <typename S, int K>
__global__ void __launch_bounds__(NTHREADS) ssd_fused_bwd_kernel(const Params p) {
  constexpr int T = Chunk<S>::T;
  constexpr int TT = T * T / NTHREADS;  // elements of a T x T tile per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int P = p.P, N = p.N, H = p.H, L = p.L, Wc = p.Wc;
  Smem<S> sm(smem_raw, P, N);
  const int g = blockIdx.x / H;
  const int hh = blockIdx.x % H;
  const int grp = hh / (H / p.NG);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool rev = p.reverse != 0;
  const int nc = (L + T - 1) / T;
  const int last = rev ? 0 : T - 1;  // a chunk's last row in scan order

  const S* xBC = static_cast<const S*>(p.xBC) + (long long)g * p.xbc_sg;
  const S* dtp = static_cast<const S*>(p.dt) + (long long)g * p.dt_sg;
  const long long y_sl = (long long)H * P;
  const S* gy = static_cast<const S*>(p.g_y) + (long long)g * L * y_sl + (long long)hh * P;
  const S* car = static_cast<const S*>(p.carries) + ((long long)g * nc * H + hh) * N * P;
  // g_B / g_C: columns of the fp32 workspace (K >= 1), or of the fp32
  // (2, G, L, NG*N) output (K = 0); g_x: the workspace's x columns (fp32),
  // or (K = 0) the (G, L, H*P) output in the storage type
  const long long gbc_sl = K == 0 ? (long long)p.NG * N : Wc;
  float* gxc = K == 0 ? nullptr : p.g_xc + (long long)g * L * Wc;
  float* gBp = K == 0 ? p.g_BC + (long long)g * L * gbc_sl + (long long)grp * N
                      : gxc + H * P + grp * N;
  float* gCp = K == 0 ? gBp + (long long)(gridDim.x / H) * L * gbc_sl  // + G rows
                      : gxc + H * P + p.NG * N + grp * N;
  S* gx = K == 0 ? static_cast<S*>(p.g_x) + (long long)g * L * H * P + (long long)hh * P
                 : nullptr;
  S* gdt = static_cast<S*>(p.g_dt) + (long long)g * L * H;
  const float A_h = p.A[hh];
  const float D_h = p.D ? p.D[hh] : 0.f;
  const float bias_h = p.dt_bias ? p.dt_bias[hh] : 0.f;
  const long long state_off = ((long long)g * H + hh) * N * P;
  const int xcol0 = hh * P;
  const int bcol0 = H * P + grp * N;
  const int ccol0 = H * P + p.NG * N + grp * N;

  for (int i = tid; i < N * P; i += NTHREADS)
    sm.lam[(i / P) * sm.ldl + i % P] = p.g_hN ? p.g_hN[state_off + i] : 0.f;
  float acc_gA = 0.f, acc_gbias = 0.f, acc_gD = 0.f;
  __syncthreads();

  for (int ci = 0; ci < nc; ++ci) {
    const int c = rev ? ci : nc - 1 - ci;  // against the scan order
    const long long row0 = (long long)c * T;
    const S* hin = car + (long long)c * H * N * P;  // (N, P), ld P

    // -- A: dt, cum and silu(conv) as the forward computed them; g_y; the
    //    rounded copy of lambda
    if (tid < 32)
      chunk_dt_cum<S, T>(dtp, p.dt_sl, hh, row0, L, bias_h, A_h, p.dt_softplus != 0, rev,
                         sm.dtv, sm.cum);
    if constexpr (K == 0) {
      load_chunk<S, T>(static_cast<const S*>(p.x) + (long long)g * p.x_sg + (long long)hh * P,
                       p.x_sl,
                       static_cast<const S*>(p.B) + (long long)g * p.b_sg + (long long)grp * N,
                       p.b_sl,
                       static_cast<const S*>(p.C) + (long long)g * p.c_sg + (long long)grp * N,
                       p.c_sl, L, row0, P, N, sm.xf, sm.Bs, sm.Cs, sm.ldN);
    } else {
      conv_silu_chunk<S, K, T>(xBC, p.xbc_sl, p.conv_w, p.conv_b, Wc, L, row0, rev, P, N, xcol0,
                               bcol0, ccol0, sm.xf, sm.Bs, sm.Cs, sm.ldN);
    }
    for (int i = tid; i < T * P; i += NTHREADS) {
      const int t = i / P, pp = i % P;
      const long long r = row0 + t;
      sm.gyS[t * sm.ldPS + pp] = r < L ? gy[r * y_sl + pp] : from_f<S>(0.f);
    }
    if constexpr (!Smem<S>::F32) {
      for (int i = tid; i < N * P; i += NTHREADS) {
        const int n = i / P, pp = i % P;
        sm.lamS[n * sm.ldlS + pp] = from_f<S>(sm.lam[n * sm.ldl + pp]);
      }
    }
    __syncthreads();

    // -- B: dx, w dx, exp(cum) g_y; CB = C B^T, G = g_y dx^T, B lambda, C h_in
    const float total = rev ? sm.cum[0] : sm.cum[T - 1];
    const float e_end = expf(total);
    for (int i = tid; i < T * P; i += NTHREADS) {
      const int t = i / P, pp = i % P;
      const float dx = sm.dtv[t] * sm.xf[i];
      sm.dxS[t * sm.ldPS + pp] = from_f<S>(dx);
      sm.wdxS[t * sm.ldPS + pp] = from_f<S>(expf(total - sm.cum[t]) * dx);
      sm.geS[t * sm.ldPS + pp] = from_f<S>(expf(sm.cum[t]) * to_f<S>(sm.gyS[t * sm.ldPS + pp]));
    }
    __syncthreads();
    BlockMM<S, false, true>::run(sm.Cs, sm.ldN, sm.Bs, sm.ldN, sm.CBf, sm.ldTf, T, T, N, false, 0.f);
    BlockMM<S, false, true>::run(sm.gyS, sm.ldPS, sm.dxS, sm.ldPS, sm.Gf, sm.ldTf, T, T, P, false,
                                 0.f);
    BlockMM<S, false, false>::run(sm.Bs, sm.ldN, sm.lamS, sm.ldlS, sm.Blam, sm.ldPf, T, P, N,
                                  false, 0.f);
    BlockMM<S, false, false>::run(sm.Cs, sm.ldN, hin, P, sm.ChD, sm.ldPf, T, P, N, false, 0.f);
    __syncthreads();

    // -- C: per-row sums (one warp per row): rowsum - colsum of LG*CB,
    //    sum_p g_y (C h), sum_p dx (B lambda); then M and LG, rounded, over
    //    CBf/Gf (all reads finish before the barrier, then the writes)
    for (int t = warp; t < T; t += NWARPS) {
      float row = 0.f, col = 0.f, qv = 0.f, uv = 0.f;
      for (int s = lane; s < T; s += 32) {
        if (rev ? s >= t : s <= t)
          row += expf(sm.cum[t] - sm.cum[s]) * sm.Gf[t * sm.ldTf + s] * sm.CBf[t * sm.ldTf + s];
        if (rev ? t >= s : t <= s)
          col += expf(sm.cum[s] - sm.cum[t]) * sm.Gf[s * sm.ldTf + t] * sm.CBf[s * sm.ldTf + t];
      }
      for (int pp = lane; pp < P; pp += 32) {
        qv += to_f<S>(sm.gyS[t * sm.ldPS + pp]) * sm.ChD[t * sm.ldPf + pp];
        uv += sm.dtv[t] * sm.xf[t * P + pp] * sm.Blam[t * sm.ldPf + pp];
      }
      row = warp_sum(row); col = warp_sum(col); qv = warp_sum(qv); uv = warp_sum(uv);
      if (lane == 0) {
        sm.rowcol[t] = row - col;
        sm.qs[t] = expf(sm.cum[t]) * qv;
        sm.us[t] = expf(total - sm.cum[t]) * uv;
      }
    }
    float mv[TT], lv[TT];
#pragma unroll
    for (int e = 0; e < TT; ++e) {
      const int idx = tid + e * NTHREADS, t = idx / T, s = idx % T;
      const float lm = (rev ? s >= t : s <= t) ? expf(sm.cum[t] - sm.cum[s]) : 0.f;
      mv[e] = sm.CBf[t * sm.ldTf + s] * lm;
      lv[e] = sm.Gf[t * sm.ldTf + s] * lm;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < TT; ++e) {
      const int idx = tid + e * NTHREADS, t = idx / T, s = idx % T;
      sm.MS[t * sm.ldTS + s] = from_f<S>(mv[e]);
      sm.LGS[t * sm.ldTS + s] = from_f<S>(lv[e]);
    }
    __syncthreads();

    // -- D: gdx = M^T g_y; sum lambda h_out (h_out = e_end h_in + B^T w dx);
    //    this head's g_C and g_B shares into the workspace
    BlockMM<S, true, false>::run(sm.MS, sm.ldTS, sm.gyS, sm.ldPS, sm.ChD, sm.ldPf, T, P, T, false,
                                 0.f);
    const Term<S, false, false> none{nullptr, 0, nullptr, 0, 0};
    float gend = 0.f;
    mm_epi<S>(N, P, Term<S, true, false>{sm.Bs, sm.ldN, sm.wdxS, sm.ldPS, T}, none, sm.stage,
              [&](int n, int pp, float v) {
                gend += sm.lam[n * sm.ldl + pp] * (e_end * to_f<S>(hin[n * P + pp]) + v);
              });
    mm_epi<S>(T, N, Term<S, false, false>{sm.LGS, sm.ldTS, sm.Bs, sm.ldN, T},
              Term<S, false, true>{sm.geS, sm.ldPS, hin, P, P}, sm.stage,
              [&](int t, int n, float v) {
                const long long r = row0 + t;
                if (r < L) atomicAdd(&gCp[r * gbc_sl + n], v);
              });
    mm_epi<S>(T, N, Term<S, true, false>{sm.LGS, sm.ldTS, sm.Cs, sm.ldN, T},
              Term<S, false, true>{sm.wdxS, sm.ldPS, sm.lamS, sm.ldlS, P}, sm.stage,
              [&](int s, int n, float v) {
                const long long r = row0 + s;
                if (r < L) atomicAdd(&gBp[r * gbc_sl + n], v);
              });
    gend = block_sum(gend, sm.red);  // its barriers also end phase D

    // -- E: lambda <- e_end lambda + C^T (exp(cum) g_y); per row (one warp):
    //    g_dx, g_x (-> workspace; K = 0: -> g_x), sum_p x g_dx, g_cum
    BlockMM<S, true, false>::run(sm.Cs, sm.ldN, sm.geS, sm.ldPS, sm.lam, sm.ldl, N, P, T, true,
                                 e_end);
    for (int t = warp; t < T; t += NWARPS) {
      const long long r = row0 + t;
      const float wv = expf(total - sm.cum[t]);
      float r3 = 0.f;
      for (int pp = lane; pp < P; pp += 32) {
        const float gdx = sm.ChD[t * sm.ldPf + pp] + wv * sm.Blam[t * sm.ldPf + pp];
        const float xv = sm.xf[t * P + pp];
        const float gyv = to_f<S>(sm.gyS[t * sm.ldPS + pp]);
        r3 += xv * gdx;
        if (r < L) {
          const float gxv = sm.dtv[t] * gdx + D_h * gyv;
          if constexpr (K == 0) {
            gx[r * (H * P) + pp] = from_f<S>(gxv);
          } else {
            gxc[r * Wc + xcol0 + pp] = gxv;
          }
          acc_gD += gyv * xv;
        }
      }
      r3 = warp_sum(r3);
      if (lane == 0) {
        sm.r3[t] = r3;
        sm.gcum[t] = sm.rowcol[t] + sm.qs[t] - sm.us[t] + (t == last ? gend : 0.f);
      }
    }
    __syncthreads();

    // -- g_a = suffix sum of g_cum in scan order (warp 0, fp32): lane l holds
    //    scan steps E*l .. E*l+E-1; then g_dt and the g_A / g_dt_bias sums
    if (tid < 32) {
      constexpr int E = T / 32;
      float part[E];
      int ts[E];
      float run = 0.f;
#pragma unroll
      for (int e = E - 1; e >= 0; --e) {
        const int q = E * lane + e;
        ts[e] = rev ? T - 1 - q : q;
        run += sm.gcum[ts[e]];
        part[e] = run;
      }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float dn = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += dn;
      }
      float excl = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) excl = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int t = ts[e];
        const long long r = row0 + t;
        const float ga = excl + part[e];
        float gd = A_h * ga + sm.r3[t];
        if (p.dt_softplus) gd *= 1.f - expf(-sm.dtv[t]);
        if (r < L) {
          gdt[r * H + hh] = from_f<S>(gd);
          acc_gbias += gd;
          acc_gA += sm.dtv[t] * ga;
        }
      }
    }
  }

  for (int i = tid; i < N * P; i += NTHREADS)
    p.g_h0[state_off + i] = sm.lam[(i / P) * sm.ldl + i % P];
  acc_gA = block_sum(acc_gA, sm.red);
  acc_gbias = block_sum(acc_gbias, sm.red);
  acc_gD = block_sum(acc_gD, sm.red);
  if (tid == 0) {
    atomicAdd(&p.g_heads[hh], acc_gA);
    atomicAdd(&p.g_heads[H + hh], acc_gbias);
    atomicAdd(&p.g_heads[2 * H + hh], acc_gD);
  }
}

struct ConvParams {
  const void* xBC;          // (G, L, Wc) storage dtype, unit column stride
  long long xbc_sg, xbc_sl;
  const float* conv_w;      // (K, Wc)
  const float* conv_b;      // (Wc,) or null
  const float* g_xc;        // (G, L, Wc) fp32: d loss / d silu(pre)
  void* g_xBC;              // (G, L, Wc) storage dtype, contiguous
  float* g_conv;            // [g_conv_w (K*Wc), g_conv_b (Wc)], zeroed
  int L, Wc, reverse;
};

// Block (column tile, row tile, g); a thread owns one column and walks its
// row tile in groups of RG rows. For output rows j0..j0+RG-1 it needs g_pre
// of RG + K - 1 rows, and pre of those reads RG + 2(K-1) raw rows, all from
// r0 - (K-1) on (forward: g_pre rows r0.., reverse: r0-(K-1)..).
template <typename S, int K, bool REV>
__global__ void __launch_bounds__(CONV_THREADS) ssd_conv_bwd_kernel(const ConvParams p) {
  const int col = blockIdx.x * CONV_THREADS + threadIdx.x;
  if (col >= p.Wc) return;
  const int g = blockIdx.z;
  const int L = p.L, Wc = p.Wc;
  constexpr bool rev = REV;  // a template argument: the taps index registers
  const S* xBC = static_cast<const S*>(p.xBC) + (long long)g * p.xbc_sg;
  const float* gxc = p.g_xc + (long long)g * L * Wc;
  S* out = static_cast<S*>(p.g_xBC) + (long long)g * L * Wc;
  float w[K], gw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) { w[k] = p.conv_w[k * Wc + col]; gw[k] = 0.f; }
  const float b = p.conv_b ? p.conv_b[col] : 0.f;
  float gb = 0.f;
  const int rend = min(L, (int)(blockIdx.y + 1) * CONV_ROWS);
  for (int r0 = blockIdx.y * CONV_ROWS; r0 < rend; r0 += RG) {
    float xr[RG + 2 * (K - 1)];   // xr[m] = xBC[r0 - (K-1) + m]
    float gp[RG + K - 1];         // gp[i] = g_pre[gi0 + i]
    const int gi0 = rev ? r0 - (K - 1) : r0;
#pragma unroll
    for (int m = 0; m < RG + 2 * (K - 1); ++m) {
      const int r = r0 - (K - 1) + m;
      const int rc = r < 0 ? 0 : (r < L ? r : L - 1);
      const float v = to_f<S>(xBC[(long long)rc * p.xbc_sl + col]);
      xr[m] = (r >= 0 && r < L) ? v : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RG + K - 1; ++i) {
      const int r = gi0 + i;
      const int rc = r < 0 ? 0 : (r < L ? r : L - 1);
      const float gv = gxc[(long long)rc * Wc + col];
      // pre[r] = sum_k w[k] x[r - (K-1) + k] (forward) / x[r + K-1-k] (reverse)
      float pre = b;
#pragma unroll
      for (int k = 0; k < K; ++k) pre += w[k] * xr[rev ? i + K - 1 - k : i + k];
      const float sg = 1.f / (1.f + expf(-pre));
      gp[i] = (r >= 0 && r < L) ? gv * sg * (1.f + pre * (1.f - sg)) : 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < RG; ++jj) {
      const int j = r0 + jj;
      if (j >= L) break;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) acc += w[k] * gp[rev ? jj + k : jj + K - 1 - k];
      out[(long long)j * Wc + col] = from_f<S>(acc);
      // row j's own g_pre, against the raw row each tap read for it
      const float gj = gp[rev ? jj + K - 1 : jj];
#pragma unroll
      for (int k = 0; k < K; ++k) gw[k] += xr[rev ? jj + 2 * (K - 1) - k : jj + k] * gj;
      gb += gj;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) atomicAdd(&p.g_conv[k * Wc + col], gw[k]);
  atomicAdd(&p.g_conv[K * Wc + col], gb);
}

template <typename S, int K>
cudaError_t launch_main(const Params& p, int G, cudaStream_t stream) {
  const size_t smem = Smem<S>::bytes(p.P, p.N);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(ssd_fused_bwd_kernel<S, K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_fused_bwd_kernel<S, K><<<G * p.H, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename S, int K>
cudaError_t launch_conv(const ConvParams& p, int G, cudaStream_t stream) {
  const dim3 grid((p.Wc + CONV_THREADS - 1) / CONV_THREADS, (p.L + CONV_ROWS - 1) / CONV_ROWS, G);
  if (p.reverse)
    ssd_conv_bwd_kernel<S, K, true><<<grid, CONV_THREADS, 0, stream>>>(p);
  else
    ssd_conv_bwd_kernel<S, K, false><<<grid, CONV_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// table[K - 1] is the launcher instantiated for conv width K (1..4).
template <typename Prm>
cudaError_t dispatch_k(cudaError_t (*const* table)(const Prm&, int, cudaStream_t), const Prm& p,
                       int G, int K, cudaStream_t stream) {
  return K >= 1 && K <= 4 ? table[K - 1](p, G, stream) : cudaErrorInvalidValue;
}

}  // namespace

// The SSD adjoint (first kernel). dtype: 0 = float32, 1 = bfloat16. g_hN, D,
// dt_bias and conv_b may be null. Zeroes the B/C columns of the g_xc
// workspace and g_heads, then launches. Returns the cudaError_t.
extern "C" int ssd_fused_bwd(
    int dtype,
    const void* xBC, long long xbc_sg, long long xbc_sl,
    const void* dt, long long dt_sg, long long dt_sl,
    const void* A, const void* D, const void* dt_bias,
    const void* conv_w, const void* conv_b,
    const void* g_y, const void* carries, const void* g_hN,
    void* g_xc, void* g_dt, void* g_h0, void* g_heads,
    int G, int L, int H, int P, int NG, int N, int K,
    int dt_softplus, int reverse, void* stream) {
  if (P % 16 != 0 || N % 16 != 0 || NG <= 0 || H % NG != 0 || L <= 0 || G <= 0)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.xBC = xBC; p.xbc_sg = xbc_sg; p.xbc_sl = xbc_sl;
  p.dt = dt; p.dt_sg = dt_sg; p.dt_sl = dt_sl;
  p.A = static_cast<const float*>(A);
  p.D = static_cast<const float*>(D);
  p.dt_bias = static_cast<const float*>(dt_bias);
  p.conv_w = static_cast<const float*>(conv_w);
  p.conv_b = static_cast<const float*>(conv_b);
  p.g_y = g_y; p.carries = carries;
  p.g_hN = static_cast<const float*>(g_hN);
  p.g_xc = static_cast<float*>(g_xc);
  p.g_dt = g_dt;
  p.g_h0 = static_cast<float*>(g_h0);
  p.g_heads = static_cast<float*>(g_heads);
  p.L = L; p.H = H; p.P = P; p.NG = NG; p.N = N; p.Wc = H * P + 2 * NG * N;
  p.dt_softplus = dt_softplus; p.reverse = reverse;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(g_heads, 0, 3 * (size_t)H * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset2DAsync(p.g_xc + H * P, (size_t)p.Wc * sizeof(float), 0,
                          2 * (size_t)NG * N * sizeof(float), (size_t)G * L, s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1) {
    static cudaError_t (*const t[4])(const Params&, int, cudaStream_t) = {
        launch_main<__nv_bfloat16, 1>, launch_main<__nv_bfloat16, 2>,
        launch_main<__nv_bfloat16, 3>, launch_main<__nv_bfloat16, 4>};
    err = dispatch_k(t, p, G, K, s);
  } else if (dtype == 0) {
    static cudaError_t (*const t[4])(const Params&, int, cudaStream_t) = {
        launch_main<float, 1>, launch_main<float, 2>, launch_main<float, 3>,
        launch_main<float, 4>};
    err = dispatch_k(t, p, G, K, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The unfused SSD adjoint (K = 0): x (G, L, H*P), B and C (G, L, NG*N) and
// dt (G, L, H), each through its own batch and row strides (unit column
// stride); g_x (G, L, H*P) in the storage dtype, g_BC = [g_B, g_C] (2, G, L,
// NG*N) fp32. dtype and the other arguments as `ssd_fused_bwd`. Zeroes g_BC
// and g_heads, then launches. Returns the cudaError_t.
extern "C" int ssd_bwd(
    int dtype,
    const void* x, long long x_sg, long long x_sl,
    const void* B, long long b_sg, long long b_sl,
    const void* C, long long c_sg, long long c_sl,
    const void* dt, long long dt_sg, long long dt_sl,
    const void* A, const void* D, const void* dt_bias,
    const void* g_y, const void* carries, const void* g_hN,
    void* g_x, void* g_BC, void* g_dt, void* g_h0, void* g_heads,
    int G, int L, int H, int P, int NG, int N,
    int dt_softplus, int reverse, void* stream) {
  if (P % 16 != 0 || N % 16 != 0 || NG <= 0 || H % NG != 0 || L <= 0 || G <= 0)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x; p.x_sg = x_sg; p.x_sl = x_sl;
  p.B = B; p.b_sg = b_sg; p.b_sl = b_sl;
  p.C = C; p.c_sg = c_sg; p.c_sl = c_sl;
  p.dt = dt; p.dt_sg = dt_sg; p.dt_sl = dt_sl;
  p.A = static_cast<const float*>(A);
  p.D = static_cast<const float*>(D);
  p.dt_bias = static_cast<const float*>(dt_bias);
  p.g_y = g_y; p.carries = carries;
  p.g_hN = static_cast<const float*>(g_hN);
  p.g_x = g_x;
  p.g_BC = static_cast<float*>(g_BC);
  p.g_dt = g_dt;
  p.g_h0 = static_cast<float*>(g_h0);
  p.g_heads = static_cast<float*>(g_heads);
  p.L = L; p.H = H; p.P = P; p.NG = NG; p.N = N; p.Wc = 0;
  p.dt_softplus = dt_softplus; p.reverse = reverse;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(g_heads, 0, 3 * (size_t)H * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(g_BC, 0, 2 * (size_t)G * L * NG * N * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  err = dtype == 1 ? launch_main<__nv_bfloat16, 0>(p, G, s)
      : dtype == 0 ? launch_main<float, 0>(p, G, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

// The SiLU + depthwise-conv adjoint (second kernel), after ssd_fused_bwd has
// filled g_xc. Zeroes g_conv ((K + 1) * Wc floats), then launches.
extern "C" int ssd_conv_bwd(
    int dtype,
    const void* xBC, long long xbc_sg, long long xbc_sl,
    const void* conv_w, const void* conv_b, const void* g_xc,
    void* g_xBC, void* g_conv,
    int G, int L, int Wc, int K, int reverse, void* stream) {
  if (L <= 0 || G <= 0 || Wc <= 0) return (int)cudaErrorInvalidValue;
  ConvParams p;
  p.xBC = xBC; p.xbc_sg = xbc_sg; p.xbc_sl = xbc_sl;
  p.conv_w = static_cast<const float*>(conv_w);
  p.conv_b = static_cast<const float*>(conv_b);
  p.g_xc = static_cast<const float*>(g_xc);
  p.g_xBC = g_xBC;
  p.g_conv = static_cast<float*>(g_conv);
  p.L = L; p.Wc = Wc; p.reverse = reverse;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(g_conv, 0, (size_t)(K + 1) * Wc * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1) {
    static cudaError_t (*const t[4])(const ConvParams&, int, cudaStream_t) = {
        launch_conv<__nv_bfloat16, 1>, launch_conv<__nv_bfloat16, 2>,
        launch_conv<__nv_bfloat16, 3>, launch_conv<__nv_bfloat16, 4>};
    err = dispatch_k(t, p, G, K, s);
  } else if (dtype == 0) {
    static cudaError_t (*const t[4])(const ConvParams&, int, cudaStream_t) = {
        launch_conv<float, 1>, launch_conv<float, 2>, launch_conv<float, 3>,
        launch_conv<float, 4>};
    err = dispatch_k(t, p, G, K, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
