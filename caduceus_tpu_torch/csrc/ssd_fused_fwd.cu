// ssd_fused_fwd / ssd_fwd: chunked SSD (Mamba-2) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of caduceus_tpu/ops/ssd_pallas_batched.py
// in both of its forms, as one __global__ templated on the conv width K:
// - K >= 1, entry `ssd_fused_fwd`: `_fwd_kernel(fused=True)` (launched by
//   `ssd_pallas_batched_fused_fwd_impl`, TPU kernel #1): depthwise conv +
//   SiLU + x/B/C split of the pre-conv xBC rows inside the kernel. Plain
//   version: caduceus_tpu_torch/ops/ssd.py `ssd_chunked_fused`.
// - K = 0, entry `ssd_fwd`: `_fwd_kernel(fused=False)` (launched by
//   `ssd_pallas_batched_fwd_impl`, TPU kernel #2): post-conv x, B and C read
//   straight from their (G, L, .) tensors through their own batch and row
//   strides (the prefill passes column views of one conv output). Plain
//   version: ops/ssd.py `ssd_chunked`.
// Both chain h_init -> hN, for either scan direction. Python wrappers:
// caduceus_tpu_torch/ops/ssd_batched.py `ssd_fused_fwd` / `ssd_fwd`.
//
// Per block (g, h) and per chunk of T rows, in scan order (right to left
// when `reverse`):
//   xc   = silu(sum_k w[k] * xBC[row - dir*(K-1-k)] + b)       fp32, zeros
//          past the sequence edges (reverse: the conv reads later rows);
//          K = 0: x, B, C as given
//   dt   = softplus(dt_raw + dt_bias), a = dt * A
//   cum  = inclusive in-scan-order cumsum of a (fp32 warp scan)
//   CB   = C @ B^T,  M = mask(CB * exp(cum_t - cum_s))
//   y    = M @ (dt x) + exp(cum) * (C @ h) + D x
//   h    = exp(sum a) * h + B^T @ (exp(sum a - cum) * dt x)
// Matmul operands are rounded to the storage dtype (bf16: tensor cores via
// WMMA / mma.sync, fp32 accumulation; fp32: plain FMA loops, no TF32), the
// state and every decay stay fp32 -- the precision policy of `_mm`
// (caduceus_tpu/ops/ssd_pallas.py:99). The cumsum never goes through a
// matmul, so no TF32/bf16 pass can truncate it.
//
// Design, translated from the TPU structure rather than copied:
// - One block per (g, h) walks all of its chunks in a loop and keeps that
//   head's (N, P) fp32 state (32 KB at N=128, P=64) in shared memory. The
//   TPU kernel keeps (N, H*P) in VMEM, 256 KB at the main geometry, over
//   the 227 KB a Hopper block can have.
// - Conv history: a work item is one column of 8 rows; it loads its rows
//   plus the K-1 neighbour rows straight from device memory, all in flight
//   at once (the TPU's 8-row history blocks and segment grid are Mosaic
//   layout / DMA artefacts).
// - The ragged tail is masked: rows >= L get dt = 0 and x = B = C = 0
//   (identity steps, the semantics of `_pad_ssd`), and are not written.
// - T = 64 rows per chunk in bf16 (~164 KB of shared memory), 32 in fp32
//   (`Chunk<S>` in ssd_common.cuh: the backward's fp32 tiles would not fit
//   at 64); one 512-thread block per SM; operand rows are padded against
//   bank conflicts.
// - With a `carries` buffer it also writes the state entering every chunk
//   (scan order), rounded to the storage dtype, as (G, nc, H, N, P) indexed
//   by array chunk: the residual of the backward kernel (ssd_fused_bwd.cu),
//   the contract of the TPU kernel's `save_carries=True`. That adds
//   N*P*2/T = 2 KB/row of writes in bf16 at the main geometry.
//
// Bound on the card: bytes. Per row it reads xBC (H*P + 2*NG*N) and dt (H)
// and writes y (H*P) -- 2.6 KB/row in bf16 at the main geometry -- against
// ~0.34 MFLOP/row of matmul work at T = 64; at 989 TF/s vs 3.35 TB/s the
// bytes take about twice as long (with carries: 4.6 KB/row). The unfused
// form (K = 0) moves the same bytes at the main geometry: x (H*P), B and C
// (2*NG*N) and dt (H) read, y (H*P) written. Known costs of this first version:
// - with ngroups = 1 every head recomputes the B/C conv and CB (8x
//   redundant at H = 8);
// - there are G*H blocks, so one 131k request (G = 2) fills 16 of 132 SMs;
//   a chunk-parallel state-passing design is the later fix;
// - one block per SM, WMMA from shared memory, no TMA / wgmma pipelining;
// - at batch 1 (a prefill) there are H = 8 blocks for 132 SMs.

#include "ssd_common.cuh"

using namespace ssd;

namespace {

struct Params {
  const void* xBC;          // K >= 1: (G, L, Wc) storage dtype, unit column stride
  long long xbc_sg, xbc_sl;  // batch / row strides in elements
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
  const float* h_init;      // (G, H, N, P) or null
  void* y;                  // (G, L, H, P) storage dtype, contiguous
  float* hN;                // (G, H, N, P)
  void* carries;            // (G, nc, H, N, P) storage dtype, or null
  int L, H, P, NG, N, Wc;
  int dt_softplus, reverse;
};

// Shared memory carve-up; the host computes the same total. Rows of the
// WMMA operands and accumulators are padded (PAD_S elements of S, 4 floats)
// so the 16 rows of a tile do not fall on the same banks.
template <typename S>
struct Smem {
  static constexpr int T = Chunk<S>::T;
  static constexpr int PAD_S = sizeof(S) == 2 ? 8 : 4;
  float* h; S* hS; S* Cs; S* Bs; float* xf; S* dxS; S* wdxS; S* MS;
  float* CBf; float* Yf; float* dtv; float* cum;
  int ldh, ldhS, ldN, ldPS, ldTS, ldTf, ldPf;

  static __host__ __device__ size_t bytes(int P, int N) {
    size_t b = (size_t)N * (P + 4) * 4;                            // h
    if (!std::is_same<S, float>::value) b += (size_t)N * (P + PAD_S) * sizeof(S);  // hS
    b += 2 * (size_t)T * (N + PAD_S) * sizeof(S);                  // Cs, Bs
    b += (size_t)T * P * 4;                                        // xf
    b += 2 * (size_t)T * (P + PAD_S) * sizeof(S);                  // dxS, wdxS
    b += (size_t)T * (T + PAD_S) * sizeof(S);                      // MS
    b += (size_t)T * (T + 4) * 4 + (size_t)T * (P + 4) * 4;        // CBf, Yf
    b += 2 * (size_t)T * 4;                                        // dtv, cum
    return b;
  }

  __device__ Smem(unsigned char* base, int P, int N)
      : ldh(P + 4), ldhS(P + PAD_S), ldN(N + PAD_S), ldPS(P + PAD_S),
        ldTS(T + PAD_S), ldTf(T + 4), ldPf(P + 4) {
    unsigned char* p = base;
    h = reinterpret_cast<float*>(p); p += (size_t)N * ldh * 4;
    if (std::is_same<S, float>::value) {
      hS = reinterpret_cast<S*>(h);  // fp32 operands need no rounded copy
    } else {
      hS = reinterpret_cast<S*>(p); p += (size_t)N * ldhS * sizeof(S);
    }
    Cs = reinterpret_cast<S*>(p); p += (size_t)T * ldN * sizeof(S);
    Bs = reinterpret_cast<S*>(p); p += (size_t)T * ldN * sizeof(S);
    xf = reinterpret_cast<float*>(p); p += (size_t)T * P * 4;
    dxS = reinterpret_cast<S*>(p); p += (size_t)T * ldPS * sizeof(S);
    wdxS = reinterpret_cast<S*>(p); p += (size_t)T * ldPS * sizeof(S);
    MS = reinterpret_cast<S*>(p); p += (size_t)T * ldTS * sizeof(S);
    CBf = reinterpret_cast<float*>(p); p += (size_t)T * ldTf * 4;
    Yf = reinterpret_cast<float*>(p); p += (size_t)T * ldPf * 4;
    dtv = reinterpret_cast<float*>(p); p += (size_t)T * 4;
    cum = reinterpret_cast<float*>(p);
  }
};

template <typename S, int K>
__global__ void __launch_bounds__(NTHREADS) ssd_fwd_kernel(const Params p) {
  constexpr int T = Chunk<S>::T;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int P = p.P, N = p.N, H = p.H, L = p.L;
  Smem<S> sm(smem_raw, P, N);
  const int g = blockIdx.x / H;
  const int hh = blockIdx.x % H;
  const int grp = hh / (H / p.NG);
  const int tid = threadIdx.x;
  const bool rev = p.reverse != 0;

  const S* xBC = static_cast<const S*>(p.xBC) + (long long)g * p.xbc_sg;
  const S* dtp = static_cast<const S*>(p.dt) + (long long)g * p.dt_sg;
  S* y = static_cast<S*>(p.y) + (long long)g * L * H * P + (long long)hh * P;
  const long long y_sl = (long long)H * P;
  const float A_h = p.A[hh];
  const float D_h = p.D ? p.D[hh] : 0.f;
  const float bias_h = p.dt_bias ? p.dt_bias[hh] : 0.f;
  const long long state_off = ((long long)g * H + hh) * N * P;

  for (int i = tid; i < N * P; i += NTHREADS)
    sm.h[(i / P) * sm.ldh + i % P] = p.h_init ? p.h_init[state_off + i] : 0.f;
  __syncthreads();

  const int nc = (L + T - 1) / T;
  const int xcol0 = hh * P;
  const int bcol0 = H * P + grp * N;
  const int ccol0 = H * P + p.NG * N + grp * N;

  for (int ci = 0; ci < nc; ++ci) {
    const int c = rev ? nc - 1 - ci : ci;
    const long long row0 = (long long)c * T;

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
      conv_silu_chunk<S, K, T>(xBC, p.xbc_sl, p.conv_w, p.conv_b, p.Wc, L, row0, rev, P, N,
                               xcol0, bcol0, ccol0, sm.xf, sm.Bs, sm.Cs, sm.ldN);
    }
    // the state entering this chunk: its rounded copy for C @ h, and the
    // carry the backward reads (G, nc, H, N, P), indexed by array chunk c
    S* car = p.carries ? static_cast<S*>(p.carries) + (((long long)g * nc + c) * H + hh) * N * P
                       : nullptr;
    if constexpr (!std::is_same<S, float>::value) {
      for (int i = tid; i < N * P; i += NTHREADS) {
        const int n = i / P, pp = i % P;
        const S v = from_f<S>(sm.h[n * sm.ldh + pp]);
        sm.hS[n * sm.ldhS + pp] = v;
        if (car) car[i] = v;
      }
    } else {
      if (car)
        for (int i = tid; i < N * P; i += NTHREADS) car[i] = sm.h[(i / P) * sm.ldh + i % P];
    }
    __syncthreads();

    // -- dt x and exp(total - cum) dt x; CB = C B^T; Y = C h
    const float total = rev ? sm.cum[0] : sm.cum[T - 1];
    for (int i = tid; i < T * P; i += NTHREADS) {
      const int t = i / P, pp = i % P;
      const float dx = sm.dtv[t] * sm.xf[i];
      sm.dxS[t * sm.ldPS + pp] = from_f<S>(dx);
      sm.wdxS[t * sm.ldPS + pp] = from_f<S>(expf(total - sm.cum[t]) * dx);
    }
    BlockMM<S, false, true>::run(sm.Cs, sm.ldN, sm.Bs, sm.ldN, sm.CBf, sm.ldTf, T, T, N,
                                 false, 0.f);
    BlockMM<S, false, false>::run(sm.Cs, sm.ldN, sm.hS, sm.ldhS, sm.Yf, sm.ldPf, T, P, N,
                                  false, 0.f);
    __syncthreads();

    // -- M = mask(CB * exp(cum_t - cum_s)); Y = exp(cum) * Y + D x
    for (int i = tid; i < T * T; i += NTHREADS) {
      const int t = i / T, s = i % T;
      const bool keep = rev ? s >= t : s <= t;
      sm.MS[t * sm.ldTS + s] =
          from_f<S>(keep ? sm.CBf[t * sm.ldTf + s] * expf(sm.cum[t] - sm.cum[s]) : 0.f);
    }
    for (int i = tid; i < T * P; i += NTHREADS) {
      const int t = i / P, pp = i % P;
      float& yv = sm.Yf[t * sm.ldPf + pp];
      yv = expf(sm.cum[t]) * yv + D_h * sm.xf[i];
    }
    __syncthreads();

    // -- Y += M @ dx;  h = exp(total) h + B^T @ wdx
    BlockMM<S, false, false>::run(sm.MS, sm.ldTS, sm.dxS, sm.ldPS, sm.Yf, sm.ldPf, T, P, T,
                                  true, 1.f);
    BlockMM<S, true, false>::run(sm.Bs, sm.ldN, sm.wdxS, sm.ldPS, sm.h, sm.ldh, N, P, T,
                                 true, expf(total));
    __syncthreads();

    for (int i = tid; i < T * P; i += NTHREADS) {
      const int t = i / P, pp = i % P;
      const long long r = row0 + t;
      if (r < L) y[r * y_sl + pp] = from_f<S>(sm.Yf[t * sm.ldPf + pp]);
    }
    // no barrier needed here: the next chunk's first phase writes no buffer
    // this loop reads, and Yf is next written after that phase's barrier
  }

  for (int i = tid; i < N * P; i += NTHREADS)
    p.hN[state_off + i] = sm.h[(i / P) * sm.ldh + i % P];
}

template <typename S, int K>
cudaError_t launch(const Params& p, int G, cudaStream_t stream) {
  const size_t smem = Smem<S>::bytes(p.P, p.N);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(ssd_fwd_kernel<S, K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_fwd_kernel<S, K><<<G * p.H, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch_k(const Params& p, int G, int K, cudaStream_t stream) {
  switch (K) {
    case 0: return launch<S, 0>(p, G, stream);
    case 1: return launch<S, 1>(p, G, stream);
    case 2: return launch<S, 2>(p, G, stream);
    case 3: return launch<S, 3>(p, G, stream);
    case 4: return launch<S, 4>(p, G, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. carries may be null (no backward to
// feed). Returns the cudaError_t of the launch.
extern "C" int ssd_fused_fwd(
    int dtype,
    const void* xBC, long long xbc_sg, long long xbc_sl,
    const void* dt, long long dt_sg, long long dt_sl,
    const void* A, const void* D, const void* dt_bias,
    const void* conv_w, const void* conv_b, const void* h_init,
    void* y, void* hN, void* carries,
    int G, int L, int H, int P, int NG, int N, int K,
    int dt_softplus, int reverse, void* stream) {
  if (P % 16 != 0 || N % 16 != 0 || NG <= 0 || H % NG != 0 || L <= 0 || G <= 0)
    return (int)cudaErrorInvalidValue;
  if (K < 1) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.xBC = xBC; p.xbc_sg = xbc_sg; p.xbc_sl = xbc_sl;
  p.dt = dt; p.dt_sg = dt_sg; p.dt_sl = dt_sl;
  p.A = static_cast<const float*>(A);
  p.D = static_cast<const float*>(D);
  p.dt_bias = static_cast<const float*>(dt_bias);
  p.conv_w = static_cast<const float*>(conv_w);
  p.conv_b = static_cast<const float*>(conv_b);
  p.h_init = static_cast<const float*>(h_init);
  p.y = y; p.hN = static_cast<float*>(hN); p.carries = carries;
  p.L = L; p.H = H; p.P = P; p.NG = NG; p.N = N; p.Wc = H * P + 2 * NG * N;
  p.dt_softplus = dt_softplus; p.reverse = reverse;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? dispatch_k<__nv_bfloat16>(p, G, K, s)
                  : dtype == 0 ? dispatch_k<float>(p, G, K, s)
                               : cudaErrorInvalidValue;
  return (int)err;
}

// The unfused forward (K = 0): x (G, L, H*P), B and C (G, L, NG*N) and dt
// (G, L, H), each through its own batch and row strides (unit column
// stride). dtype, carries and the return value as `ssd_fused_fwd`.
extern "C" int ssd_fwd(
    int dtype,
    const void* x, long long x_sg, long long x_sl,
    const void* B, long long b_sg, long long b_sl,
    const void* C, long long c_sg, long long c_sl,
    const void* dt, long long dt_sg, long long dt_sl,
    const void* A, const void* D, const void* dt_bias, const void* h_init,
    void* y, void* hN, void* carries,
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
  p.h_init = static_cast<const float*>(h_init);
  p.y = y; p.hN = static_cast<float*>(hN); p.carries = carries;
  p.L = L; p.H = H; p.P = P; p.NG = NG; p.N = N; p.Wc = 0;
  p.dt_softplus = dt_softplus; p.reverse = reverse;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch<__nv_bfloat16, 0>(p, G, s)
                  : dtype == 0 ? launch<float, 0>(p, G, s)
                               : cudaErrorInvalidValue;
  return (int)err;
}
