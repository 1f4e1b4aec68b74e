// attention_bwd: the flash-attention adjoint for Hopper (sm_90a), two
// kernels with one prologue.
//
// Replaces the two backward `pallas_call`s of the Pallas TPU flash
// attention that `caduceus_tpu/ops/attention.py:70-77` calls (its custom
// VJP `_flash_attention_bwd`): `_flash_attention_bwd_dkv` (kernel body
// `_flash_attention_dkv_kernel`) -- entry point `attn_bwd_dkv` -- and
// `_flash_attention_bwd_dq` (`_flash_attention_dq_kernel`) -- entry point
// `attn_bwd_dq`, in jax/experimental/pallas/ops/tpu/flash_attention.py.
// Plain version: `caduceus_tpu_torch/ops/attention.py attention_bwd_plain`;
// wrapper `ops/attention.py attention_bwd`.
//
// With P = exp(scale Q K^T - lse) (masked), D = rowsum(dO * O):
//   dV = P^T dO,   dS = P * (dO V^T - D),   dK = scale dS^T Q,
//   dQ = scale dS K.
//
// Design: `attn_bwd_dkv` first launches the prologue `attn_delta_kernel`
// (D per row, fp32, kept for `attn_bwd_dq`), then `attn_bwd_dkv_kernel`:
// one block of 4 warps per (64-row key tile, h, b), walking the query
// tiles (from the diagonal on when causal); each warp recomputes its 16
// key rows' P^T and dS^T from Q, dO, lse and D and accumulates dK and dV
// in registers. `attn_bwd_dq_kernel`: one block per (64-row query tile, h,
// b), walking the key tiles (up to the diagonal when causal) and
// accumulating dQ in registers. Each output element is written by one
// block, with no atomics: outputs repeat bit for bit. The products are
// those of attention_fwd.cu (bf16 `mma.sync` or fp32 FMAs on tiles in
// shared memory); P and dS pass through shared memory rounded to the input
// type. Both kernels recompute P, so the adjoint takes two exps a score.

#include "attention_common.cuh"

using namespace attn;

namespace {

template <typename T, int HD>
constexpr size_t dkv_smem() {
  return ((size_t)(2 * BK + 2 * BQ) * (HD + PAD) + (size_t)2 * WARPS * 16 * (BK + PAD)) *
             sizeof(T) +
         (size_t)2 * BQ * sizeof(float);
}

template <typename T, int HD>
constexpr size_t dq_smem() {
  return ((size_t)(2 * BK + 2 * BQ) * (HD + PAD) + (size_t)WARPS * 16 * (BK + PAD)) * sizeof(T);
}

// D[b, h, l] = sum_d dO[b, l, h, d] O[b, l, h, d] in fp32; a thread a row.
template <typename T, int HD>
__global__ void attn_delta_kernel(const Args a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)a.B * a.H * a.L;
  if (i >= n) return;
  const int l = (int)(i % a.L), h = (int)((i / a.L) % a.H), b = (int)(i / ((long long)a.L * a.H));
  const T* o = row_ptr<T>(a.o, b, h, l);
  const T* d = row_ptr<T>(a.dout, b, h, l);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < HD; ++c) acc = fmaf(to_float(o[c]), to_float(d[c]), acc);
  a.delta[i] = acc;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkv_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = HD + PAD, LDP = BQ + PAD, NO = HD / 8, NS = BQ / 8;
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BK * LD;
  T* sQ = sV + BK * LD;
  T* sO = sQ + BQ * LD;  // dO
  T* sP = sO + BQ * LD;
  T* sS = sP + WARPS * 16 * LDP;
  float* sL = reinterpret_cast<float*>(sS + WARPS * 16 * LDP);
  float* sD = sL + BQ;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, L = a.L, k0 = kt * BK;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int key[2] = {k0 + w * 16 + g, k0 + w * 16 + g + 8};
  T* sPw = sP + w * 16 * LDP;
  T* sSw = sS + w * 16 * LDP;
  const long long bh = ((long long)b * a.H + h) * L;

  load_tile<T, HD, BK>(sK, a.k, b, h, k0, L);
  load_tile<T, HD, BK>(sV, a.v, b, h, k0, L);
  float dk[NO][4], dv[NO][4];
  zero(dk);
  zero(dv);
  const float sl2 = a.scale * LOG2E;
  const int n_qt = (L + BQ - 1) / BQ;
  for (int qt = a.causal ? k0 / BQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's Q, dO, lse and D are read
    load_tile<T, HD, BQ>(sQ, a.q, b, h, q0, L);
    load_tile<T, HD, BQ>(sO, a.dout, b, h, q0, L);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool in = q0 + i < L;
      sL[i] = in ? a.lse[bh + q0 + i] * LOG2E : 0.f;
      sD[i] = in ? a.delta[bh + q0 + i] : 0.f;
    }
    __syncthreads();
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    warp_mma<NS, HD, true, true>(s, sK + w * 16 * LD, LD, 1, sQ, 1, LD);   // S^T = K Q^T
    warp_mma<NS, HD, true, true>(dp, sV + w * 16 * LD, LD, 1, sO, 1, LD);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 8 * j + 2 * t + (e & 1), q = q0 + ci, kr = key[e >> 1];
        const bool ok = q < L && kr < L && !(a.causal && kr > q);
        const float p = ok ? fast_exp2(s[j][e] * sl2 - sL[ci]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sD[ci]);
      }
    }
    store_acc(sPw, LDP, s);
    store_acc(sSw, LDP, dp);
    __syncwarp();
    warp_mma<NO, BQ, true, false>(dv, sPw, LDP, 1, sO, LD, 1);  // dV += P^T dO
    warp_mma<NO, BQ, true, false>(dk, sSw, LDP, 1, sQ, LD, 1);  // dK += dS^T Q
  }
  store_rows<NO, T>(a.dk, b, h, key[0], L, dk, a.scale, a.scale);
  store_rows<NO, T>(a.dv, b, h, key[0], L, dv, 1.f, 1.f);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = HD + PAD, LDP = BK + PAD, NO = HD / 8, NS = BK / 8;
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + BQ * LD;  // dO
  T* sK = sO + BQ * LD;
  T* sV = sK + BK * LD;
  T* sS = sV + BK * LD;
  const int qt = a.causal ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, L = a.L, q0 = qt * BQ;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + w * 16 + g, q0 + w * 16 + g + 8};
  T* sSw = sS + w * 16 * LDP;
  const long long bh = ((long long)b * a.H + h) * L;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = row[r] < L ? a.lse[bh + row[r]] * LOG2E : 0.f;
    dl[r] = row[r] < L ? a.delta[bh + row[r]] : 0.f;
  }
  load_tile<T, HD, BQ>(sQ, a.q, b, h, q0, L);
  load_tile<T, HD, BQ>(sO, a.dout, b, h, q0, L);
  float dq[NO][4];
  zero(dq);
  const float sl2 = a.scale * LOG2E;
  int n_kt = (L + BK - 1) / BK;
  if (a.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, HD, BK>(sK, a.k, b, h, k0, L);
    load_tile<T, HD, BK>(sV, a.v, b, h, k0, L);
    __syncthreads();
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
    warp_mma<NS, HD, true, true>(s, sQ + w * 16 * LD, LD, 1, sK, 1, LD);   // S = Q K^T
    warp_mma<NS, HD, true, true>(dp, sO + w * 16 * LD, LD, 1, sV, 1, LD);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1), r = e >> 1;
        const bool ok = col < L && row[r] < L && !(a.causal && col > row[r]);
        const float p = ok ? fast_exp2(s[j][e] * sl2 - lse2[r]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dl[r]);
      }
    }
    store_acc(sSw, LDP, dp);
    __syncwarp();
    warp_mma<NO, BK, true, false>(dq, sSw, LDP, 1, sK, LD, 1);  // dQ += dS K
    __syncwarp();
  }
  store_rows<NO, T>(a.dq, b, h, row[0], L, dq, a.scale, a.scale);
}

template <typename T, int HD>
cudaError_t launch_dkv(const Args& a, cudaStream_t st) {
  const long long rows = (long long)a.B * a.H * a.L;
  attn_delta_kernel<T, HD><<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr size_t smem = dkv_smem<T, HD>();
  auto kern = attn_bwd_dkv_kernel<T, HD>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.L + BK - 1) / BK, a.H, a.B);
  kern<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq(const Args& a, cudaStream_t st) {
  constexpr size_t smem = dq_smem<T, HD>();
  auto kern = attn_bwd_dq_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.L + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(int which, int hd, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 16: return which == 0 ? launch_dkv<T, 16>(a, st) : launch_dq<T, 16>(a, st);
    case 32: return which == 0 ? launch_dkv<T, 32>(a, st) : launch_dq<T, 32>(a, st);
    case 64: return which == 0 ? launch_dkv<T, 64>(a, st) : launch_dq<T, 64>(a, st);
    case 128: return which == 0 ? launch_dkv<T, 128>(a, st) : launch_dq<T, 128>(a, st);
  }
  return cudaErrorInvalidValue;
}

// words: q, k, v, o, dO, dq, dk, dv (4 words each: pointer and the b, l, h
// strides in elements), then the lse and D pointers ((B, H, L) fp32).
int run(int which, int dtype, const long long* words, int B, int L, int H, int hd, int causal,
        float scale, void* stream) {
  Args a{};
  View* views[8] = {&a.q, &a.k, &a.v, &a.o, &a.dout, &a.dq, &a.dk, &a.dv};
  for (int i = 0; i < 8; ++i) *views[i] = view_of(words + 4 * i);
  a.lse = reinterpret_cast<float*>(words[32]);
  a.delta = reinterpret_cast<float*>(words[33]);
  a.B = B, a.L = L, a.H = H, a.causal = causal, a.scale = scale;
  if (B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? by_width<bf16>(which, hd, a, st)
                          : by_width<float>(which, hd, a, st));
}

}  // namespace

// The prologue (D, written to the D pointer) and the dK / dV kernel.
extern "C" int attn_bwd_dkv(int dtype, const long long* words, int B, int L, int H, int hd,
                            int causal, float scale, void* stream) {
  return run(0, dtype, words, B, L, H, hd, causal, scale, stream);
}

// The dQ kernel; reads the D that `attn_bwd_dkv` wrote.
extern "C" int attn_bwd_dq(int dtype, const long long* words, int B, int L, int H, int hd,
                           int causal, float scale, void* stream) {
  return run(1, dtype, words, B, L, H, hd, causal, scale, stream);
}

// Dynamic shared memory of one block (bytes), for the build report:
// which 0 the dK / dV kernel, 1 the dQ kernel.
extern "C" long long attn_bwd_smem(int which, int dtype, int hd) {
  switch (hd) {
    case 16: return which == 0 ? (dtype == 1 ? dkv_smem<bf16, 16>() : dkv_smem<float, 16>())
                               : (dtype == 1 ? dq_smem<bf16, 16>() : dq_smem<float, 16>());
    case 32: return which == 0 ? (dtype == 1 ? dkv_smem<bf16, 32>() : dkv_smem<float, 32>())
                               : (dtype == 1 ? dq_smem<bf16, 32>() : dq_smem<float, 32>());
    case 64: return which == 0 ? (dtype == 1 ? dkv_smem<bf16, 64>() : dkv_smem<float, 64>())
                               : (dtype == 1 ? dq_smem<bf16, 64>() : dq_smem<float, 64>());
    case 128: return which == 0 ? (dtype == 1 ? dkv_smem<bf16, 128>() : dkv_smem<float, 128>())
                                : (dtype == 1 ? dq_smem<bf16, 128>() : dq_smem<float, 128>());
  }
  return -1;
}
