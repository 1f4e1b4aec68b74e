// attention_fwd: flash-attention forward for Hopper (sm_90a).
//
// Replaces the forward `pallas_call` of the Pallas TPU flash attention that
// the JAX package calls from `caduceus_tpu/ops/attention.py:70-77`
// (`mha_attention`, route "pallas"): `_flash_attention_impl` of
// jax/experimental/pallas/ops/tpu/flash_attention.py (its kernel body
// `_flash_attention_kernel`), which the hybrid MHA layers of the Hyena
// family run (`caduceus_tpu/models/hyena.py MHA`). Entry point `attn_fwd`;
// plain version `caduceus_tpu_torch/ops/attention.py attention_fwd_plain`;
// wrapper `ops/attention.py attention_fwd`.
//
// Per (b, h) and query row r, over keys c (c <= r when causal, c < L):
//   s_c = scale q_r . k_c,   o_r = sum_c softmax(s)_c v_c,
//   lse_r = log sum_c exp(s_c)       (fp32, kept for the adjoint)
//
// Design: one block of 4 warps per (64-row query tile, h, b); the block
// walks 64-row key tiles (up to the diagonal when causal, the last
// tile's rows past L masked) with an online softmax in fp32: each warp
// holds its 16 rows' running max, sum and output in registers, rescaled
// when the max grows. Q, K and V tiles sit in shared memory; S = Q K^T and
// O += P V run as bf16 `mma.sync` with fp32 accumulators (fp32 inputs: the
// same products as fp32 FMAs); P goes through shared memory (rounded to
// the input type, as the plain version rounds the probabilities) on its
// way from the first product's accumulators to the second's operand.
// Causal grids run their longest tiles first.
//
// Bound on the card: at head width 32 a score costs 128 FLOPs of the two
// products and one exp; the exps (16 a clock per SM) take longer than the
// tensor cores' FLOPs (PERF.md §6 row #11), and this simple design also
// spends issue slots on the shared-memory operand loads.
//
// ATTN_DROP (a -D define of a variant build; chip_smoke.py's planted fault):
// the second key tile is skipped.

#include "attention_common.cuh"

using namespace attn;

namespace {

template <typename T, int HD>
constexpr size_t fwd_smem() {
  return ((size_t)(BQ + 2 * BK) * (HD + PAD) + (size_t)WARPS * 16 * (BK + PAD)) * sizeof(T);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) attn_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = HD + PAD, LDP = BK + PAD, NO = HD / 8, NS = BK / 8;
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * LD;
  T* sV = sK + BK * LD;
  T* sP = sV + BK * LD;
  const int qt = a.causal ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, L = a.L, q0 = qt * BQ;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + w * 16 + g, q0 + w * 16 + g + 8};
  T* sPw = sP + w * 16 * LDP;
  const T* sQw = sQ + w * 16 * LD;

  load_tile<T, HD, BQ>(sQ, a.q, b, h, q0, L);
  float o[NO][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * LOG2E;
  int n_kt = (L + BK - 1) / BK;
  if (a.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
#ifdef ATTN_DROP
    if (kt == 1) continue;
#endif
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and V are read
    load_tile<T, HD, BK>(sK, a.k, b, h, k0, L);
    load_tile<T, HD, BK>(sV, a.v, b, h, k0, L);
    __syncthreads();
    float s[NS][4];
    zero(s);
    warp_mma<NS, HD, true, true>(s, sQw, LD, 1, sK, 1, LD);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * sl2;
        if (col >= L || (a.causal && col > row[e >> 1])) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = fast_exp2(m[r] - base[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[j][e] - base[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    store_acc(sPw, LDP, s);
    __syncwarp();
    warp_mma<NO, BK, true, false>(o, sPw, LDP, 1, sV, LD, 1);
    __syncwarp();  // P is read before the next tile overwrites it
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  store_rows<NO, T>(a.o, b, h, row[0], L, o, 1.f / l[0], 1.f / l[1]);
  if (t == 0) {
    float* lse = a.lse + ((long long)b * a.H + h) * L;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < L) lse[row[r]] = (m[r] + log2f(l[r])) * LN2;
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t st) {
  constexpr size_t smem = fwd_smem<T, HD>();
  auto kern = attn_fwd_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.L + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(int hd, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(a, st);
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 128: return launch<T, 128>(a, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// words: q, k, v, o (4 words each: pointer and the b, l, h strides in
// elements), then the lse pointer ((B, H, L) fp32). dtype 0 fp32, 1 bf16.
extern "C" int attn_fwd(int dtype, const long long* words, int B, int L, int H, int hd,
                        int causal, float scale, void* stream) {
  Args a{};
  a.q = view_of(words);
  a.k = view_of(words + 4);
  a.v = view_of(words + 8);
  a.o = view_of(words + 12);
  a.lse = reinterpret_cast<float*>(words[16]);
  a.B = B, a.L = L, a.H = H, a.causal = causal, a.scale = scale;
  if (B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? by_width<bf16>(hd, a, st) : by_width<float>(hd, a, st));
}

// Dynamic shared memory of one block (bytes), for the build report.
extern "C" long long attn_fwd_smem(int dtype, int hd) {
  switch (hd) {
    case 16: return dtype == 1 ? fwd_smem<bf16, 16>() : fwd_smem<float, 16>();
    case 32: return dtype == 1 ? fwd_smem<bf16, 32>() : fwd_smem<float, 32>();
    case 64: return dtype == 1 ? fwd_smem<bf16, 64>() : fwd_smem<float, 64>();
    case 128: return dtype == 1 ? fwd_smem<bf16, 128>() : fwd_smem<float, 128>();
  }
  return -1;
}
