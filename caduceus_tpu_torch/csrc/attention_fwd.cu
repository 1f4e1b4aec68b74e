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
// bf16 design (`attn_fwd_wgmma_kernel`): one block of two warpgroups per
// (128-row query tile, h, b); each warpgroup owns 64 query rows. Q arrives
// once by TMA; 64-key K / V tiles arrive by TMA into a 3-slot ring
// (attention_common.cuh `hop`: one mbarrier a slot, one block barrier a
// tile, the next tile's load issued under the scores' product). S = Q K^T
// is a chain of `wgmma` m64n64k16 from shared memory (K-major); the online
// softmax runs on its accumulators in fp32: the running max and sum per
// row (quad shuffles), one FFMA (scale and log2 e folded in) before each
// `ex2.approx`, compares and selects only on the causal diagonal tile and
// the ragged last tile. P is rounded to bf16 in registers (as the plain
// version rounds the probabilities) and is the register A operand of
// O += P V (`wgmma` m64n<hd>k16, V read MN-major from the same slot). A
// warpgroup skips the key tiles past its own diagonal; causal grids run
// their longest tiles first; three blocks share an SM at head width 32
// (two up to 64), so the other warpgroups' softmax runs while one waits
// for its products.
//
// Bound on the card: at head width 32 a score costs 128 tensor-core FLOPs
// and one exp; the exps (MUFU, 16 a clock per SM) take about twice the
// FLOPs' time and bound the kernel (PERF.md §6 row #11). What holds it
// above that bound (`phase_cutouts.py --set attn`): the latency of the
// register-operand product O += P V, then the issue slots of the softmax
// itself (max, FFMA, exp, sum, the bf16 packing: about 250 instructions a
// warp a tile, as many issue cycles as the tile's exps take on the MUFU).
//
// fp32 design (`attn_fwd_kernel`, the first design, kept): one block of 4 warps per
// 64-row query tile, 64-row key tiles loaded between two barriers, the
// products as FMAs, P through shared memory.
//
// ATTN_DROP (a -D define of a variant build; chip_smoke.py's planted fault):
// the second key tile (keys 64 .. 127) of every query tile is skipped.

#include "attention_common.cuh"

#if defined(ATTN_LOST) && !defined(ATTN_WAIT_TRAP)
#error "ATTN_LOST hangs the shipped (unbounded) wait: build it with ATTN_WAIT_TRAP"
#endif

using namespace attn;

namespace {

// ---- fp32 ------------------------------------------------------------------

template <typename T, int HD>
constexpr size_t fwd_smem() {
  return ((size_t)(BQ + 2 * BK) * (HD + PAD) + (size_t)WARPS * 16 * (BK + PAD)) * sizeof(T);
}

// T is float (the bf16 kernel is below).
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
    warp_mma<NS, HD>(s, sQw, LD, 1, sK, 1, LD);
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
    warp_mma<NO, BK>(o, sPw, LDP, 1, sV, LD, 1);
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
cudaError_t launch_fma(const Args& a, cudaStream_t st) {
  constexpr size_t smem = fwd_smem<T, HD>();
  auto kern = attn_fwd_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.L + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// ---- bf16 ------------------------------------------------------------------

// Shared memory of the bf16 forward, byte offsets from a 1024-aligned base:
// Q (BT rows), STAGES slots of a K and a V tile (BN rows each), the slots'
// mbarriers and Q's.
template <int HD>
struct FwdLayout {
  static constexpr int TILE = hop::BN * HD * 2;
  static constexpr int Q = 0;
  static constexpr int RING = hop::BT * HD * 2;
  static constexpr int BAR = RING + hop::STAGES * 2 * TILE;
  static constexpr int BYTES = BAR + 8 * (hop::STAGES + 1) + hop::ALIGN;  // + the base's alignment
};

// Three blocks an SM up to head width 32 (at most 80 registers a thread): the
// latency of each warpgroup's products is hidden by the other five
// warpgroups' softmax (PERF.md §6: 16.2 ms against 17.1 with two, H100 80GB
// HBM3 at 700 W).
template <int HD>
__global__ void __launch_bounds__(hop::THREADS, HD <= 32 ? 3 : hop::blocks_per_sm(HD))
    attn_fwd_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv) {
  using namespace hop;
  using Lay = FwdLayout<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  constexpr int NO = HD / 8;
  const int qt = a.causal ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, L = a.L, q0 = qt * BT;
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + BM * wg + 16 * w + g;  // this thread's rows: row0, row0 + 8
  int n_kt = (L + BN - 1) / BN;
  if (a.causal) n_kt = min(n_kt, (q0 + BT - 1) / BN + 1);
  // this warpgroup's last key tile (its diagonal one when causal)
  const int last = a.causal ? (q0 + BM * wg) / BN : n_kt - 1;
  auto k_tile = [&](int slot) { return base + Lay::RING + slot * 2 * Lay::TILE; };
  auto bar = [&](int i) { return base + Lay::BAR + 8 * i; };  // slot i; Q's is STAGES
  // thread 0: key tile kt into its slot
  auto load = [&](int kt) {
    const int slot = kt % STAGES;
    bar_expect(bar(slot), 2 * Lay::TILE);
#ifdef ATTN_LOST
    if (kt == 1) return;  // the probe's lost load (attention_common.cuh)
#endif
    load_rows<HD, BN>(k_tile(slot), &mk, bar(slot), b, h, kt * BN);
    load_rows<HD, BN>(k_tile(slot) + Lay::TILE, &mv, bar(slot), b, h, kt * BN);
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= STAGES; ++i) bar_init(bar(i), 1);
    bar_init_fence();
  }
  __syncthreads();  // the barriers are initialized
  if (threadIdx.x == 0) {
    bar_expect(bar(STAGES), BT * HD * 2);
    load_rows<HD, BT>(base + Lay::Q, &mq, bar(STAGES), b, h, q0);
    for (int i = 0; i < STAGES - 1 && i < n_kt; ++i) load(i);
  }
  float o[NO][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * LOG2E;
  const uint32_t q_s = base + Lay::Q + BM * Sw<HD>::SW * wg;
  bar_wait(bar(STAGES), 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt > 0) __syncthreads();  // every warpgroup is done with tile kt - 1: its slot refills
    const bool refill = threadIdx.x == 0 && kt + STAGES - 1 < n_kt;
    bool skip = kt > last;
#ifdef ATTN_DROP
    skip = skip || kt == 1;
#endif
    if (skip) {
      if (refill) load(kt + STAGES - 1);
      continue;
    }
    const int slot = kt % STAGES, k0 = kt * BN;
    bar_wait(bar(slot), (kt / STAGES) & 1);
    float s[NS][4];
    wg_fence();
    scores<HD>(s, q_s, k_tile(slot));
    wg_commit();
    if (refill) load(kt + STAGES - 1);
    wg_wait<0>();
    pin(s);
    if ((a.causal && kt == last) || k0 + BN > L) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          if (col >= L || (a.causal && col > row0 + 8 * (e >> 1))) s[j][e] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float nb[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r] * sl2);
      const float base_r = mn == -INFINITY ? 0.f : mn;
      alpha[r] = fast_exp2(m[r] - base_r);
      nb[r] = -base_r;
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[j][e], sl2, nb[e >> 1]));
        s[j][e] = p;
        rs[e >> 1] += p;
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
    uint32_t pa[NS / 2][4];
    to_a(pa, s);
    pin(o);
    wg_fence();
    accumulate<HD>(o, pa, k_tile(slot) + Lay::TILE);
    wg_commit();
    wg_wait<0>();
    pin(o);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  store_rows<NO, bf16>(a.o, b, h, row0, L, o, 1.f / l[0], 1.f / l[1]);
  if (t == 0) {
    float* lse = a.lse + ((long long)b * a.H + h) * L;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < L) lse[row0 + 8 * r] = (m[r] + log2f(l[r])) * LN2;
  }
}

template <int HD>
constexpr size_t wgmma_smem() {
  return FwdLayout<HD>::BYTES;
}

template <int HD>
cudaError_t launch_wgmma(const Args& a, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  if (!hop::tile_map(&mq, a.q, a.B, a.L, a.H, HD, hop::BT) ||
      !hop::tile_map(&mk, a.k, a.B, a.L, a.H, HD, hop::BN) ||
      !hop::tile_map(&mv, a.v, a.B, a.L, a.H, HD, hop::BN))
    return cudaErrorInvalidValue;
  constexpr size_t smem = wgmma_smem<HD>();
  auto kern = attn_fwd_wgmma_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.L + hop::BT - 1) / hop::BT, a.H, a.B);
  kern<<<grid, hop::THREADS, smem, st>>>(a, mq, mk, mv);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const Args& a, cudaStream_t st) {
  return dtype == 1 ? launch_wgmma<HD>(a, st) : launch_fma<float, HD>(a, st);
}

cudaError_t by_width(int dtype, int hd, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16>(dtype, a, st);
    case 32: return launch<32>(dtype, a, st);
    case 64: return launch<64>(dtype, a, st);
    case 128: return launch<128>(dtype, a, st);
  }
  return cudaErrorInvalidValue;
}

template <int HD>
long long smem_of(int dtype) {
  return dtype == 1 ? (long long)wgmma_smem<HD>() : (long long)fwd_smem<float, HD>();
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
  return (int)by_width(dtype, hd, a, st);
}

// Dynamic shared memory of one block (bytes), for the build report.
extern "C" long long attn_fwd_smem(int dtype, int hd) {
  switch (hd) {
    case 16: return smem_of<16>(dtype);
    case 32: return smem_of<32>(dtype);
    case 64: return smem_of<64>(dtype);
    case 128: return smem_of<128>(dtype);
  }
  return -1;
}
