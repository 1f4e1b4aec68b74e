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
// `attn_bwd_dkv` first launches the prologue `attn_delta_kernel` (D per
// row, fp32, kept for `attn_bwd_dq`), then the dK / dV kernel; `attn_bwd_dq`
// launches the dQ kernel. Each output element is written by one block,
// with no atomics: outputs repeat bit for bit. Both kernels recompute P, so
// the adjoint takes two exps a score.
//
// bf16 design (attention_common.cuh `hop`: TMA loads into a 3-slot ring,
// one mbarrier a slot, one block barrier a tile):
// - `attn_bwd_dkv_wgmma_kernel`: one block of two warpgroups per (128-row
//   key tile, h, b), each warpgroup owning 64 keys, whose K and V arrive
//   once. The block walks the 64-row query tiles (from its diagonal on
//   when causal): Q and dO by TMA, lse and D a row a thread by cp.async
//   onto the same slot barrier. S^T = K Q^T and dP^T = V dO^T are `wgmma`
//   m64n64k16 chains from shared memory; P^T and dS^T are formed in
//   registers (the exp after one FFMA; the causal mask on the diagonal
//   tile only; rows past L arrive as zero rows of Q and dO, so they add
//   nothing), rounded to bf16 and used as the register A operands of
//   dV += P^T dO and dK += dS^T Q, with dO and Q read MN-major from the
//   same slot.
// - `attn_bwd_dq_wgmma_kernel`: one block of two warpgroups per (128-row
//   query tile, h, b), Q and dO arriving once, walking the 64-key tiles (up
//   to its diagonal when causal) through the ring: S = Q K^T and
//   dP = dO V^T on `wgmma`, dS in registers, dQ += dS K with K read
//   MN-major. Keys past L are zero rows of K, so their dS adds nothing.
//
// Bound on the card: at head width 32, dK / dV's four products (8 hd
// FLOPs a score) and its exp a score (MUFU, 16 a clock per SM) take about
// the same time; dQ is bound by its exps (PERF.md §6 row #11). What holds
// both above that (`phase_cutouts.py --set attn`): the latency of the
// register-operand products (dV and dK; dQ), then of the score products.
//
// fp32 design (`attn_bwd_dkv_kernel`, `attn_bwd_dq_kernel`, the first design, kept):
// 4-warp blocks over 64-row tiles loaded between two barriers, the products
// as FMAs, P and dS through shared memory.

#include "attention_common.cuh"

using namespace attn;

namespace {

// ---- fp32 (and the prologue of both types) --------------------------------

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

// T is float (the bf16 kernels are below).
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
    warp_mma<NS, HD>(s, sK + w * 16 * LD, LD, 1, sQ, 1, LD);   // S^T = K Q^T
    warp_mma<NS, HD>(dp, sV + w * 16 * LD, LD, 1, sO, 1, LD);  // dP^T = V dO^T
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
    warp_mma<NO, BQ>(dv, sPw, LDP, 1, sO, LD, 1);  // dV += P^T dO
    warp_mma<NO, BQ>(dk, sSw, LDP, 1, sQ, LD, 1);  // dK += dS^T Q
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
    warp_mma<NS, HD>(s, sQ + w * 16 * LD, LD, 1, sK, 1, LD);   // S = Q K^T
    warp_mma<NS, HD>(dp, sO + w * 16 * LD, LD, 1, sV, 1, LD);  // dP = dO V^T
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
    warp_mma<NO, BK>(dq, sSw, LDP, 1, sK, LD, 1);  // dQ += dS K
    __syncwarp();
  }
  store_rows<NO, T>(a.dq, b, h, row[0], L, dq, a.scale, a.scale);
}

template <typename T, int HD>
cudaError_t launch_delta(const Args& a, cudaStream_t st) {
  const long long rows = (long long)a.B * a.H * a.L;
  attn_delta_kernel<T, HD><<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const Args& a, cudaStream_t st) {
  cudaError_t e = launch_delta<T, HD>(a, st);
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

// ---- bf16 ------------------------------------------------------------------

// Shared memory of the dK / dV kernel, byte offsets from a 1024-aligned
// base: K and V (BT rows each), STAGES slots of a Q and a dO tile (BN rows
// each), the slots' lse and D rows, the slots' mbarriers and K / V's.
template <int HD>
struct DkvLayout {
  static constexpr int TILE = hop::BN * HD * 2;
  static constexpr int K = 0, V = hop::BT * HD * 2;
  static constexpr int RING = 2 * V;
  static constexpr int ROWS = RING + hop::STAGES * 2 * TILE;  // lse, D: BN floats each a slot
  static constexpr int BAR = ROWS + hop::STAGES * 2 * hop::BN * 4;
  static constexpr int BYTES = BAR + 8 * (hop::STAGES + 1) + hop::ALIGN;
};

// Two blocks an SM up to head width 32: at 64 the four accumulators and
// the two score tiles spill under 128 registers.
template <int HD>
__global__ void __launch_bounds__(hop::THREADS, HD <= 32 ? 2 : 1)
    attn_bwd_dkv_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv,
                              const __grid_constant__ CUtensorMap mo) {
  using namespace hop;
  using Lay = DkvLayout<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const float* rows = reinterpret_cast<const float*>(smem + (base - smem_u32(smem)) + Lay::ROWS);
  constexpr int NO = HD / 8;
  const int h = blockIdx.y, b = blockIdx.z, L = a.L, k0 = blockIdx.x * BT;
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + BM * wg + 16 * w + g;  // this thread's keys: key0, key0 + 8
  const int n_qt = (L + BN - 1) / BN;
  const int first = a.causal ? k0 / BN : 0;
  // this warpgroup's first query tile (its diagonal one when causal)
  const int mine = a.causal ? (k0 + BM * wg) / BN : 0;
  const long long bh = ((long long)b * a.H + h) * L;
  auto q_tile = [&](int slot) { return base + Lay::RING + slot * 2 * Lay::TILE; };
  auto bar = [&](int i) { return base + Lay::BAR + 8 * i; };  // slot i; K / V's is STAGES
  // threads 0 .. BN - 1: query tile qt into its slot, Q and dO by TMA
  // (thread 0), lse and D a row a thread (zeros past L)
  auto load = [&](int qt) {
    const int slot = (qt - first) % STAGES, i = threadIdx.x, q = qt * BN + i;
    if (i == 0) {
      bar_expect(bar(slot), 2 * Lay::TILE);
      load_rows<HD, BN>(q_tile(slot), &mq, bar(slot), b, h, qt * BN);
      load_rows<HD, BN>(q_tile(slot) + Lay::TILE, &mo, bar(slot), b, h, qt * BN);
    }
    const uint32_t r = base + Lay::ROWS + slot * 2 * BN * 4 + 4 * i;
    const long long src = bh + (q < L ? q : 0);
    cp4(r, a.lse + src, q < L);
    cp4(r + BN * 4, a.delta + src, q < L);
    cp_arrive(bar(slot));
  };

  if (threadIdx.x == 0) {
    // a ring slot completes on thread 0's TMA bytes and the BN row copies
#pragma unroll
    for (int i = 0; i < STAGES; ++i) bar_init(bar(i), 1 + BN);
    bar_init(bar(STAGES), 1);
    bar_init_fence();
  }
  __syncthreads();  // the barriers are initialized
  if (threadIdx.x == 0) {
    bar_expect(bar(STAGES), 2 * BT * HD * 2);
    load_rows<HD, BT>(base + Lay::K, &mk, bar(STAGES), b, h, k0);
    load_rows<HD, BT>(base + Lay::V, &mv, bar(STAGES), b, h, k0);
  }
  if (threadIdx.x < BN)
    for (int i = 0; i < STAGES - 1 && first + i < n_qt; ++i) load(first + i);
  float dk[NO][4], dv[NO][4];
  zero(dk);
  zero(dv);
  const float sl2 = a.scale * LOG2E;
  const uint32_t k_s = base + Lay::K + BM * Sw<HD>::SW * wg;
  const uint32_t v_s = base + Lay::V + BM * Sw<HD>::SW * wg;
  bar_wait(bar(STAGES), 0);
  for (int qt = first; qt < n_qt; ++qt) {
    const int i = qt - first;
    if (i > 0) __syncthreads();  // every warpgroup is done with tile qt - 1: its slot refills
    if (threadIdx.x < BN && qt + STAGES - 1 < n_qt) load(qt + STAGES - 1);
    if (qt < mine) continue;
    const int slot = i % STAGES, q0 = qt * BN;
    const uint32_t q_s = q_tile(slot), o_s = q_s + Lay::TILE;
    const float* ls = rows + slot * 2 * BN;
    bar_wait(bar(slot), (i / STAGES) & 1);
    float s[NS][4], dp[NS][4];
    wg_fence();
    scores<HD>(s, k_s, q_s);   // S^T = K Q^T
    scores<HD>(dp, v_s, o_s);  // dP^T = V dO^T
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);
    if (a.causal && qt == mine) {  // the diagonal tile: keys after the query masked
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * (e >> 1) > q0 + 8 * j + 2 * t + (e & 1)) s[j][e] = -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 lv = *reinterpret_cast<const float2*>(ls + c);
      const float2 dd = *reinterpret_cast<const float2*>(ls + BN + c);
      const float nl[2] = {-lv.x * LOG2E, -lv.y * LOG2E}, dl[2] = {dd.x, dd.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[j][e], sl2, nl[e & 1]));
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl[e & 1]);
      }
    }
    uint32_t pa[NS / 2][4], da[NS / 2][4];
    to_a(pa, s);
    to_a(da, dp);
    pin(dv);
    pin(dk);
    wg_fence();
    accumulate<HD>(dv, pa, o_s);  // dV += P^T dO
    accumulate<HD>(dk, da, q_s);  // dK += dS^T Q
    wg_commit();
    wg_wait<0>();
    pin(dv);
    pin(dk);
  }
  store_rows<NO, bf16>(a.dk, b, h, key0, L, dk, a.scale, a.scale);
  store_rows<NO, bf16>(a.dv, b, h, key0, L, dv, 1.f, 1.f);
}

// Shared memory of the dQ kernel, byte offsets from a 1024-aligned base: Q
// and dO (BT rows each), STAGES slots of a K and a V tile (BN rows each),
// the slots' mbarriers and Q / dO's.
template <int HD>
struct DqLayout {
  static constexpr int TILE = hop::BN * HD * 2;
  static constexpr int Q = 0, O = hop::BT * HD * 2;
  static constexpr int RING = 2 * O;
  static constexpr int BAR = RING + hop::STAGES * 2 * TILE;
  static constexpr int BYTES = BAR + 8 * (hop::STAGES + 1) + hop::ALIGN;
};

template <int HD>
__global__ void __launch_bounds__(hop::THREADS, hop::blocks_per_sm(HD))
    attn_bwd_dq_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv,
                             const __grid_constant__ CUtensorMap mo) {
  using namespace hop;
  using Lay = DqLayout<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  constexpr int NO = HD / 8;
  const int qt = a.causal ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, L = a.L, q0 = qt * BT;
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + BM * wg + 16 * w + g;  // this thread's rows: row0, row0 + 8
  const long long bh = ((long long)b * a.H + h) * L;
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    nl[r] = row < L ? -a.lse[bh + row] * LOG2E : 0.f;
    dl[r] = row < L ? a.delta[bh + row] : 0.f;
  }
  int n_kt = (L + BN - 1) / BN;
  if (a.causal) n_kt = min(n_kt, (q0 + BT - 1) / BN + 1);
  // this warpgroup's last key tile (its diagonal one when causal)
  const int last = a.causal ? (q0 + BM * wg) / BN : n_kt - 1;
  auto k_tile = [&](int slot) { return base + Lay::RING + slot * 2 * Lay::TILE; };
  auto bar = [&](int i) { return base + Lay::BAR + 8 * i; };  // slot i; Q / dO's is STAGES
  // thread 0: key tile kt into its slot
  auto load = [&](int kt) {
    const int slot = kt % STAGES;
    bar_expect(bar(slot), 2 * Lay::TILE);
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
    bar_expect(bar(STAGES), 2 * BT * HD * 2);
    load_rows<HD, BT>(base + Lay::Q, &mq, bar(STAGES), b, h, q0);
    load_rows<HD, BT>(base + Lay::O, &mo, bar(STAGES), b, h, q0);
    for (int i = 0; i < STAGES - 1 && i < n_kt; ++i) load(i);
  }
  float dq[NO][4];
  zero(dq);
  const float sl2 = a.scale * LOG2E;
  const uint32_t q_s = base + Lay::Q + BM * Sw<HD>::SW * wg;
  const uint32_t o_s = base + Lay::O + BM * Sw<HD>::SW * wg;
  bar_wait(bar(STAGES), 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt > 0) __syncthreads();  // every warpgroup is done with tile kt - 1: its slot refills
    if (threadIdx.x == 0 && kt + STAGES - 1 < n_kt) load(kt + STAGES - 1);
    if (kt > last) continue;
    const int slot = kt % STAGES, k0 = kt * BN;
    const uint32_t k_s = k_tile(slot);
    bar_wait(bar(slot), (kt / STAGES) & 1);
    float s[NS][4], dp[NS][4];
    wg_fence();
    scores<HD>(s, q_s, k_s);                 // S = Q K^T
    scores<HD>(dp, o_s, k_s + Lay::TILE);    // dP = dO V^T
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);
    if (a.causal && kt == last) {  // the diagonal tile: keys after the query masked
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) > row0 + 8 * (e >> 1)) s[j][e] = -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = fast_exp2(fmaf(s[j][e], sl2, nl[r]));
        dp[j][e] = p * (dp[j][e] - dl[r]);
      }
    uint32_t da[NS / 2][4];
    to_a(da, dp);
    pin(dq);
    wg_fence();
    accumulate<HD>(dq, da, k_s);  // dQ += dS K
    wg_commit();
    wg_wait<0>();
    pin(dq);
  }
  store_rows<NO, bf16>(a.dq, b, h, row0, L, dq, a.scale, a.scale);
}

template <int HD>
constexpr size_t wgmma_smem(int which) {
  return which == 0 ? DkvLayout<HD>::BYTES : DqLayout<HD>::BYTES;
}

template <int HD>
cudaError_t launch_wgmma(int which, const Args& a, cudaStream_t st) {
  using hop::BN;
  using hop::BT;
  const bool fixed_q = which == 1;  // dQ: Q and dO fixed, K and V in the ring
  const int rq = fixed_q ? BT : BN, rk = fixed_q ? BN : BT;
  CUtensorMap mq, mk, mv, mo;
  if (!hop::tile_map(&mq, a.q, a.B, a.L, a.H, HD, rq) ||
      !hop::tile_map(&mo, a.dout, a.B, a.L, a.H, HD, rq) ||
      !hop::tile_map(&mk, a.k, a.B, a.L, a.H, HD, rk) ||
      !hop::tile_map(&mv, a.v, a.B, a.L, a.H, HD, rk))
    return cudaErrorInvalidValue;
  const size_t smem = wgmma_smem<HD>(which);
  const dim3 grid((a.L + BT - 1) / BT, a.H, a.B);
  cudaError_t e;
  if (which == 0) {
    e = launch_delta<bf16, HD>(a, st);
    if (e != cudaSuccess) return e;
    auto kern = attn_bwd_dkv_wgmma_kernel<HD>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, hop::THREADS, smem, st>>>(a, mq, mk, mv, mo);
  } else {
    auto kern = attn_bwd_dq_wgmma_kernel<HD>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, hop::THREADS, smem, st>>>(a, mq, mk, mv, mo);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int which, int dtype, const Args& a, cudaStream_t st) {
  if (dtype == 1) return launch_wgmma<HD>(which, a, st);
  return which == 0 ? launch_dkv<float, HD>(a, st) : launch_dq<float, HD>(a, st);
}

cudaError_t by_width(int which, int dtype, int hd, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16>(which, dtype, a, st);
    case 32: return launch<32>(which, dtype, a, st);
    case 64: return launch<64>(which, dtype, a, st);
    case 128: return launch<128>(which, dtype, a, st);
  }
  return cudaErrorInvalidValue;
}

template <int HD>
long long smem_of(int which, int dtype) {
  if (dtype == 1) return (long long)wgmma_smem<HD>(which);
  return (long long)(which == 0 ? dkv_smem<float, HD>() : dq_smem<float, HD>());
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
  return (int)by_width(which, dtype, hd, a, st);
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
    case 16: return smem_of<16>(which, dtype);
    case 32: return smem_of<32>(which, dtype);
    case 64: return smem_of<64>(which, dtype);
    case 128: return smem_of<128>(which, dtype);
  }
  return -1;
}
