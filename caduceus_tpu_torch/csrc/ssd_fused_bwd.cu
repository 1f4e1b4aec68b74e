// ssd_fused_bwd: adjoint of the SSD (Mamba-2) forward for Hopper (sm_90a).
//
// - K >= 1, entry `ssd_fused_bwd`, then `ssd_conv_bwd`: together they
//   replace the TPU kernel `_bwd_kernel(fused=True)` of
//   caduceus_tpu/ops/ssd_pallas_batched.py (launched by
//   `ssd_pallas_batched_fused_bwd_impl`, TPU kernel #3), with its
//   context-parallel contract (`ssd_pallas_batched_fused_cp`): an optional
//   `edge_hist` (G, 8, Wc), the neighbour shard's raw rows that the conv
//   reads past the sequence edge, and its gradient g_edge, which
//   `ssd_conv_bwd` writes in place of the TPU kernel's `emit_pend` spill and
//   its conv transpose (:995-1022). Plain version:
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
// The adjoint walks the chunks of a head against the scan order from the
// saved chunk-entry states (the forward's carries), with lambda = d loss /
// d (state leaving the chunk), g_hN at the scan's end. Per chunk,
// recomputing dt, cum and silu(conv) with the forward's own code
// (ssd_common.cuh), with G_ts = g_y_t . dx_s and LG = Lm * G:
//   g_dx  = (CB * Lm)^T @ g_y + w * (B @ lambda)
//   g_C  += LG @ B + (exp(cum) * g_y) @ h_in^T       (summed over heads)
//   g_B  += LG^T @ C + (w * dx) @ lambda^T           (summed over heads)
//   g_cum = rowsum(LG*CB) - colsum(LG*CB) + exp(cum) sum_p g_y (C @ h_in)
//           - w sum_p dx (B @ lambda) + [t = last] sum lambda h_out
//   g_a   = suffix sum of g_cum in scan order (fp32 warp scan)
//   g_dt  = (A g_a + sum_p x g_dx) * (1 - exp(-dt))   (softplus chain)
//   g_x   = dt g_dx + D g_y
//   lambda <- exp(sum a) lambda + C^T @ (exp(cum) * g_y)
//
// What bounds it, and the design. The bound is bytes (6,176 B/row for the
// whole function at the main geometry, bf16: xBC, dt, g_y and the carries
// read, g_xBC and g_dt written; ~1 MFLOP/row of matmul work, a third of the
// bytes' time). As in the forward, the only serial dependency is lambda,
// carried against the scan, and one block per (g, h) walking every chunk
// fills 32 of 132 SMs at G = 4. One `ssd_fused_bwd` / `ssd_bwd` call is:
// 1. `ssd_prep_kernel` (ssd_common.cuh): the post-conv B and C rows and CB
//    of every (g, group, chunk), once, read by every head of the group;
// 2. `ssd_bwd_state_kernel`, the pre-pass: per (g, h, segment) but the one
//    the scan enters first, the segment's lambda from a zero lambda at its
//    scan end, and its sum of a (it needs only C, g_y and dt);
// 3. `ssd_fused_bwd_kernel`, the main pass, per (g, h, segment): the
//    combine -- lambda entering the segment from its scan end, from g_hN
//    over the later segments in fp32 -- then the chunk walk above. It
//    writes g_x (K >= 1: the x columns of an fp32 (G, L, Wc) workspace of
//    d loss / d silu(pre)), g_dt, and (the segment the scan enters first)
//    g_h0; each head's g_B / g_C share goes to an fp32 (G, L, H, 2N)
//    workspace, not into a shared sum; its g_A / g_dt_bias / g_D partial
//    sums go to a (H, G*S, 3) buffer, and the last block of each head (an
//    atomic ticket) adds them in (g, segment) order;
// 4. `ssd_share_sum_kernel`: g_B and g_C = the heads' shares added in head
//    order (K >= 1: into the workspace's B/C columns; K = 0: into the fp32
//    (2, G, L, NG*N) output).
// So every output is summed in a fixed order and the bits do not change
// from run to run (the atomics of the first version did). In the main pass
// the next chunk's raw x rows, B, C, CB and g_y are staged by cp.async while
// the current chunk computes, each issued right after the last read of its
// buffer; warp 0 holds the next chunk's dt in registers.
//
// `ssd_conv_bwd` then runs the SiLU + conv adjoint over the whole array
// (so the TPU kernel's chunk-to-chunk `pend` spillover is not needed): a
// streaming kernel, `ssd_conv_bwd_kernel`, whose warps walk (row tile,
// column tile) items with a cp.async ring and write per-tile g_conv_w /
// g_conv_b partials, then `ssd_conv_wsum_kernel`, which adds them in a fixed
// order (design notes at the kernel).
//
// Precision: the forward's policy. Matmul operands are rounded to the storage
// dtype (bf16 WMMA with fp32 accumulation; fp32 FMA loops, no TF32); cumsums,
// decays, lambda, every reduction and the workspaces are fp32. Each head
// rounds its own LG (the TPU kernel rounds the group's sum of LG): the plain
// version does the same. Rows >= L are identity steps (dt = 0, x = B = C = 0)
// and contribute exactly 0 to every output.

#include "ssd_common.cuh"

using namespace ssd;

namespace {

struct Params {
  const void* x;            // K >= 1: the pre-conv xBC; K = 0: post-conv x (G, L, H*P);
  long long x_sg, x_sl;     // head h's x columns at h*P
  const void* B;            // post-conv B: K >= 1 the prep's `bc`, K = 0 as given
  long long b_sg, b_sl;
  const void* C;
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
  const void* edge;         // K >= 1: edge_hist (G, HIST_ROWS, Wc) or null
  long long edge_sg;
  const float* cb;          // (G, NG, nc, T, T) from the prep
  float* seg_l;             // (G, H, S, N, P): each segment's lambda from zero
  float* seg_a;             // (G, H, S): each segment's sum of a
  float* g_xc;              // K >= 1: (G, L, Wc) fp32 workspace (x columns written here)
  void* g_x;                // K = 0: (G, L, H*P) storage dtype, contiguous
  float* shares;            // (G, L, H, 2N) fp32: each head's [g_B | g_C] share
  void* g_dt;               // (G, L, H) storage dtype, contiguous
  float* g_h0;              // (G, H, N, P)
  float* partials;          // (H, G*S, 3): each block's g_A, g_dt_bias, g_D sums
  unsigned int* tickets;    // (H,), zeroed by the launcher
  float* g_heads;           // [g_A (H), g_dt_bias (H), g_D (H)]
  int L, H, P, NG, N, Wc, S, sc;
  int dt_softplus, reverse, async;
};

// Shared memory of the main pass; the host computes the same total (~223 KB
// in bf16 at T=64, N=128, P=64; ~145 KB in fp32 at T=32). Lifetimes within a
// chunk let three regions be reused: CBf/Gf (phases B-C) then MS/LGS (C-D);
// Ch (B-C) then gdx (D-E); dxS (B) then the per-warp WMMA stage (D). CB
// lands in CBf by cp.async after phase D of the chunk before.
template <typename S, int K>
struct Smem {
  static constexpr int T = Chunk<S>::T;
  static constexpr int PAD_S = sizeof(S) == 2 ? 8 : 4;
  static constexpr bool F32 = std::is_same<S, float>::value;
  float* lam; S* lamS; S* Bs; S* Cs; S* xr; float* xf; S* gyS; S* wdxS; S* geS;
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
    b += align128((size_t)XRaw<K, T>::ROWS * P * sizeof(S));               // xr
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
    xr = reinterpret_cast<S*>(take((size_t)XRaw<K, T>::ROWS * P * sizeof(S)));
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

// Shared memory of the pre-pass: lambda, two stages of C and g_y, and
// exp(cum) g_y.
template <typename S>
struct StateSmem {
  static constexpr int T = Chunk<S>::T;
  static constexpr int PAD_S = sizeof(S) == 2 ? 8 : 4;
  float* lam; S* Cs[2]; S* gyS[2]; S* geS; float* dtv; float* cum;
  int ldl, ldN, ldPS;

  static __host__ __device__ size_t bytes(int P, int N) {
    return align128((size_t)N * (P + 4) * 4) + 2 * align128((size_t)T * (N + PAD_S) * sizeof(S)) +
           3 * align128((size_t)T * (P + PAD_S) * sizeof(S)) + 2 * (size_t)T * 4;
  }

  __device__ StateSmem(unsigned char* base, int P, int N)
      : ldl(P + 4), ldN(N + PAD_S), ldPS(P + PAD_S) {
    unsigned char* p = base;
    auto take = [&](size_t n) { unsigned char* r = p; p += align128(n); return r; };
    lam = reinterpret_cast<float*>(take((size_t)N * ldl * 4));
    for (int i = 0; i < 2; ++i) Cs[i] = reinterpret_cast<S*>(take((size_t)T * ldN * sizeof(S)));
    for (int i = 0; i < 2; ++i) gyS[i] = reinterpret_cast<S*>(take((size_t)T * ldPS * sizeof(S)));
    geS = reinterpret_cast<S*>(take((size_t)T * ldPS * sizeof(S)));
    dtv = reinterpret_cast<float*>(p);
    cum = dtv + T;
  }
};

template <typename S>
struct HeadPtrs {
  const S* x; const S* B; const S* C; const S* dt; const S* gy;
  __device__ HeadPtrs(const Params& p, int g, int hh, int grp)
      : x(static_cast<const S*>(p.x) + (long long)g * p.x_sg + (long long)hh * p.P),
        B(static_cast<const S*>(p.B) + (long long)g * p.b_sg + (long long)grp * p.N),
        C(static_cast<const S*>(p.C) + (long long)g * p.c_sg + (long long)grp * p.N),
        dt(static_cast<const S*>(p.dt) + (long long)g * p.dt_sg),
        gy(static_cast<const S*>(p.g_y) + (long long)g * p.L * p.H * p.P + (long long)hh * p.P) {}
};

// The pre-pass: per (g, h, segment), every segment but the one the scan
// enters first, walking its chunks against the scan order from lambda = 0:
// lambda <- exp(sum a) lambda + C^T (exp(cum) g_y); and its sum of a.
template <typename S>
__global__ void __launch_bounds__(NTHREADS) ssd_bwd_state_kernel(const Params p) {
  constexpr int T = Chunk<S>::T;
  constexpr int E = T / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int P = p.P, N = p.N, H = p.H, L = p.L, S_ = p.S;
  StateSmem<S> sm(smem_raw, P, N);
  const bool rev = p.reverse != 0;
  const int nc = (L + T - 1) / T;
  // blocks (g, scan position qq = 1 .. S-1, h)
  const int hh = blockIdx.x % H;
  const int qq = 1 + (blockIdx.x / H) % (S_ - 1);
  const int g = blockIdx.x / (H * (S_ - 1));
  const int s = Segment::at(qq, S_, rev);
  const Segment seg(s, S_, p.sc, nc, rev);
  const int grp = hh / (H / p.NG);
  const int tid = threadIdx.x;
  const HeadPtrs<S> ptr(p, g, hh, grp);
  const long long y_sl = (long long)H * P;
  const float A_h = p.A[hh];
  const float bias_h = p.dt_bias ? p.dt_bias[hh] : 0.f;
  const bool async = p.async != 0;
  const int n = seg.hi - seg.lo;
  // the i-th chunk of the walk: against the scan order
  auto walk = [&](int i) { return seg.scan_chunk(n - 1 - i, rev); };

  for (int i = tid; i < N * P; i += NTHREADS) sm.lam[(i / P) * sm.ldl + i % P] = 0.f;
  auto issue = [&](int c, int stage) {
    if (c >= 0) {
      stage_rows<S>(sm.Cs[stage], sm.ldN, ptr.C, p.c_sl, (long long)c * T, T, N, L, async);
      stage_rows<S>(sm.gyS[stage], sm.ldPS, ptr.gy, y_sl, (long long)c * T, T, P, L, true);
    }
    cp_async_commit();
  };
  float dtr[E];
  issue(walk(0), 0);
  if (tid < 32) dt_fetch<S, T>(ptr.dt, p.dt_sl, hh, (long long)walk(0) * T, L, rev, dtr);
  float total_sum = 0.f;
  for (int i = 0; i < n; ++i) {
    const int c = walk(i), cur = i & 1;
    const int cn = i + 1 < n ? walk(i + 1) : -1;
    issue(cn, cur ^ 1);  // that stage was last read in chunk i-1
    cp_async_wait<1>();
    if (tid < 32) {
      dt_cum<T>(dtr, (long long)c * T, L, bias_h, A_h, p.dt_softplus != 0, rev, sm.dtv, sm.cum);
      if (cn >= 0) dt_fetch<S, T>(ptr.dt, p.dt_sl, hh, (long long)cn * T, L, rev, dtr);
    }
    __syncthreads();
    const float total = rev ? sm.cum[0] : sm.cum[T - 1];
    for_rc(T, P, [&](int, int t, int pp) {
      sm.geS[t * sm.ldPS + pp] = from_f<S>(expf(sm.cum[t]) * to_f<S>(sm.gyS[cur][t * sm.ldPS + pp]));
    });
    __syncthreads();
    BlockMM<S, true, false>::run(sm.Cs[cur], sm.ldN, sm.geS, sm.ldPS, sm.lam, sm.ldl, N, P, T,
                                 true, expf(total));
    total_sum += total;
    __syncthreads();
  }
  cp_async_wait<0>();
  const long long off = ((long long)g * H + hh) * S_ + s;
  for (int i = tid; i < N * P; i += NTHREADS)
    p.seg_l[off * N * P + i] = sm.lam[(i / P) * sm.ldl + i % P];
  if (tid == 0) p.seg_a[off] = total_sum;
}

template <typename S, int K>
__global__ void __launch_bounds__(NTHREADS) ssd_fused_bwd_kernel(const Params p) {
  constexpr int T = Chunk<S>::T;
  constexpr int E = T / 32;
  constexpr int TT = T * T / NTHREADS;  // elements of a T x T tile per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int P = p.P, N = p.N, H = p.H, L = p.L, Wc = p.Wc, S_ = p.S;
  Smem<S, K> sm(smem_raw, P, N);
  const bool rev = p.reverse != 0;
  const int nc = (L + T - 1) / T;
  const int hh = blockIdx.x % H;
  const int qq = (blockIdx.x / H) % S_;
  const int g = blockIdx.x / (H * S_);
  const int G = gridDim.x / (H * S_);
  const int s = Segment::at(qq, S_, rev);
  const Segment seg(s, S_, p.sc, nc, rev);
  const int grp = hh / (H / p.NG);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int last = rev ? 0 : T - 1;  // a chunk's last row in scan order
  const bool async = p.async != 0;
  const HeadPtrs<S> ptr(p, g, hh, grp);
  const long long y_sl = (long long)H * P;
  const S* car = static_cast<const S*>(p.carries) + ((long long)g * nc * H + hh) * N * P;
  const float* cb = p.cb + ((long long)g * p.NG + grp) * nc * T * T;
  // g_x: the workspace's x columns (fp32), or (K = 0) the (G, L, H*P)
  // output in the storage type; this head's [g_B | g_C] share rows
  float* gxc = K == 0 ? nullptr : p.g_xc + (long long)g * L * Wc;
  S* gx = K == 0 ? static_cast<S*>(p.g_x) + (long long)g * L * H * P + (long long)hh * P
                 : nullptr;
  float* share = p.shares + (long long)g * L * H * 2 * N + (long long)hh * 2 * N;
  const long long share_sl = (long long)H * 2 * N;
  S* gdt = static_cast<S*>(p.g_dt) + (long long)g * L * H;
  const float A_h = p.A[hh];
  const float D_h = p.D ? p.D[hh] : 0.f;
  const float bias_h = p.dt_bias ? p.dt_bias[hh] : 0.f;
  const long long state_off = ((long long)g * H + hh) * N * P;
  const int xcol0 = hh * P;
  const int n = seg.hi - seg.lo;
  auto walk = [&](int i) { return seg.scan_chunk(n - 1 - i, rev); };
  const Edge<S> edge = edge_of<S>(p.edge, p.edge_sg, Wc, g, xcol0, L, rev);

  // the combine: lambda leaving this segment at its scan end, from g_hN
  // over the later segments (fp32)
  const long long seg_off = ((long long)g * H + hh) * S_;
  for (int i = tid; i < N * P; i += NTHREADS) {
    float v = p.g_hN ? p.g_hN[state_off + i] : 0.f;
    for (int q = S_ - 1; q > seg.q; --q) {
      const int j = Segment::at(q, S_, rev);
      v = expf(p.seg_a[seg_off + j]) * v + p.seg_l[(seg_off + j) * N * P + i];
    }
    sm.lam[(i / P) * sm.ldl + i % P] = v;
  }
  float acc_gA = 0.f, acc_gbias = 0.f, acc_gD = 0.f;

  // cp.async groups, committed in this order each chunk: x raw; B and CB;
  // C and g_y
  auto issue_x = [&](int c) {
    if (c >= 0)
      stage_rows<S>(sm.xr, P, ptr.x, p.x_sl, XRaw<K, T>::row0((long long)c * T, rev),
                    XRaw<K, T>::ROWS, P, L, async, edge);
    cp_async_commit();
  };
  auto issue_bcb = [&](int c) {
    if (c >= 0) {
      stage_rows<S>(sm.Bs, sm.ldN, ptr.B, p.b_sl, (long long)c * T, T, N, L, async);
      stage_rows<float>(sm.CBf, sm.ldTf, cb + (long long)c * T * T, T, 0, T, T, T, true);
    }
    cp_async_commit();
  };
  auto issue_cgy = [&](int c) {
    if (c >= 0) {
      stage_rows<S>(sm.Cs, sm.ldN, ptr.C, p.c_sl, (long long)c * T, T, N, L, async);
      stage_rows<S>(sm.gyS, sm.ldPS, ptr.gy, y_sl, (long long)c * T, T, P, L, true);
    }
    cp_async_commit();
  };

  float dtr[E];
  {
    const int c0 = walk(0);
    issue_x(c0); issue_bcb(c0); issue_cgy(c0);
    if (tid < 32) dt_fetch<S, T>(ptr.dt, p.dt_sl, hh, (long long)c0 * T, L, rev, dtr);
  }
  for (int ci = 0; ci < n; ++ci) {
    const int c = walk(ci);
    const int cn = ci + 1 < n ? walk(ci + 1) : -1;
    const long long row0 = (long long)c * T;
    const S* hin = car + (long long)c * H * N * P;  // (N, P), ld P

    // -- A: dt, cum and silu(conv) as the forward computed them; the
    //    rounded copy of lambda
    cp_async_wait<2>();  // x raw of c
    __syncthreads();
    if (tid < 32) {
      dt_cum<T>(dtr, row0, L, bias_h, A_h, p.dt_softplus != 0, rev, sm.dtv, sm.cum);
      if (cn >= 0) dt_fetch<S, T>(ptr.dt, p.dt_sl, hh, (long long)cn * T, L, rev, dtr);
    }
    conv_x_staged<S, K, T>(sm.xr, P, p.conv_w, p.conv_b, Wc, xcol0, row0, L, rev, sm.xf);
    if constexpr (!Smem<S, K>::F32) {
      for (int i = tid; i < N * P; i += NTHREADS) {
        const int nn = i / P, pp = i % P;
        sm.lamS[nn * sm.ldlS + pp] = from_f<S>(sm.lam[nn * sm.ldl + pp]);
      }
    }
    cp_async_wait<0>();  // B, CB, C and g_y of c
    __syncthreads();
    issue_x(cn);

    // -- B: dx, w dx, exp(cum) g_y; G = g_y dx^T, B lambda, C h_in
    const float total = rev ? sm.cum[0] : sm.cum[T - 1];
    const float e_end = expf(total);
    // (plain loops: the division-free `for_rc` costs this kernel more in
    // register spills than it saves, measured on the card)
    for (int i = tid; i < T * P; i += NTHREADS) {
      const int t = i / P, pp = i % P;
      const float dx = sm.dtv[t] * sm.xf[i];
      sm.dxS[t * sm.ldPS + pp] = from_f<S>(dx);
      sm.wdxS[t * sm.ldPS + pp] = from_f<S>(expf(total - sm.cum[t]) * dx);
      sm.geS[t * sm.ldPS + pp] = from_f<S>(expf(sm.cum[t]) * to_f<S>(sm.gyS[t * sm.ldPS + pp]));
    }
    __syncthreads();
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
      for (int s2 = lane; s2 < T; s2 += 32) {
        if (rev ? s2 >= t : s2 <= t)
          row += expf(sm.cum[t] - sm.cum[s2]) * sm.Gf[t * sm.ldTf + s2] * sm.CBf[t * sm.ldTf + s2];
        if (rev ? t >= s2 : t <= s2)
          col += expf(sm.cum[s2] - sm.cum[t]) * sm.Gf[s2 * sm.ldTf + t] * sm.CBf[s2 * sm.ldTf + t];
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
      const int idx = tid + e * NTHREADS, t = idx / T, s2 = idx % T;
      const float lm = (rev ? s2 >= t : s2 <= t) ? expf(sm.cum[t] - sm.cum[s2]) : 0.f;
      mv[e] = sm.CBf[t * sm.ldTf + s2] * lm;
      lv[e] = sm.Gf[t * sm.ldTf + s2] * lm;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < TT; ++e) {
      const int idx = tid + e * NTHREADS, t = idx / T, s2 = idx % T;
      sm.MS[t * sm.ldTS + s2] = from_f<S>(mv[e]);
      sm.LGS[t * sm.ldTS + s2] = from_f<S>(lv[e]);
    }
    __syncthreads();

    // -- D: gdx = M^T g_y; sum lambda h_out (h_out = e_end h_in + B^T w dx);
    //    this head's g_C and g_B shares
    BlockMM<S, true, false>::run(sm.MS, sm.ldTS, sm.gyS, sm.ldPS, sm.ChD, sm.ldPf, T, P, T, false,
                                 0.f);
    const Term<S, false, false> none{nullptr, 0, nullptr, 0, 0};
    float gend = 0.f;
    mm_epi<S>(N, P, Term<S, true, false>{sm.Bs, sm.ldN, sm.wdxS, sm.ldPS, T}, none, sm.stage,
              [&](int nn, int pp, float v) {
                gend += sm.lam[nn * sm.ldl + pp] * (e_end * to_f<S>(hin[nn * P + pp]) + v);
              });
    mm_epi<S>(T, N, Term<S, false, false>{sm.LGS, sm.ldTS, sm.Bs, sm.ldN, T},
              Term<S, false, true>{sm.geS, sm.ldPS, hin, P, P}, sm.stage,
              [&](int t, int nn, float v) {
                const long long r = row0 + t;
                if (r < L) share[r * share_sl + N + nn] = v;
              });
    mm_epi<S>(T, N, Term<S, true, false>{sm.LGS, sm.ldTS, sm.Cs, sm.ldN, T},
              Term<S, false, true>{sm.wdxS, sm.ldPS, sm.lamS, sm.ldlS, P}, sm.stage,
              [&](int s2, int nn, float v) {
                const long long r = row0 + s2;
                if (r < L) share[r * share_sl + nn] = v;
              });
    gend = block_sum(gend, sm.red);  // its barriers also end phase D
    issue_bcb(cn);

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
    issue_cgy(cn);

    // -- F: g_a = suffix sum of g_cum in scan order (warp 0, fp32): lane l
    //    holds scan steps E*l .. E*l+E-1; then g_dt and the g_A / g_dt_bias
    //    sums
    if (tid < 32) {
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
  cp_async_wait<0>();

  if (seg.q == 0)
    for (int i = tid; i < N * P; i += NTHREADS)
      p.g_h0[state_off + i] = sm.lam[(i / P) * sm.ldl + i % P];
  acc_gA = block_sum(acc_gA, sm.red);
  acc_gbias = block_sum(acc_gbias, sm.red);
  acc_gD = block_sum(acc_gD, sm.red);
  // this block's sums, then the head's last block adds its G*S blocks' sums
  // in (g, segment) order
  if (tid == 0) {
    const int nb = G * S_;
    float* part = p.partials + ((long long)hh * nb + g * S_ + s) * 3;
    part[0] = acc_gA; part[1] = acc_gbias; part[2] = acc_gD;
    __threadfence();
    if (atomicAdd(&p.tickets[hh], 1u) == (unsigned)(nb - 1)) {
      __threadfence();
      float sums[3] = {0.f, 0.f, 0.f};
      for (int b = 0; b < nb; ++b)
        for (int j = 0; j < 3; ++j) sums[j] += __ldcg(p.partials + ((long long)hh * nb + b) * 3 + j);
      for (int j = 0; j < 3; ++j) p.g_heads[j * H + hh] = sums[j];
    }
  }
}

// g_B / g_C of every row: the shares of a group's heads added in head order.
// Thread per (row, column j of [B of every group | C of every group]).
__global__ void ssd_share_sum_kernel(const float* shares, float* out_b, float* out_c,
                                     long long o_sg, long long o_sl, int G, int L, int H,
                                     int NG, int N) {
  const long long W = 2LL * NG * N;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)G * L * W) return;
  const long long row = idx / W;
  const int j = (int)(idx % W);
  const int part = j / (NG * N), k = (j % (NG * N)) / N, nn = j % N;
  const int rep = H / NG;
  const float* sh = shares + row * H * 2 * N + part * N + nn;
  float s = 0.f;
  for (int h = k * rep; h < (k + 1) * rep; ++h) s += sh[(long long)h * 2 * N];
  const long long g = row / L, r = row % L;
  (part ? out_c : out_b)[g * o_sg + r * o_sl + (long long)k * N + nn] = s;
}

// -- the SiLU + depthwise-conv adjoint (`ssd_conv_bwd`) --------------------
//
// The function: pre = conv(xBC) (recomputed), g_pre = g_xc * silu'(pre),
// g_xBC[j] = sum_k w[k] g_pre[j + dir (K-1-k)], g_conv_w[k] = sum_i
// x[i - dir (K-1-k)] g_pre[i], g_conv_b = sum_i g_pre[i]. It is bound by
// bytes: g_xc (fp32) and xBC read once, g_xBC written once, 8 B an element
// in bf16 (3.22 GB, 0.961 ms at 3.35 TB/s for G=4, L=131072, Wc=768); the
// ~6K + 8 fp32 operations an element take a third of that time.
//
// Design. A warp owns one work item, (g, row tile of CONV_TILE rows, column
// tile of CONV_COLS columns), and walks its rows alone: each lane owns
// CONV_VC consecutive columns for the whole tile, so the warps of a block
// are independent (no barrier anywhere). The walk reads the tile's rows in
// the scan's order (downwards when `REV`), so that both directions are one
// forward-form recurrence: in walk order pre needs the K-1 raw rows before
// a row and the transpose the K-1 g_pre rows after it. Each lane stages its
// own columns of CONV_RS rows at a time into a ring of CONV_NST stages of
// shared memory by cp.async (8-byte copies of bf16 x, 16-byte of fp32 x and
// g_xc), CONV_NST - 1 stages ahead of the stage it computes (18 KB a warp
// in flight in bf16; two 96 KB blocks a SM), and reads each staged value
// once: x and g_pre move through K-row windows in registers, so g_pre is
// computed once per row, halo included. The halo (2(K-1) raw rows, K-1
// g_xc rows) is read from device memory once per tile, 0.6% of a
// 1,024-row tile. Each lane keeps its g_conv_w / g_conv_b sums over its
// tile's own rows in registers and writes them as the tile's partial, one
// per (g, row tile, column); `ssd_conv_wsum_kernel` adds them in a fixed
// order. No float atomics: the bits repeat from run to run. On the H100 at
// G=4, L=131072, Wc=768, bf16 it moves 2.9 TB/s (PERF.md); its cut-outs
// (`phase_cutouts.py --set conv`) put the rest in the memory system, not in
// the exps or the sums.
//
// A Wc that is not a multiple of CONV_VC, and operands whose rows are not
// aligned for the vector copies, take a scalar path for the lanes they
// touch (`vec_x`, `vec_g` and the lane's `full`).
//
// CONV_DROP (0 unless given; chip_smoke.py's planted faults, never the
// shipped library): 1 = the g_pre rows past each tile read as zero, 2 = the
// raw rows before each tile read as zero.

#ifndef CONV_DROP
#define CONV_DROP 0
#endif

constexpr int CONV_WARPS = 4;              // warps (work items) per block
constexpr int CONV_VC = 4;                 // columns per lane
constexpr int CONV_COLS = 32 * CONV_VC;    // columns per tile
constexpr int CONV_TILE = 1024;            // rows per tile (ops/ssd.py CONV_TILE_ROWS)
constexpr int CONV_RS = 8;                 // rows per ring stage
constexpr int CONV_NST = 4;                // ring stages per warp
constexpr int WSUM_WARPS = 8;              // tile ranges of the partial sum (ops/ssd.py CONV_SUM_RANGES)

struct ConvParams {
  const void* xBC;          // (G, L, Wc) storage dtype, unit column stride
  long long xbc_sg, xbc_sl;
  const float* conv_w;      // (K, Wc)
  const float* conv_b;      // (Wc,) or null
  const float* g_xc;        // (G, L, Wc) fp32: d loss / d silu(pre)
  void* g_xBC;              // (G, L, Wc) storage dtype, contiguous
  float* g_part;            // (G * nrt, K + 1, Wc): each tile's g_conv_w / g_conv_b sums
  const void* edge;         // edge_hist (G, HIST_ROWS, Wc) storage dtype, or null
  float* g_edge;            // its gradient (G, HIST_ROWS, Wc) fp32 (zeroed), or null
  int G, L, Wc, nrt, nct, reverse;
  int vec_x;                // xBC rows take CONV_VC-wide copies
  int vec_g;                // so do g_xc, g_xBC and g_part rows (Wc % CONV_VC == 0)
};

template <typename S>
__host__ __device__ constexpr size_t conv_smem_bytes() {
  return (size_t)CONV_WARPS * CONV_NST * CONV_RS * CONV_COLS * (sizeof(float) + sizeof(S));
}

// cp.async of 4 or 8 bytes (`cp_async16` copies 16); `valid` false writes
// zeros (src-size 0)
template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
               "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}

static_assert(CONV_VC == 4, "the vector loads and stores below move 4 columns");

__device__ __forceinline__ void ld4(const float* s, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(s);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* s, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(s);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void st4(float* d, const float (&v)[4]) {
  *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* d, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned*>(&a);
  t.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(d) = t;
}

// 4 columns from c on: one vector store, or (`vec` false) the ones < Wc
template <typename E>
__device__ __forceinline__ void store4(E* d, const float (&v)[4], bool vec, int c, int Wc) {
  if (vec) {
    st4(d, v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < Wc) d[j] = from_f<E>(v[j]);
  }
}

// One lane's walk over its work item (registers only: every method is
// inlined into the kernel).
template <typename S, int K, bool REV>
struct ConvLane {
  static constexpr int V = CONV_VC, HK = K - 1, SLOT = CONV_RS * CONV_COLS;
  long long xsl;            // xBC row stride
  int L, Wc, c, r0, r1, n, E;
  bool full, vx, vg;
  float* gring;             // this lane's columns of its warp's g_xc ring
  S* xring;                 // ... and xBC ring
  const S* xg;
  const float* gg;
  S* out;
  Edge<S> edge;             // the raw rows past the sequence edge
  float* gedge;             // the edge tile's g_edge row 0, this lane's columns; else null
  long long elo;            // sequence row of edge row 0
  float w[K][V], b[V];
  float xw[K][V];           // raw rows pos-(K-1) .. pos of the walk
  float gw[K][V];           // g_pre rows pos-(K-1) .. pos
  float aw[K][V], ab[V];    // g_conv_w / g_conv_b over the tile's own rows

  __device__ __forceinline__ ConvLane(const ConvParams& pp, int g, int rt, int ct, int lane,
                                      unsigned char* smem, int warp)
      : xsl(pp.xbc_sl), L(pp.L), Wc(pp.Wc) {
    c = ct * CONV_COLS + lane * V;
    r0 = rt * CONV_TILE;
    r1 = min(L, r0 + CONV_TILE);
    n = r1 - r0;
    // ext row e is walk position e - (K-1): e < K-1 the raw rows before the
    // tile, e >= n + K-1 the g_pre rows past it
    E = n + 2 * HK;
    full = c + V <= Wc;
    vx = pp.vec_x && full;
    vg = pp.vec_g && full;
    gring = reinterpret_cast<float*>(smem) + (size_t)warp * CONV_NST * SLOT + lane * V;
    xring = reinterpret_cast<S*>(reinterpret_cast<float*>(smem) +
                                 (size_t)CONV_WARPS * CONV_NST * SLOT) +
            (size_t)warp * CONV_NST * SLOT + lane * V;
    xg = static_cast<const S*>(pp.xBC) + (long long)g * pp.xbc_sg;
    gg = pp.g_xc + (long long)g * L * Wc;
    out = static_cast<S*>(pp.g_xBC) + (long long)g * L * Wc;
    edge = edge_of<S>(pp.edge, (long long)HIST_ROWS * Wc, Wc, g, 0, L, REV);
    elo = edge.lo;
    // the tile the walk enters the sequence by writes the conv transpose's
    // spill past the edge: the edge rows' gradient
    const bool edge_tile = REV ? r1 == L : r0 == 0;
    gedge = pp.g_edge && edge_tile ? pp.g_edge + (long long)g * HIST_ROWS * Wc + c : nullptr;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool ok = c + j < Wc;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        w[k][j] = ok ? pp.conv_w[k * Wc + c + j] : 0.f;
        xw[k][j] = gw[k][j] = aw[k][j] = 0.f;
      }
      b[j] = ok && pp.conv_b ? pp.conv_b[c + j] : 0.f;
      ab[j] = 0.f;
    }
  }

  // the array row of walk position pos
  __device__ __forceinline__ int row(int pos) const { return REV ? r1 - 1 - pos : r0 + pos; }

  // ext rows [q RS, q RS + RS) into ring slot q % NST: one commit group
  __device__ __forceinline__ void stage(int q) {
    float* gs = gring + (q % CONV_NST) * SLOT;
    S* xs = xring + (q % CONV_NST) * SLOT;
#pragma unroll
    for (int i = 0; i < CONV_RS; ++i) {
      const int e = q * CONV_RS + i;
      if (e >= E) break;
      const int r = row(e - HK);
      const bool in = r >= 0 && r < L;
      // a raw row past the sequence edge: the edge row, if any
      const S* er = in ? nullptr : edge.row(r);
      bool okx = in || er, okg = in && e >= HK;
#if CONV_DROP == 1
      okg = okg && e < n + HK;
#elif CONV_DROP == 2
      okx = okx && e >= HK;
#endif
      const long long rr = in ? r : 0;
      const S* xsrc = er ? er : xg + rr * xsl;
      if (vx) {
        if constexpr (sizeof(S) == 4)
          cp_async16(xs + i * CONV_COLS, xsrc + c, okx);
        else
          cp_async_small<V * sizeof(S)>(xs + i * CONV_COLS, xsrc + c, okx);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          xs[i * CONV_COLS + j] = okx && c + j < Wc ? xsrc[c + j] : from_f<S>(0.f);
      }
      if (vg) {
        cp_async16(gs + i * CONV_COLS, gg + rr * Wc + c, okg);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          gs[i * CONV_COLS + j] = okg && c + j < Wc ? gg[rr * Wc + c + j] : 0.f;
      }
    }
    cp_async_commit();
  }

  // one ext row: x enters its window; from walk position 0 on, its g_pre
  // (an own row: into the partial sums) enters the g_pre window; from K-1
  // on, the output row K-1 positions back is complete. CHECK: the row may
  // be a halo row (the first and last stages of a tile).
  template <bool CHECK>
  __device__ __forceinline__ void step(int e, const S* xs, const float* gs) {
    float xv[V];
    ld4(xs, xv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
#pragma unroll
      for (int k = 0; k + 1 < K; ++k) xw[k][j] = xw[k + 1][j];
      xw[K - 1][j] = xv[j];
    }
    const int pos = e - HK;
    if (CHECK && pos < 0) return;
    float gv[V], gp[V];
    ld4(gs, gv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float pre = w[0][j] * xw[0][j];
#pragma unroll
      for (int k = 1; k < K; ++k) pre = fmaf(w[k][j], xw[k][j], pre);
      pre += b[j];
      const float sg = __fdividef(1.f, 1.f + __expf(-pre));
      gp[j] = gv[j] * sg * (1.f + pre * (1.f - sg));
    }
    if (!CHECK || pos < n) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) aw[k][j] = fmaf(xw[k][j], gp[j], aw[k][j]);
        ab[j] += gp[j];
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
#pragma unroll
      for (int k = 0; k + 1 < K; ++k) gw[k][j] = gw[k + 1][j];
      gw[K - 1][j] = gp[j];
    }
    const int qo = pos - HK;
    if (CHECK && qo < 0 && !gedge) return;
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float acc = w[0][j] * gw[K - 1][j];
#pragma unroll
      for (int k = 1; k < K; ++k) acc = fmaf(w[k][j], gw[K - 1 - k][j], acc);
      o[j] = acc;
    }
    if (CHECK && qo < 0) {
      // a row past the sequence edge (the edge tile's first K-1 positions):
      // its g_edge row
      store4(gedge + (row(qo) - elo) * Wc, o, vg, c, Wc);
      return;
    }
    store4(out + (long long)row(qo) * Wc + c, o, vg, c, Wc);
  }

  __device__ __forceinline__ void walk() {
    const int nq = (E + CONV_RS - 1) / CONV_RS;
#pragma unroll
    for (int q = 0; q < CONV_NST - 1; ++q) {
      if (q < nq) stage(q);
      else cp_async_commit();
    }
    for (int q = 0; q < nq; ++q) {
      cp_async_wait<CONV_NST - 2>();  // stage q has landed (this lane's own copies)
      // into the slot of stage q - 1, which the last trip read in full
      if (q + CONV_NST - 1 < nq) stage(q + CONV_NST - 1);
      else cp_async_commit();
      const float* gs = gring + (q % CONV_NST) * SLOT;
      const S* xs = xring + (q % CONV_NST) * SLOT;
      const int e0 = q * CONV_RS;
      if (e0 >= 2 * HK && e0 + CONV_RS <= n + HK) {
        // every row of the stage is an own row whose output is complete
#pragma unroll
        for (int i = 0; i < CONV_RS; ++i) step<false>(e0 + i, xs + i * CONV_COLS, gs + i * CONV_COLS);
      } else {
#pragma unroll
        for (int i = 0; i < CONV_RS; ++i)
          if (e0 + i < E) step<true>(e0 + i, xs + i * CONV_COLS, gs + i * CONV_COLS);
      }
    }
  }
};

template <typename S, int K, bool REV>
__global__ void __launch_bounds__(CONV_WARPS * 32) ssd_conv_bwd_kernel(const ConvParams p) {
  extern __shared__ __align__(16) unsigned char conv_smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long item = (long long)blockIdx.x * CONV_WARPS + warp;
  if (item >= (long long)p.G * p.nrt * p.nct) return;  // no barrier follows
  const int ct = (int)(item % p.nct);
  const long long gt = item / p.nct;  // g * nrt + row tile: the partial's index
  ConvLane<S, K, REV> lw(p, (int)(gt / p.nrt), (int)(gt % p.nrt), ct, lane, conv_smem, warp);
  lw.walk();
  float* part = p.g_part + gt * (K + 1) * p.Wc + lw.c;
#pragma unroll
  for (int k = 0; k < K; ++k) store4(part + k * p.Wc, lw.aw[k], lw.vg, lw.c, p.Wc);
  store4(part + K * p.Wc, lw.ab, lw.vg, lw.c, p.Wc);
}

// g_conv_w / g_conv_b: the tiles' partial sums added in a fixed order. A
// block takes 32 consecutive outputs (a lane each, coalesced), its warps
// contiguous ranges of tiles, each added in tile order; warp 0 then adds
// the ranges' sums in warp order.
__global__ void __launch_bounds__(WSUM_WARPS * 32)
    ssd_conv_wsum_kernel(const float* part, float* out, int ntiles, int n) {
  __shared__ float red[WSUM_WARPS][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  const int per = (ntiles + WSUM_WARPS - 1) / WSUM_WARPS;
  const int t0 = min(ntiles, warp * per), t1 = min(ntiles, t0 + per);
  float s = 0.f;
  if (i < n) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) s += __ldg(part + (long long)t * n + i);
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < n) {
    float r = red[0][lane];
    for (int k = 1; k < WSUM_WARPS; ++k) r += red[k][lane];
    out[i] = r;
  }
}

// Sub-launches of one `ssd_fused_bwd` / `ssd_bwd` call, selected by `parts`:
// 1 the prep, 2 the pre-pass, 4 the main pass, 8 the g_B / g_C share sum
// (15: the whole adjoint).
constexpr int PART_PREP = 1, PART_STATE = 2, PART_MAIN = 4, PART_SUM = 8;

template <typename S, int K>
cudaError_t launch(const Params& p, const PrepParams& pp, int G, int parts, float* out_b,
                   float* out_c, long long o_sg, long long o_sl, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (parts & PART_PREP) {
    err = launch_prep<S, K>(pp, G, stream);
    if (err != cudaSuccess) return err;
  }
  if ((parts & PART_STATE) && p.S > 1) {
    const size_t smem = StateSmem<S>::bytes(p.P, p.N);
    err = set_smem(ssd_bwd_state_kernel<S>, smem);
    if (err != cudaSuccess) return err;
    ssd_bwd_state_kernel<S><<<G * p.H * (p.S - 1), NTHREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & PART_MAIN) {
    err = cudaMemsetAsync(p.tickets, 0, sizeof(unsigned int) * p.H, stream);
    if (err != cudaSuccess) return err;
    const size_t smem = Smem<S, K>::bytes(p.P, p.N);
    err = set_smem(ssd_fused_bwd_kernel<S, K>, smem);
    if (err != cudaSuccess) return err;
    ssd_fused_bwd_kernel<S, K><<<G * p.H * p.S, NTHREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & PART_SUM) {
    const long long total = (long long)G * p.L * 2 * p.NG * p.N;
    const int threads = 256;
    ssd_share_sum_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
        p.shares, out_b, out_c, o_sg, o_sl, G, p.L, p.H, p.NG, p.N);
    err = cudaGetLastError();
  }
  return err;
}

template <typename S>
cudaError_t dispatch_k(const Params& p, const PrepParams& pp, int G, int K, int parts,
                       float* out_b, float* out_c, long long o_sg, long long o_sl,
                       cudaStream_t s) {
  switch (K) {
    case 0: return launch<S, 0>(p, pp, G, parts, out_b, out_c, o_sg, o_sl, s);
    case 1: return launch<S, 1>(p, pp, G, parts, out_b, out_c, o_sg, o_sl, s);
    case 2: return launch<S, 2>(p, pp, G, parts, out_b, out_c, o_sg, o_sl, s);
    case 3: return launch<S, 3>(p, pp, G, parts, out_b, out_c, o_sg, o_sl, s);
    case 4: return launch<S, 4>(p, pp, G, parts, out_b, out_c, o_sg, o_sl, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(int dtype, Params& p, PrepParams& pp, int G, int K, int parts, float* out_b,
                float* out_c, long long o_sg, long long o_sl, cudaStream_t s) {
  const int T = dtype == 1 ? Chunk<__nv_bfloat16>::T : Chunk<float>::T;
  const int nc = (p.L + T - 1) / T;
  p.sc = (nc + p.S - 1) / p.S;
  const size_t es = dtype == 1 ? 2 : 4;
  p.async = aligned16(p.x, p.x_sg, p.x_sl, es) && aligned16(p.B, p.b_sg, p.b_sl, es) &&
            aligned16(p.C, p.c_sg, p.c_sl, es) &&
            (!p.edge || aligned16(p.edge, p.edge_sg, p.Wc, es));
  return dtype == 1 ? dispatch_k<__nv_bfloat16>(p, pp, G, K, parts, out_b, out_c, o_sg, o_sl, s)
       : dtype == 0 ? dispatch_k<float>(p, pp, G, K, parts, out_b, out_c, o_sg, o_sl, s)
                    : cudaErrorInvalidValue;
}

template <typename S, int K>
cudaError_t launch_conv(const ConvParams& p, cudaStream_t stream) {
  constexpr size_t smem = conv_smem_bytes<S>();
  const long long items = (long long)p.G * p.nrt * p.nct;
  const unsigned blocks = (unsigned)((items + CONV_WARPS - 1) / CONV_WARPS);
  auto* kern = p.reverse ? ssd_conv_bwd_kernel<S, K, true> : ssd_conv_bwd_kernel<S, K, false>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, CONV_WARPS * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The SSD adjoint of the fused forward. dtype: 0 = float32, 1 = bfloat16.
// g_hN, D, dt_bias, conv_b and edge_hist may be null (edge_hist: as
// `ssd_fused_fwd` takes it; the recompute of the conv reads it). Writes g_xc (G, L, Wc) fp32 (x
// columns by the main pass, B/C columns by the share sum), g_dt, g_h0 and
// g_heads = [g_A, g_dt_bias, g_D]. Workspaces: bc (G, L, 2*NG*N) storage
// dtype, cb (G, NG, nc, T, T), seg_l (G, H, S, N, P), seg_a (G, H, S),
// shares (G, L, H, 2*N), partials (H, G*S, 3) fp32, tickets (H,) uint32.
// parts: which sub-launches run (15: all). Returns the cudaError_t.
extern "C" int ssd_fused_bwd(
    int dtype,
    const void* xBC, long long xbc_sg, long long xbc_sl,
    const void* dt, long long dt_sg, long long dt_sl,
    const void* A, const void* D, const void* dt_bias,
    const void* conv_w, const void* conv_b,
    const void* g_y, const void* carries, const void* g_hN, const void* edge_hist,
    void* g_xc, void* g_dt, void* g_h0, void* g_heads,
    void* bc, void* cb, void* seg_l, void* seg_a, void* shares, void* partials, void* tickets,
    int G, int L, int H, int P, int NG, int N, int K, int S,
    int dt_softplus, int reverse, int parts, void* stream) {
  const int T = dtype == 1 ? Chunk<__nv_bfloat16>::T : Chunk<float>::T;
  if (!valid_shape(G, L, H, P, NG, N, S, T) || K < 1) return (int)cudaErrorInvalidValue;
  const int Wc = H * P + 2 * NG * N;
  const size_t es = dtype == 1 ? 2 : 4;
  Params p = {};
  p.x = xBC; p.x_sg = xbc_sg; p.x_sl = xbc_sl;
  p.B = bc; p.b_sg = (long long)L * 2 * NG * N; p.b_sl = 2 * NG * N;
  p.C = static_cast<const char*>(bc) + (size_t)NG * N * es;
  p.c_sg = p.b_sg; p.c_sl = p.b_sl;
  p.dt = dt; p.dt_sg = dt_sg; p.dt_sl = dt_sl;
  p.A = static_cast<const float*>(A);
  p.D = static_cast<const float*>(D);
  p.dt_bias = static_cast<const float*>(dt_bias);
  p.conv_w = static_cast<const float*>(conv_w);
  p.conv_b = static_cast<const float*>(conv_b);
  p.g_y = g_y; p.carries = carries;
  p.g_hN = static_cast<const float*>(g_hN);
  p.edge = edge_hist; p.edge_sg = (long long)HIST_ROWS * Wc;
  p.cb = static_cast<const float*>(cb);
  p.seg_l = static_cast<float*>(seg_l); p.seg_a = static_cast<float*>(seg_a);
  p.g_xc = static_cast<float*>(g_xc);
  p.shares = static_cast<float*>(shares);
  p.g_dt = g_dt;
  p.g_h0 = static_cast<float*>(g_h0);
  p.partials = static_cast<float*>(partials);
  p.tickets = static_cast<unsigned int*>(tickets);
  p.g_heads = static_cast<float*>(g_heads);
  p.L = L; p.H = H; p.P = P; p.NG = NG; p.N = N; p.Wc = Wc; p.S = S;
  p.dt_softplus = dt_softplus; p.reverse = reverse;
  PrepParams pp = {};
  pp.xBC = xBC; pp.xbc_sg = xbc_sg; pp.xbc_sl = xbc_sl;
  pp.conv_w = p.conv_w; pp.conv_b = p.conv_b; pp.bc = bc; pp.cb = static_cast<float*>(cb);
  pp.edge = edge_hist; pp.edge_sg = p.edge_sg;
  pp.L = L; pp.H = H; pp.P = P; pp.NG = NG; pp.N = N; pp.Wc = Wc; pp.reverse = reverse;
  float* gxc = static_cast<float*>(g_xc);
  return (int)run(dtype, p, pp, G, K, parts, gxc + H * P, gxc + H * P + NG * N,
                  (long long)L * Wc, Wc, static_cast<cudaStream_t>(stream));
}

// The unfused SSD adjoint (K = 0): x (G, L, H*P), B and C (G, L, NG*N) and
// dt (G, L, H), each through its own batch and row strides (unit column
// stride); g_x (G, L, H*P) in the storage dtype, g_BC = [g_B, g_C] (2, G, L,
// NG*N) fp32; all four sub-launches. Workspaces (no bc) and the other
// arguments as `ssd_fused_bwd`. Returns the cudaError_t.
extern "C" int ssd_bwd(
    int dtype,
    const void* x, long long x_sg, long long x_sl,
    const void* B, long long b_sg, long long b_sl,
    const void* C, long long c_sg, long long c_sl,
    const void* dt, long long dt_sg, long long dt_sl,
    const void* A, const void* D, const void* dt_bias,
    const void* g_y, const void* carries, const void* g_hN,
    void* g_x, void* g_BC, void* g_dt, void* g_h0, void* g_heads,
    void* cb, void* seg_l, void* seg_a, void* shares, void* partials, void* tickets,
    int G, int L, int H, int P, int NG, int N, int S,
    int dt_softplus, int reverse, void* stream) {
  const int T = dtype == 1 ? Chunk<__nv_bfloat16>::T : Chunk<float>::T;
  if (!valid_shape(G, L, H, P, NG, N, S, T)) return (int)cudaErrorInvalidValue;
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
  p.cb = static_cast<const float*>(cb);
  p.seg_l = static_cast<float*>(seg_l); p.seg_a = static_cast<float*>(seg_a);
  p.g_x = g_x;
  p.shares = static_cast<float*>(shares);
  p.g_dt = g_dt;
  p.g_h0 = static_cast<float*>(g_h0);
  p.partials = static_cast<float*>(partials);
  p.tickets = static_cast<unsigned int*>(tickets);
  p.g_heads = static_cast<float*>(g_heads);
  p.L = L; p.H = H; p.P = P; p.NG = NG; p.N = N; p.Wc = 0; p.S = S;
  p.dt_softplus = dt_softplus; p.reverse = reverse;
  PrepParams pp = {};
  pp.B = B; pp.b_sg = b_sg; pp.b_sl = b_sl;
  pp.C = C; pp.c_sg = c_sg; pp.c_sl = c_sl;
  pp.cb = static_cast<float*>(cb);
  pp.L = L; pp.H = H; pp.P = P; pp.NG = NG; pp.N = N; pp.reverse = reverse;
  float* gbc = static_cast<float*>(g_BC);
  return (int)run(dtype, p, pp, G, 0, PART_PREP | PART_STATE | PART_MAIN | PART_SUM, gbc,
                  gbc + (long long)G * L * NG * N,
                  (long long)L * NG * N, (long long)NG * N, static_cast<cudaStream_t>(stream));
}

// The SiLU + depthwise-conv adjoint, after ssd_fused_bwd has filled g_xc:
// the conv-adjoint walk over (g, 1,024-row tile, 128-column tile), then the
// tiles' g_conv_w / g_conv_b sums in a fixed order into g_conv ((K + 1) *
// Wc floats). g_part: (G * ceil(L / 1024), K + 1, Wc) fp32 scratch.
// edge_hist (G, 8, Wc) storage dtype, contiguous, or null: the raw rows
// past the sequence edge, as the forward read them; with it, g_edge (G, 8,
// Wc) fp32 receives their gradient (the conv transpose's spill past the
// edge; rows the conv does not read are 0), written by the tile the walk
// enters the sequence by, without atomics.
extern "C" int ssd_conv_bwd(
    int dtype,
    const void* xBC, long long xbc_sg, long long xbc_sl,
    const void* conv_w, const void* conv_b, const void* g_xc, const void* edge_hist,
    void* g_xBC, void* g_conv, void* g_part, void* g_edge,
    int G, int L, int Wc, int K, int reverse, void* stream) {
  if (L <= 0 || G <= 0 || Wc <= 0 || K < 1 || K > 4 || (dtype != 0 && dtype != 1) ||
      (edge_hist && !g_edge))
    return (int)cudaErrorInvalidValue;
  const size_t es = dtype == 1 ? 2 : 4;
  ConvParams p;
  p.xBC = xBC; p.xbc_sg = xbc_sg; p.xbc_sl = xbc_sl;
  p.conv_w = static_cast<const float*>(conv_w);
  p.conv_b = static_cast<const float*>(conv_b);
  p.g_xc = static_cast<const float*>(g_xc);
  p.g_xBC = g_xBC;
  p.g_part = static_cast<float*>(g_part);
  p.edge = edge_hist;
  p.g_edge = edge_hist ? static_cast<float*>(g_edge) : nullptr;
  p.G = G; p.L = L; p.Wc = Wc; p.reverse = reverse;
  p.nrt = (L + CONV_TILE - 1) / CONV_TILE;
  p.nct = (Wc + CONV_COLS - 1) / CONV_COLS;
  const size_t xb = CONV_VC * es;  // bytes of one lane's x copy
  p.vec_x = reinterpret_cast<uintptr_t>(xBC) % xb == 0 && (xbc_sg * (long long)es) % xb == 0 &&
            (xbc_sl * (long long)es) % xb == 0 &&
            (!edge_hist || (reinterpret_cast<uintptr_t>(edge_hist) % xb == 0 &&
                            ((long long)Wc * (long long)es) % xb == 0));
  p.vec_g = Wc % CONV_VC == 0 && reinterpret_cast<uintptr_t>(g_xc) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(g_xBC) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(g_part) % 16 == 0 &&
            (!p.g_edge || reinterpret_cast<uintptr_t>(p.g_edge) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.g_edge) {
    const cudaError_t e = cudaMemsetAsync(p.g_edge, 0, sizeof(float) * G * HIST_ROWS * Wc, s);
    if (e != cudaSuccess) return (int)e;
  }
  static cudaError_t (*const bf[4])(const ConvParams&, cudaStream_t) = {
      launch_conv<__nv_bfloat16, 1>, launch_conv<__nv_bfloat16, 2>,
      launch_conv<__nv_bfloat16, 3>, launch_conv<__nv_bfloat16, 4>};
  static cudaError_t (*const f32[4])(const ConvParams&, cudaStream_t) = {
      launch_conv<float, 1>, launch_conv<float, 2>, launch_conv<float, 3>,
      launch_conv<float, 4>};
  cudaError_t err = (dtype == 1 ? bf : f32)[K - 1](p, s);
  if (err != cudaSuccess) return (int)err;
  const int n = (K + 1) * Wc;
  ssd_conv_wsum_kernel<<<(n + 31) / 32, WSUM_WARPS * 32, 0, s>>>(
      p.g_part, static_cast<float*>(g_conv), G * p.nrt, n);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of each sub-launch (which: 0 the prep, 1 the
// pre-pass, 2 the main pass, 3 the conv adjoint's block) at K = 0 or 4,
// for the build report; -1 for anything else.
extern "C" long long ssd_fused_bwd_smem(int dtype, int K, int P, int N, int which) {
  auto of = [&](auto s, auto k) -> long long {
    using S = decltype(s);
    constexpr int KK = decltype(k)::value;
    return which == 0 ? (long long)PrepSmem<S>::bytes(N)
         : which == 1 ? (long long)StateSmem<S>::bytes(P, N)
         : which == 2 ? (long long)Smem<S, KK>::bytes(P, N)
         : which == 3 && KK > 0 ? (long long)conv_smem_bytes<S>() : -1;
  };
  using K0 = std::integral_constant<int, 0>;
  using K4 = std::integral_constant<int, 4>;
  if (K != 0 && K != 4) return -1;
  if (dtype == 1) return K ? of(__nv_bfloat16(), K4()) : of(__nv_bfloat16(), K0());
  if (dtype == 0) return K ? of(0.f, K4()) : of(0.f, K0());
  return -1;
}
