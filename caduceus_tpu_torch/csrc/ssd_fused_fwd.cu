// ssd_fused_fwd / ssd_fwd: chunked SSD (Mamba-2) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of caduceus_tpu/ops/ssd_pallas_batched.py
// in both of its forms, as one set of __global__ templates on the conv width K:
// - K >= 1, entry `ssd_fused_fwd`: `_fwd_kernel(fused=True)` (launched by
//   `ssd_pallas_batched_fused_fwd_impl`, TPU kernel #1): depthwise conv +
//   SiLU + x/B/C split of the pre-conv xBC rows inside the kernels. Plain
//   version: caduceus_tpu_torch/ops/ssd.py `ssd_chunked_fused`.
// - K = 0, entry `ssd_fwd`: `_fwd_kernel(fused=False)` (launched by
//   `ssd_pallas_batched_fwd_impl`, TPU kernel #2, and, per head, by
//   ops/ssd_pallas.py `ssd_pallas_fwd_impl`, #5): post-conv x, B and C read
//   straight from their (G, L, .) tensors through their own batch and row
//   strides (the prefill passes column views of one conv output). Plain
//   version: ops/ssd.py `ssd_chunked`.
// Both chain h_init -> hN, for either scan direction. Python wrappers:
// caduceus_tpu_torch/ops/ssd_batched.py `ssd_fused_fwd` / `ssd_fwd`.
//
// Per (g, h) and per chunk of T rows, in scan order (right to left when
// `reverse`):
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
// What bounds it, and the design. The bound is bytes: per row it reads xBC
// (H*P + 2*NG*N) and dt (H) and writes y (H*P), 2.6 KB/row in bf16 at the
// main geometry (with the carries 4.6 KB/row), against ~0.34 MFLOP/row of
// matmul work. The only serial dependency is the state carried from chunk
// to chunk; a block that walks all L/T chunks of one (g, h) alone is bound
// by its own latency per chunk, and at G = 4 such blocks fill 32 of 132 SMs
// (8 at a batch-1 prefill). So one call is three launches:
// 1. `ssd_prep_kernel` (ssd_common.cuh), one block per (chunk, group, g),
//    fully parallel: the B/C conv and CB = C B^T, once per group and chunk
//    (every head of the group reads them; at ngroups 1 each head recomputed
//    both before).
// 2. `ssd_fwd_state_kernel`, the pre-pass: the nc chunks of each (g, h) are
//    cut into S segments of whole chunks (S from G*H and the SM count, so
//    that G*H*S blocks fill the card); per (g, h, segment) but the one the
//    scan leaves last, the segment's own state from a zero state and its
//    sum of a. It needs only x, B and dt.
// 3. `ssd_fwd_kernel`, the main pass, per (g, h, segment): first the
//    combine -- the segment boundaries in scan order, in fp32, from h_init:
//    h <- exp(sum a of segment j) h + state of segment j for every segment
//    before this one -- then the per-chunk walk above from that state,
//    writing y, the carries, and (the last segment) hN.
// Inside a block the next chunk's operands are in flight while the current
// one computes: the raw x rows, B, C and CB tiles are staged by cp.async
// one chunk ahead, each issued right after the last read of its buffer in
// the current chunk; warp 0 holds the next chunk's dt in registers.
// Rows >= L are masked identity steps (dt = 0, x = B = C = 0; the semantics
// of `_pad_ssd`) and are not written; so chained calls equal one call, and
// L shorter than a segment is one segment.
//
// Shared memory (bf16, T = 64, N = 128, P = 64): main pass ~171 KB, one block
// per SM; pre-pass ~110 KB; prep ~50 KB. T = 64 rows per chunk in bf16, 32
// in fp32 (`Chunk<S>`: the backward's fp32 tiles would not fit at 64).
// With a `carries` buffer it also writes the state entering every chunk
// (scan order), rounded to the storage dtype, as (G, nc, H, N, P) indexed by
// array chunk: the residual of the backward kernel (ssd_fused_bwd.cu), the
// contract of the TPU kernel's `save_carries=True`.

#include "ssd_common.cuh"

using namespace ssd;

namespace {

struct Params {
  const void* x;            // K >= 1: the pre-conv xBC; K = 0: post-conv x (G, L, H*P);
  long long x_sg, x_sl;     // head h's x columns at h*P; batch / row strides
  const void* B;            // post-conv B: K >= 1 the prep's `bc`, K = 0 as given
  long long b_sg, b_sl;     // (group k's N columns at k*N)
  const void* C;
  long long c_sg, c_sl;
  const void* dt;           // (G, L, H) storage dtype, unit column stride
  long long dt_sg, dt_sl;
  const float* A;           // (H,)
  const float* D;           // (H,) or null
  const float* dt_bias;     // (H,) or null
  const float* conv_w;      // (K, Wc); null when K = 0
  const float* conv_b;      // (Wc,) or null
  const float* h_init;      // (G, H, N, P) or null
  const float* cb;          // (G, NG, nc, T, T) from the prep
  float* seg_h;             // (G, H, S, N, P): each segment's state from zero
  float* seg_a;             // (G, H, S): each segment's sum of a
  void* y;                  // (G, L, H, P) storage dtype, contiguous
  float* hN;                // (G, H, N, P)
  void* carries;            // (G, nc, H, N, P) storage dtype, or null
  int L, H, P, NG, N, Wc, S, sc;
  int dt_softplus, reverse, async;
};

// Shared memory of the main pass; the host computes the same total. Rows of
// the WMMA operands and accumulators are padded (PAD_S elements of S, 4
// floats) so the 16 rows of a tile do not fall on the same banks.
template <typename S, int K>
struct Smem {
  static constexpr int T = Chunk<S>::T;
  static constexpr int PAD_S = sizeof(S) == 2 ? 8 : 4;
  static constexpr bool F32 = std::is_same<S, float>::value;
  float* h; S* hS; S* xr; S* Cs; S* Bs; float* CB; float* xf; S* dxS; S* wdxS; S* MS;
  float* Yf; float* dtv; float* cum;
  int ldh, ldhS, ldN, ldPS, ldTS, ldPf;

  static __host__ __device__ size_t bytes(int P, int N) {
    size_t b = align128((size_t)N * (P + 4) * 4);                            // h
    if (!F32) b += align128((size_t)N * (P + PAD_S) * sizeof(S));           // hS
    b += align128((size_t)XRaw<K, T>::ROWS * P * sizeof(S));                // xr
    b += 2 * align128((size_t)T * (N + PAD_S) * sizeof(S));                 // Cs, Bs
    b += align128((size_t)T * T * 4);                                       // CB
    b += align128((size_t)T * P * 4);                                       // xf
    b += 2 * align128((size_t)T * (P + PAD_S) * sizeof(S));                 // dxS, wdxS
    b += align128((size_t)T * (T + PAD_S) * sizeof(S));                     // MS
    b += align128((size_t)T * (P + 4) * 4);                                 // Yf
    b += 2 * (size_t)T * 4;                                                 // dtv, cum
    return b;
  }

  __device__ Smem(unsigned char* base, int P, int N)
      : ldh(P + 4), ldhS(F32 ? P + 4 : P + PAD_S), ldN(N + PAD_S), ldPS(P + PAD_S),
        ldTS(T + PAD_S), ldPf(P + 4) {
    unsigned char* p = base;
    auto take = [&](size_t n) { unsigned char* r = p; p += align128(n); return r; };
    h = reinterpret_cast<float*>(take((size_t)N * ldh * 4));
    hS = F32 ? reinterpret_cast<S*>(h)  // fp32 operands need no rounded copy
             : reinterpret_cast<S*>(take((size_t)N * ldhS * sizeof(S)));
    xr = reinterpret_cast<S*>(take((size_t)XRaw<K, T>::ROWS * P * sizeof(S)));
    Cs = reinterpret_cast<S*>(take((size_t)T * ldN * sizeof(S)));
    Bs = reinterpret_cast<S*>(take((size_t)T * ldN * sizeof(S)));
    CB = reinterpret_cast<float*>(take((size_t)T * T * 4));
    xf = reinterpret_cast<float*>(take((size_t)T * P * 4));
    dxS = reinterpret_cast<S*>(take((size_t)T * ldPS * sizeof(S)));
    wdxS = reinterpret_cast<S*>(take((size_t)T * ldPS * sizeof(S)));
    MS = reinterpret_cast<S*>(take((size_t)T * ldTS * sizeof(S)));
    Yf = reinterpret_cast<float*>(take((size_t)T * ldPf * 4));
    dtv = reinterpret_cast<float*>(p);
    cum = dtv + T;
  }
};

// Shared memory of the pre-pass: the state, two stages of raw x rows and B,
// the conv output and w*dx.
template <typename S, int K>
struct StateSmem {
  static constexpr int T = Chunk<S>::T;
  static constexpr int PAD_S = sizeof(S) == 2 ? 8 : 4;
  float* h; S* xr[2]; S* Bs[2]; float* xf; S* wdxS; float* dtv; float* cum;
  int ldh, ldN, ldPS;

  static __host__ __device__ size_t bytes(int P, int N) {
    return align128((size_t)N * (P + 4) * 4) +
           2 * align128((size_t)XRaw<K, T>::ROWS * P * sizeof(S)) +
           2 * align128((size_t)T * (N + PAD_S) * sizeof(S)) + align128((size_t)T * P * 4) +
           align128((size_t)T * (P + PAD_S) * sizeof(S)) + 2 * (size_t)T * 4;
  }

  __device__ StateSmem(unsigned char* base, int P, int N)
      : ldh(P + 4), ldN(N + PAD_S), ldPS(P + PAD_S) {
    unsigned char* p = base;
    auto take = [&](size_t n) { unsigned char* r = p; p += align128(n); return r; };
    h = reinterpret_cast<float*>(take((size_t)N * ldh * 4));
    for (int i = 0; i < 2; ++i) xr[i] = reinterpret_cast<S*>(take((size_t)XRaw<K, T>::ROWS * P * sizeof(S)));
    for (int i = 0; i < 2; ++i) Bs[i] = reinterpret_cast<S*>(take((size_t)T * ldN * sizeof(S)));
    xf = reinterpret_cast<float*>(take((size_t)T * P * 4));
    wdxS = reinterpret_cast<S*>(take((size_t)T * ldPS * sizeof(S)));
    dtv = reinterpret_cast<float*>(p);
    cum = dtv + T;
  }
};

// Pointers of one (g, h): x columns, B / C columns of its group, dt.
template <typename S>
struct HeadPtrs {
  const S* x; const S* B; const S* C; const S* dt;
  __device__ HeadPtrs(const Params& p, int g, int hh, int grp)
      : x(static_cast<const S*>(p.x) + (long long)g * p.x_sg + (long long)hh * p.P),
        B(static_cast<const S*>(p.B) + (long long)g * p.b_sg + (long long)grp * p.N),
        C(static_cast<const S*>(p.C) + (long long)g * p.c_sg + (long long)grp * p.N),
        dt(static_cast<const S*>(p.dt) + (long long)g * p.dt_sg) {}
};

// The pre-pass: per (g, h, segment), every segment but the one the scan
// leaves last, the segment's state from a zero state, h <- exp(sum a) h +
// B^T (exp(sum a - cum) dt x) per chunk, and its sum of a (fp32).
template <typename S, int K>
__global__ void __launch_bounds__(NTHREADS) ssd_fwd_state_kernel(const Params p) {
  constexpr int T = Chunk<S>::T;
  constexpr int E = T / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int P = p.P, N = p.N, H = p.H, L = p.L, S_ = p.S;
  StateSmem<S, K> sm(smem_raw, P, N);
  const bool rev = p.reverse != 0;
  const int nc = (L + T - 1) / T;
  // blocks (g, scan position qq < S-1, h), heads of one segment side by side
  const int hh = blockIdx.x % H;
  const int qq = (blockIdx.x / H) % (S_ - 1);
  const int g = blockIdx.x / (H * (S_ - 1));
  const int s = Segment::at(qq, S_, rev);
  const Segment seg(s, S_, p.sc, nc, rev);
  const int grp = hh / (H / p.NG);
  const int tid = threadIdx.x;
  const HeadPtrs<S> ptr(p, g, hh, grp);
  const float A_h = p.A[hh];
  const float bias_h = p.dt_bias ? p.dt_bias[hh] : 0.f;
  const bool async = p.async != 0;

  for (int i = tid; i < N * P; i += NTHREADS) sm.h[(i / P) * sm.ldh + i % P] = 0.f;
  auto issue = [&](int c, int stage) {
    if (c >= 0) {
      const long long row0 = (long long)c * T;
      stage_rows<S>(sm.xr[stage], P, ptr.x, p.x_sl, XRaw<K, T>::row0(row0, rev),
                    XRaw<K, T>::ROWS, P, L, async);
      stage_rows<S>(sm.Bs[stage], sm.ldN, ptr.B, p.b_sl, row0, T, N, L, async);
    }
    cp_async_commit();
  };
  const int n = seg.hi - seg.lo;
  float dtr[E];
  issue(seg.scan_chunk(0, rev), 0);
  if (tid < 32) dt_fetch<S, T>(ptr.dt, p.dt_sl, hh, (long long)seg.scan_chunk(0, rev) * T, L, rev, dtr);
  float total_sum = 0.f;
  for (int i = 0; i < n; ++i) {
    const int c = seg.scan_chunk(i, rev), cur = i & 1;
    const long long row0 = (long long)c * T;
    const int cn = i + 1 < n ? seg.scan_chunk(i + 1, rev) : -1;
    issue(cn, cur ^ 1);  // that stage was last read in chunk i-1
    cp_async_wait<1>();
    __syncthreads();
    if (tid < 32) {
      dt_cum<T>(dtr, row0, L, bias_h, A_h, p.dt_softplus != 0, rev, sm.dtv, sm.cum);
      if (cn >= 0) dt_fetch<S, T>(ptr.dt, p.dt_sl, hh, (long long)cn * T, L, rev, dtr);
    }
    conv_x_staged<S, K, T>(sm.xr[cur], P, p.conv_w, p.conv_b, p.Wc, hh * P, row0, L, rev, sm.xf);
    __syncthreads();
    const float total = rev ? sm.cum[0] : sm.cum[T - 1];
    for_rc(T, P, [&](int j, int t, int pp) {
      sm.wdxS[t * sm.ldPS + pp] = from_f<S>(expf(total - sm.cum[t]) * sm.dtv[t] * sm.xf[j]);
    });
    __syncthreads();
    BlockMM<S, true, false>::run(sm.Bs[cur], sm.ldN, sm.wdxS, sm.ldPS, sm.h, sm.ldh, N, P, T,
                                 true, expf(total));
    total_sum += total;
    __syncthreads();
  }
  cp_async_wait<0>();
  const long long off = ((long long)g * H + hh) * S_ + s;
  for (int i = tid; i < N * P; i += NTHREADS)
    p.seg_h[off * N * P + i] = sm.h[(i / P) * sm.ldh + i % P];
  if (tid == 0) p.seg_a[off] = total_sum;
}

// The main pass: per (g, h, segment), the combine of the segments before it
// (scan order, fp32, from h_init), then the chunk walk, writing y, the
// carries and, in the segment the scan leaves last, hN.
template <typename S, int K>
__global__ void __launch_bounds__(NTHREADS) ssd_fwd_kernel(const Params p) {
  constexpr int T = Chunk<S>::T;
  constexpr int E = T / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int P = p.P, N = p.N, H = p.H, L = p.L, S_ = p.S;
  Smem<S, K> sm(smem_raw, P, N);
  const bool rev = p.reverse != 0;
  const int nc = (L + T - 1) / T;
  const int hh = blockIdx.x % H;
  const int qq = (blockIdx.x / H) % S_;
  const int g = blockIdx.x / (H * S_);
  const int s = Segment::at(qq, S_, rev);
  const Segment seg(s, S_, p.sc, nc, rev);
  const int grp = hh / (H / p.NG);
  const int tid = threadIdx.x;
  const bool async = p.async != 0;
  const HeadPtrs<S> ptr(p, g, hh, grp);
  S* y = static_cast<S*>(p.y) + (long long)g * L * H * P + (long long)hh * P;
  const long long y_sl = (long long)H * P;
  const float A_h = p.A[hh];
  const float D_h = p.D ? p.D[hh] : 0.f;
  const float bias_h = p.dt_bias ? p.dt_bias[hh] : 0.f;
  const long long state_off = ((long long)g * H + hh) * N * P;
  const float* cb = p.cb + ((long long)g * p.NG + grp) * nc * T * T;

  // the combine: the state entering this segment, in fp32
  const long long seg_off = ((long long)g * H + hh) * S_;
  for (int i = tid; i < N * P; i += NTHREADS) {
    float v = p.h_init ? p.h_init[state_off + i] : 0.f;
    for (int q = 0; q < seg.q; ++q) {
      const int j = Segment::at(q, S_, rev);
      v = expf(p.seg_a[seg_off + j]) * v + p.seg_h[(seg_off + j) * N * P + i];
    }
    sm.h[(i / P) * sm.ldh + i % P] = v;
  }

  // cp.async groups, committed in this order each chunk: x raw, C, CB, B
  auto issue_x = [&](int c) {
    if (c >= 0)
      stage_rows<S>(sm.xr, P, ptr.x, p.x_sl, XRaw<K, T>::row0((long long)c * T, rev),
                    XRaw<K, T>::ROWS, P, L, async);
    cp_async_commit();
  };
  auto issue_c = [&](int c) {
    if (c >= 0) stage_rows<S>(sm.Cs, sm.ldN, ptr.C, p.c_sl, (long long)c * T, T, N, L, async);
    cp_async_commit();
  };
  auto issue_cb = [&](int c) {
    if (c >= 0) stage_rows<float>(sm.CB, T, cb + (long long)c * T * T, T, 0, T, T, T, true);
    cp_async_commit();
  };
  auto issue_b = [&](int c) {
    if (c >= 0) stage_rows<S>(sm.Bs, sm.ldN, ptr.B, p.b_sl, (long long)c * T, T, N, L, async);
    cp_async_commit();
  };

  const int n = seg.hi - seg.lo;
  float dtr[E];
  {
    const int c0 = seg.scan_chunk(0, rev);
    issue_x(c0); issue_c(c0); issue_cb(c0); issue_b(c0);
    if (tid < 32) dt_fetch<S, T>(ptr.dt, p.dt_sl, hh, (long long)c0 * T, L, rev, dtr);
  }
  for (int i = 0; i < n; ++i) {
    const int c = seg.scan_chunk(i, rev);
    const int cn = i + 1 < n ? seg.scan_chunk(i + 1, rev) : -1;
    const long long row0 = (long long)c * T;

    // -- A: dt and its cumsum; the conv of the staged x rows; the state
    //    entering this chunk, rounded for C @ h, and the carry the backward
    //    reads (G, nc, H, N, P), indexed by array chunk c
    cp_async_wait<3>();  // x raw of c
    __syncthreads();
    if (tid < 32) {
      dt_cum<T>(dtr, row0, L, bias_h, A_h, p.dt_softplus != 0, rev, sm.dtv, sm.cum);
      if (cn >= 0) dt_fetch<S, T>(ptr.dt, p.dt_sl, hh, (long long)cn * T, L, rev, dtr);
    }
    conv_x_staged<S, K, T>(sm.xr, P, p.conv_w, p.conv_b, p.Wc, hh * P, row0, L, rev, sm.xf);
    S* car = p.carries ? static_cast<S*>(p.carries) + (((long long)g * nc + c) * H + hh) * N * P
                       : nullptr;
    if constexpr (!Smem<S, K>::F32) {
      for_rc(N, P, [&](int i2, int nn, int pp) {
        const S v = from_f<S>(sm.h[nn * sm.ldh + pp]);
        sm.hS[nn * sm.ldhS + pp] = v;
        if (car) car[i2] = v;
      });
    } else {
      if (car) for_rc(N, P, [&](int i2, int nn, int pp) { car[i2] = sm.h[nn * sm.ldh + pp]; });
    }
    cp_async_wait<2>();  // C of c
    __syncthreads();
    issue_x(cn);

    // -- B: dt x and exp(total - cum) dt x; Y = C h
    const float total = rev ? sm.cum[0] : sm.cum[T - 1];
    for_rc(T, P, [&](int i2, int t, int pp) {
      const float dx = sm.dtv[t] * sm.xf[i2];
      sm.dxS[t * sm.ldPS + pp] = from_f<S>(dx);
      sm.wdxS[t * sm.ldPS + pp] = from_f<S>(expf(total - sm.cum[t]) * dx);
    });
    BlockMM<S, false, false>::run(sm.Cs, sm.ldN, sm.hS, sm.ldhS, sm.Yf, sm.ldPf, T, P, N,
                                  false, 0.f);
    cp_async_wait<2>();  // CB of c
    __syncthreads();
    issue_c(cn);

    // -- C: M = mask(CB * exp(cum_t - cum_s)); Y = exp(cum) * Y + D x
    for (int i2 = tid; i2 < T * T; i2 += NTHREADS) {
      const int t = i2 / T, s2 = i2 % T;
      const bool keep = rev ? s2 >= t : s2 <= t;
      sm.MS[t * sm.ldTS + s2] = from_f<S>(keep ? sm.CB[i2] * expf(sm.cum[t] - sm.cum[s2]) : 0.f);
    }
    for_rc(T, P, [&](int i2, int t, int pp) {
      float& yv = sm.Yf[t * sm.ldPf + pp];
      yv = expf(sm.cum[t]) * yv + D_h * sm.xf[i2];
    });
    cp_async_wait<2>();  // B of c
    __syncthreads();
    issue_cb(cn);

    // -- D: Y += M @ dx;  h = exp(total) h + B^T @ wdx
    BlockMM<S, false, false>::run(sm.MS, sm.ldTS, sm.dxS, sm.ldPS, sm.Yf, sm.ldPf, T, P, T,
                                  true, 1.f);
    BlockMM<S, true, false>::run(sm.Bs, sm.ldN, sm.wdxS, sm.ldPS, sm.h, sm.ldh, N, P, T,
                                 true, expf(total));
    __syncthreads();
    issue_b(cn);

    // -- E: y; no barrier before the next chunk's staging and conv: they
    //    write no buffer read here, and Yf is next written after two barriers
    for_rc(T, P, [&](int, int t, int pp) {
      const long long r = row0 + t;
      if (r < L) y[r * y_sl + pp] = from_f<S>(sm.Yf[t * sm.ldPf + pp]);
    });
  }
  cp_async_wait<0>();
  if (seg.q == S_ - 1)
    for (int i = tid; i < N * P; i += NTHREADS)
      p.hN[state_off + i] = sm.h[(i / P) * sm.ldh + i % P];
}

// Sub-launches of one call, selected by `parts`: 1 the prep, 2 the
// pre-pass, 4 the main pass (7: the whole forward).
constexpr int PART_PREP = 1, PART_STATE = 2, PART_MAIN = 4;

template <typename S, int K>
cudaError_t launch(const Params& p, const PrepParams& pp, int G, int parts,
                   cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (parts & PART_PREP) {
    err = launch_prep<S, K>(pp, G, stream);
    if (err != cudaSuccess) return err;
  }
  if ((parts & PART_STATE) && p.S > 1) {
    const size_t smem = StateSmem<S, K>::bytes(p.P, p.N);
    err = set_smem(ssd_fwd_state_kernel<S, K>, smem);
    if (err != cudaSuccess) return err;
    ssd_fwd_state_kernel<S, K><<<G * p.H * (p.S - 1), NTHREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & PART_MAIN) {
    const size_t smem = Smem<S, K>::bytes(p.P, p.N);
    err = set_smem(ssd_fwd_kernel<S, K>, smem);
    if (err != cudaSuccess) return err;
    ssd_fwd_kernel<S, K><<<G * p.H * p.S, NTHREADS, smem, stream>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

template <typename S>
cudaError_t dispatch_k(const Params& p, const PrepParams& pp, int G, int K, int parts,
                       cudaStream_t stream) {
  switch (K) {
    case 0: return launch<S, 0>(p, pp, G, parts, stream);
    case 1: return launch<S, 1>(p, pp, G, parts, stream);
    case 2: return launch<S, 2>(p, pp, G, parts, stream);
    case 3: return launch<S, 3>(p, pp, G, parts, stream);
    case 4: return launch<S, 4>(p, pp, G, parts, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(int dtype, Params& p, PrepParams& pp, int G, int K, int parts,
                cudaStream_t s) {
  const int T = dtype == 1 ? Chunk<__nv_bfloat16>::T : Chunk<float>::T;
  const int nc = (p.L + T - 1) / T;
  p.sc = (nc + p.S - 1) / p.S;
  const size_t es = dtype == 1 ? 2 : 4;
  p.async = aligned16(p.x, p.x_sg, p.x_sl, es) && aligned16(p.B, p.b_sg, p.b_sl, es) &&
            aligned16(p.C, p.c_sg, p.c_sl, es);
  return dtype == 1 ? dispatch_k<__nv_bfloat16>(p, pp, G, K, parts, s)
       : dtype == 0 ? dispatch_k<float>(p, pp, G, K, parts, s)
                    : cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. carries may be null (no backward to
// feed). Workspaces: bc (G, L, 2*NG*N) storage dtype, cb (G, NG, nc, T, T),
// seg_h (G, H, S, N, P) and seg_a (G, H, S) fp32. S: segments per (g, h).
// parts: which sub-launches run (7: all). Returns the cudaError_t.
extern "C" int ssd_fused_fwd(
    int dtype,
    const void* xBC, long long xbc_sg, long long xbc_sl,
    const void* dt, long long dt_sg, long long dt_sl,
    const void* A, const void* D, const void* dt_bias,
    const void* conv_w, const void* conv_b, const void* h_init,
    void* y, void* hN, void* carries,
    void* bc, void* cb, void* seg_h, void* seg_a,
    int G, int L, int H, int P, int NG, int N, int K, int S,
    int dt_softplus, int reverse, int parts, void* stream) {
  const int T = dtype == 1 ? Chunk<__nv_bfloat16>::T : Chunk<float>::T;
  if (!valid_shape(G, L, H, P, NG, N, S, T) || K < 1) return (int)cudaErrorInvalidValue;
  const int Wc = H * P + 2 * NG * N;
  Params p = {};
  p.x = xBC; p.x_sg = xbc_sg; p.x_sl = xbc_sl;
  p.B = bc; p.b_sg = (long long)L * 2 * NG * N; p.b_sl = 2 * NG * N;
  p.C = static_cast<const char*>(bc) + (size_t)NG * N * (dtype == 1 ? 2 : 4);
  p.c_sg = p.b_sg; p.c_sl = p.b_sl;
  p.dt = dt; p.dt_sg = dt_sg; p.dt_sl = dt_sl;
  p.A = static_cast<const float*>(A);
  p.D = static_cast<const float*>(D);
  p.dt_bias = static_cast<const float*>(dt_bias);
  p.conv_w = static_cast<const float*>(conv_w);
  p.conv_b = static_cast<const float*>(conv_b);
  p.h_init = static_cast<const float*>(h_init);
  p.cb = static_cast<const float*>(cb);
  p.seg_h = static_cast<float*>(seg_h); p.seg_a = static_cast<float*>(seg_a);
  p.y = y; p.hN = static_cast<float*>(hN); p.carries = carries;
  p.L = L; p.H = H; p.P = P; p.NG = NG; p.N = N; p.Wc = Wc; p.S = S;
  p.dt_softplus = dt_softplus; p.reverse = reverse;
  PrepParams pp = {};
  pp.xBC = xBC; pp.xbc_sg = xbc_sg; pp.xbc_sl = xbc_sl;
  pp.conv_w = p.conv_w; pp.conv_b = p.conv_b; pp.bc = bc; pp.cb = static_cast<float*>(cb);
  pp.L = L; pp.H = H; pp.P = P; pp.NG = NG; pp.N = N; pp.Wc = Wc; pp.reverse = reverse;
  return (int)run(dtype, p, pp, G, K, parts, static_cast<cudaStream_t>(stream));
}

// The unfused forward (K = 0): x (G, L, H*P), B and C (G, L, NG*N) and dt
// (G, L, H), each through its own batch and row strides (unit column
// stride); all three sub-launches. Workspaces cb, seg_h, seg_a and the rest
// as `ssd_fused_fwd`.
extern "C" int ssd_fwd(
    int dtype,
    const void* x, long long x_sg, long long x_sl,
    const void* B, long long b_sg, long long b_sl,
    const void* C, long long c_sg, long long c_sl,
    const void* dt, long long dt_sg, long long dt_sl,
    const void* A, const void* D, const void* dt_bias, const void* h_init,
    void* y, void* hN, void* carries, void* cb, void* seg_h, void* seg_a,
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
  p.h_init = static_cast<const float*>(h_init);
  p.cb = static_cast<const float*>(cb);
  p.seg_h = static_cast<float*>(seg_h); p.seg_a = static_cast<float*>(seg_a);
  p.y = y; p.hN = static_cast<float*>(hN); p.carries = carries;
  p.L = L; p.H = H; p.P = P; p.NG = NG; p.N = N; p.Wc = 0; p.S = S;
  p.dt_softplus = dt_softplus; p.reverse = reverse;
  PrepParams pp = {};
  pp.B = B; pp.b_sg = b_sg; pp.b_sl = b_sl;
  pp.C = C; pp.c_sg = c_sg; pp.c_sl = c_sl;
  pp.cb = static_cast<float*>(cb);
  pp.L = L; pp.H = H; pp.P = P; pp.NG = NG; pp.N = N; pp.reverse = reverse;
  return (int)run(dtype, p, pp, G, 0, PART_PREP | PART_STATE | PART_MAIN,
                  static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of each sub-launch (which: 0 the prep, 1 the
// pre-pass, 2 the main pass) at K = 0 or 4, for the build report; -1 for
// anything else.
extern "C" long long ssd_fused_fwd_smem(int dtype, int K, int P, int N, int which) {
  auto of = [&](auto s, auto k) -> long long {
    using S = decltype(s);
    constexpr int KK = decltype(k)::value;
    return which == 0 ? (long long)PrepSmem<S>::bytes(N)
         : which == 1 ? (long long)StateSmem<S, KK>::bytes(P, N)
         : which == 2 ? (long long)Smem<S, KK>::bytes(P, N) : -1;
  };
  using K0 = std::integral_constant<int, 0>;
  using K4 = std::integral_constant<int, 4>;
  if (K != 0 && K != 4) return -1;
  if (dtype == 1) return K ? of(__nv_bfloat16(), K4()) : of(__nv_bfloat16(), K0());
  if (dtype == 0) return K ? of(0.f, K4()) : of(0.f, K0());
  return -1;
}
