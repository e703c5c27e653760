// K5: backward of K1 (pooled attention with decomposed (T, H, W) rel-pos
// bias and residual pooling): dq, dk, dv and drel from the output gradient g,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel diff_sal_tpu/ops/attention.py:761 _fba2_bwd (body
// _attn_v2_bwd_kernel :697). Per (batch, head), with s = (q * scale) k^T +
// bias and p = exp(s - lse) recomputed in f32 from the row logsumexp `lse`
// that the forward (csrc/attention.cu) saved:
//   dv = p_lo^T g,  dp = g v^T,  ds = p * (dp - delta),  delta = rowsum(dp * p),
//   dq = (ds_lo k) * scale (+ g when residual),  dk = (ds_lo^T q) * scale,
//   drel[l, t] = sum_{j >= 1, t(j) = t} ds[l, j]  (and likewise for h, w),
// where p_lo and ds_lo are p and ds rounded to bf16, as the TPU kernel feeds
// them to its products; every product accumulates in f32.
//
// K12's backward is the same template on MViT's token-concat layout. It
// replaces the TPU kernel diff_sal_tpu/ops/attention.py:280 _fba_bwd (body
// _attn_bwd_kernel :193): q, k, v, g (B*heads, L, D) bf16 with the cls query
// at row 0 inside the tiles, the bias terms as three f32 tensors read and
// their gradients written in f32, and dq's residual on rows >= 1 only. The
// rel layouts go through RelIn/RelOut (per-part pointers and row strides).
//
// Bound by operations on the H100: five (Lq, Lk, D) products per head
// against one pass over q, k, v, rel, g and the outputs. Delta is the TPU's
// rowsum(dp * p), not FlashAttention's rowsum(g * o): o (the output before
// the residual) exists only rounded to bf16 inside out = o + q, and dp -
// delta cancels, so that choice would move dq, dk and drel off the plain
// versions' rounding points; it costs one more S and dP pass over the keys.
// Four kernels, all on the caller's stream:
//  0. tables: for every 64-key tile, each key's three bias indices (t, kt+h,
//     kt+kh+w into a raw rel row; the cls key reads zeros, keys past Lk read
//     -inf) and the one-hot E tile (key -> t, kt + h, kt + kh + w) in the
//     shared-memory layout of a wgmma B operand. They depend on the key grid
//     only and reach shared memory by bulk copies.
// Each of kernels 1 and 2 is one warpgroup per CTA, two CTAs per SM (so
// ptxas may give a thread up to 255 registers: the accumulators stay in
// registers without spilling). Its thread 0 issues every load one tile
// ahead into a ring of STAGES mbarrier-guarded buffers (TMA for the 64-row
// tiles, bulk copies for the tables); a CTA barrier before each tile tells
// it which buffer is free. The other CTA on the SM fills the gaps that the
// waits for each product batch leave.
//  1. q-major, one CTA per (batch, head, 64 query rows): TMA loads Q and G
//     once and streams the K and V tiles with each tile's E and key
//     indices; S = Q K^T and dP = G V^T with wgmma (SS, bf16 in, f32 in
//     registers), add the bias from a per-row table of the raw rel terms
//     in shared memory and take p = exp(s - lse) in registers. Pass 1 over
//     the key tiles sums delta; pass 2 forms dS in registers and issues dQ +=
//     dS_lo K (RS wgmma, K MN-major) and dRel += dS E^T as two RS wgmmas, dS
//     split into bf16 hi + lo parts (~16 mantissa bits of the f32 dS, f32
//     accumulation), as the TPU kernel sums drel by a product with the
//     one-hot matrix. dq and drel are written once. Between the passes the
//     CTA writes each row's raw rel terms, lse and delta as one padded f32
//     row ("relp") for kernel 2.
//  2. k-major, one CTA per (batch, head, 64 keys, query split): TMA loads K
//     and V once and streams Q, G and the relp rows of each query tile
//     through a ring; S^T = K Q^T and dP^T = V G^T (SS), then dV += P_lo^T G
//     and dK += dS_lo^T Q (RS). Where Lk is small (673 keys at MViT block 0)
//     the query range is split so the grid fills the card; each split writes
//     its f32 partial sums to a workspace.
//  3. the splits summed in a fixed order, cast to dk's and dv's dtype.
// No atomics anywhere, so two runs on the same inputs give the same bits.
// TMA zero-fills rows past L, so nothing is padded in memory: padded query
// rows have zero q and g and contribute nothing; key columns past Lk get a
// -inf bias. Every mbarrier wait traps after ~16M spins, so a pipeline
// fault fails the launch instead of hanging. head_dim D is a template
// parameter (64, 96 or 128); the bias bins are padded to NP = 32, 48 or 128
// columns, the N of the dRel product. `bwd_plan` in ops/attention.py mirrors
// the shared-memory layouts.

#include "attention_bias.cuh"
#include "hopper.cuh"

namespace {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory one CTA may use
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64;  // rows of the consumer warpgroup: query rows (q-major) or keys (k-major)
constexpr int BN = 64;  // keys (q-major) or query rows (k-major) per tile
constexpr int NTHREADS = 128;  // one warpgroup; its thread 0 also issues every load
constexpr int STAGES = 2;      // ring buffers; two CTAs fit on an SM at MViT's shapes

// bias bins padded to the N of the dRel product
__host__ __device__ inline int pad_bins(int K) { return K <= 32 ? 32 : (K <= 48 ? 48 : 128); }
// floats per relp row: K raw terms, 0, -inf, lse, delta, padded to 16 bytes
__host__ __device__ inline int relp_cols(int K) { return (K + 4 + 3) / 4 * 4; }
// floats per row of the q-major kernel's rel table (odd: fewer bank conflicts)
__host__ __device__ inline int table_cols(int K) { return (K + 4) | 1; }

// Byte offsets into the (1024-aligned) dynamic shared memory. Mirrored by
// `bwd_plan` in ops/attention.py, which checks the totals against SMEM_MAX.
struct QSmem {
  int q, g, k, v, e, ktab, rel, bar, total;
};

__host__ __device__ inline QSmem q_layout(int D, int K) {
  const int NP = pad_bins(K);
  QSmem s;
  int off = 0;
  s.q = off;    off += BM * D * 2;
  s.g = off;    off += BM * D * 2;
  s.k = off;    off += STAGES * BN * D * 2;
  s.v = off;    off += STAGES * BN * D * 2;
  s.e = off;    off += STAGES * BN * NP * 2;
  s.ktab = off; off += STAGES * BN * 4;
  s.rel = off;  off += BM * table_cols(K) * 4;
  off = (off + 7) / 8 * 8;
  s.bar = off;  off += (STAGES + 1) * 8;  // one per stage, Q and G
  s.total = off + 1024;                       // room to align the base
  return s;
}

struct KSmem {
  int k, v, qs, q, g, rel, bar, total;
};

__host__ __device__ inline KSmem k_layout(int D, int K) {
  KSmem s;
  int off = 0;
  s.k = off;   off += BM * D * 2;
  s.v = off;   off += BM * D * 2;
  s.qs = off;  off += BN * D * 2;  // the current Q tile scaled and rounded
  s.q = off;   off += STAGES * BN * D * 2;
  s.g = off;   off += STAGES * BN * D * 2;
  s.rel = off; off += STAGES * BN * relp_cols(K) * 4;
  s.bar = off; off += (STAGES + 1) * 8;  // one per stage, K and V
  s.total = off + 1024;
  return s;
}

// -------------------------------------------------------------- helpers ---

// a = bf16(x) (two values per register) and b = bf16(x - a): the hi and lo
// parts of two f32 values
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// X = A B^T for two 64-row operands at shared addresses a and b (64-byte
// swizzled, K-major, D/32 column chunks of 64 rows each): issued, not
// committed. scale_d = 0 on the first k-step overwrites X.
template <int D>
__device__ __forceinline__ void issue_abt(float (&x)[BN / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t ko = (kk >> 1) * BN * 64 + (kk & 1) * 32;
    wgmma_ss<BN>(x, sw64_desc(a + ko, 16, 512), sw64_desc(b + ko, 16, 512), kk > 0);
  }
}

// X += A B for A (64 x 64) from registers and B the 64-row tile at shared
// address b read MN-major (its D columns as N): issued, not committed
template <int D>
__device__ __forceinline__ void issue_ab(float (&x)[D / 2], const uint32_t (&a)[BN / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    Wg<D>::template rs<1>(x, a[kk], sw64_desc(b + kk * 1024, BN * 64, 512));
}

// ---------------------------------------------------------------- params ---

template <typename R>
struct QParams {
  RelIn<R> rel;
  RelOut<R> drel;
  const bf16* g;          // for dq's residual term
  bf16* dq;
  const float* lse;       // (batches * H, Lq), from the forward
  float* relp;            // (batches * H, Lq, KP) out: raw rel terms, 0, -inf, lse, delta
  const unsigned char* e_all;  // the tables kernel's E tiles
  const int* ktab_all;         // and key indices
  int Lq, Lk, H, kt, kh, kw, res_from, ntiles, qtiles;
  float scale_q, scale;
};

struct KParams {
  float* work;  // [2][splits][batches][Lk][H * D] f32 partial dk (scaled), dv
  int B, Lq, Lk, H, kt, kh, kw, ktiles, splits, per;
  float scale_q, scale;
};

// ------------------------------------------------------ kernel 0: tables ---

// E tile layout (a K-major B operand without swizzle, N = NP bins, K = 64
// keys): key group kk of 16 at kk * NP * 32 bytes, bin group of 8 at 256,
// key half of 8 at 128, bin at 16 bytes, key at 2
__global__ void bwd_tables_kernel(unsigned char* __restrict__ e_all, int* __restrict__ ktab_all,
                                  int ntiles, int Lk, int kt, int kh, int kw) {
  const int K = kt + kh + kw, NP = pad_bins(K);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < ntiles * BN; i += stride)
    ktab_all[i] = key_index(i, Lk, kt, kh, kw);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < ntiles * NP * 8; i += stride) {
    const int tile = i / (NP * 8), rem = i - tile * NP * 8, n = rem >> 3, grp = rem & 7;
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t v = 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = tile * BN + grp * 8 + 2 * u + half;
        const int e = key_index(j, Lk, kt, kh, kw);
        const bool one = n < K && j > 0 && j < Lk &&
                         ((e & 1023) == n || ((e >> 10) & 1023) == n || (e >> 20) == n);
        v |= (one ? 0x3F80u : 0u) << (16 * half);  // bf16 1.0
      }
      w[u] = v;
    }
    const size_t off = (size_t)tile * BN * NP * 2 + (grp >> 1) * (NP * 32) + (n >> 3) * 256 +
                       (grp & 1) * 128 + (n & 7) * 16;
    *reinterpret_cast<uint4*>(e_all + off) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}


// --------------------------------------------- kernel 1: dq, drel, delta ---

// Key tile `it` of the two passes over the keys (E in the second only)
// into ring slot it % STAGES, completing on that slot's barrier.
template <int D, int NP, typename R>
__device__ __forceinline__ void dq_load(const QParams<R>& p, const QSmem& L, uint32_t sbase,
                                        uint32_t bars, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int b, int h, int it) {
  constexpr int CH = D / 32;
  const int s = it % STAGES, i = it < p.ntiles ? it : it - p.ntiles, col = h * D;
  const int tile_e = BN * NP * 2;
  const uint32_t full = bars + 8 * s, off = s * BN * D * 2;
  const bool with_e = it >= p.ntiles;
  mbar_expect_tx(full, 2 * BN * D * 2 + BN * 4 + (with_e ? tile_e : 0));
  for (int c = 0; c < CH; ++c) {
    tma_load(sbase + L.k + off + c * BN * 64, tk, full, col + 32 * c, i * BN, b);
    tma_load(sbase + L.v + off + c * BN * 64, tv, full, col + 32 * c, i * BN, b);
  }
  bulk_load(sbase + L.ktab + s * BN * 4, p.ktab_all + i * BN, BN * 4, full);
  if (with_e) bulk_load(sbase + L.e + s * tile_e, p.e_all + (size_t)i * tile_e, tile_e, full);
}

// One q-major CTA, query rows [q0, q0 + 64) of (batch b, head h); t is the
// thread's index. Thread 0 keeps the next key tile's loads in flight.
template <int D, int NP, typename R>
__device__ __forceinline__ void dq_consumer(const QParams<R>& p, unsigned char* smem,
                                            uint32_t sbase, const QSmem& L, uint32_t bars,
                                            const CUtensorMap* tk, const CUtensorMap* tv, int b,
                                            int h, int q0, int t) {
  constexpr int CH = D / 32;
  const int K = p.kt + p.kh + p.kw, LD = table_cols(K), KP = relp_cols(K);
  const int warp = t >> 5, lane = t & 31;
  const int bh = b * p.H + h;
  float* rel = reinterpret_cast<float*>(smem + L.rel);

  // raw rel rows of the 64 query rows: [K terms | 0 | -inf | lse | delta];
  // rows past Lq hold zeros. Eight loads in flight per thread.
  constexpr int RB = 8;
  for (int i0 = t; i0 < BM * K; i0 += 128 * RB) {
    float x[RB];
    int dst[RB];
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const int i = i0 + u * 128, r = i / K, c = i - r * K, row = q0 + r;
      int cc;
      const int part = rel_part(c, p.kt, p.kh, cc);
      dst[u] = i < BM * K ? r * LD + c : -1;
      x[u] = i < BM * K && row < p.Lq
                 ? to_f32(p.rel.p[part][((size_t)b * p.Lq + row) * p.rel.ld[part] +
                                        h * p.rel.hs + cc])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < RB; ++u)
      if (dst[u] >= 0) rel[dst[u]] = x[u];
  }
  if (t < BM) {
    rel[t * LD + K] = 0.f;
    rel[t * LD + K + 1] = -INFINITY;
  }
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int cb = 2 * (lane & 3);           // and columns cb, cb + 1 of each 8
  const int row0 = q0 + r0, row1 = row0 + 8;
  const float lse0 = row0 < p.Lq ? p.lse[(size_t)bh * p.Lq + row0] : 0.f;
  const float lse1 = row1 < p.Lq ? p.lse[(size_t)bh * p.Lq + row1] : 0.f;
  const float l0 = lse0 * LOG2E, l1 = lse1 * LOG2E;

  // Q scaled in place and rounded to bf16, as the forward does
  mbar_wait(bars + 8 * STAGES, 0);
  for (int i = t; i < CH * 256; i += 128) {
    uint4* ptr = reinterpret_cast<uint4*>(smem + L.q + i * 16);
    uint4 vec = *ptr;
    bf16* e = reinterpret_cast<bf16*>(&vec);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * p.scale_q);
    *ptr = vec;
  }
  fence_async_smem();
  __syncthreads();

  const float* rel0 = rel + r0 * LD;
  const float* rel1 = rel0 + 8 * LD;
  const uint32_t qa = sbase + L.q, ga = sbase + L.g;
  const uint32_t full = bars;
  // before tile `it`: every thread is done with tile it - 1, so its ring
  // slot takes tile it - 1 + STAGES
  auto next = [&](int it) {
    __syncthreads();
    if (t == 0 && it >= 1 && it - 1 + STAGES < 2 * p.ntiles)
      dq_load<D, NP, R>(p, L, sbase, bars, tk, tv, b, h, it - 1 + STAGES);
  };
  float sc[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;

  // pass 1: delta = rowsum(dp * p)
  float d0 = 0.f, d1 = 0.f;
  for (int i = 0; i < p.ntiles; ++i) {
    const int s = i % STAGES;
    next(i);
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    reg_fence(sc);
    reg_fence(dp);
    wg_fence();
    issue_abt<D>(sc, qa, sbase + L.k + s * BN * D * 2);
    issue_abt<D>(dp, ga, sbase + L.v + s * BN * D * 2);
    wg_commit();
    wg_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    const int* kt_tile = reinterpret_cast<const int*>(smem + L.ktab + s * BN * 4) + cb;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int2 e = *reinterpret_cast<const int2*>(kt_tile + 8 * j);
      d0 += ex2(fmaf(sc[4 * j + 0] + bias_at(rel0, e.x), LOG2E, -l0)) * dp[4 * j + 0];
      d0 += ex2(fmaf(sc[4 * j + 1] + bias_at(rel0, e.y), LOG2E, -l0)) * dp[4 * j + 1];
      d1 += ex2(fmaf(sc[4 * j + 2] + bias_at(rel1, e.x), LOG2E, -l1)) * dp[4 * j + 2];
      d1 += ex2(fmaf(sc[4 * j + 3] + bias_at(rel1, e.y), LOG2E, -l1)) * dp[4 * j + 3];
    }
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);

  // the relp rows for kernel 2: raw terms, 0, -inf, lse, delta, zero padding
  if ((lane & 3) == 0) {
    rel[r0 * LD + K + 2] = lse0;
    rel[r0 * LD + K + 3] = d0;
    rel[(r0 + 8) * LD + K + 2] = lse1;
    rel[(r0 + 8) * LD + K + 3] = d1;
  }
  __syncthreads();
  for (int i = t; i < BM * KP; i += 128) {
    const int r = i / KP, c = i - r * KP, row = q0 + r;
    if (row < p.Lq) p.relp[((size_t)bh * p.Lq + row) * KP + c] = c < K + 4 ? rel[r * LD + c] : 0.f;
  }

  // pass 2: ds = p (dp - delta); dq += ds_lo k; drel += (ds_hi + ds_lo) E^T
  float dq[D / 2], dr[NP / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) dr[i] = 0.f;
  uint32_t hi[BN / 16][4], lo[BN / 16][4];
  for (int i = 0; i < p.ntiles; ++i) {
    const int it = p.ntiles + i, s = it % STAGES;
    next(it);
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
    reg_fence(sc);
    reg_fence(dp);
    wg_fence();
    issue_abt<D>(sc, qa, sbase + L.k + s * BN * D * 2);
    issue_abt<D>(dp, ga, sbase + L.v + s * BN * D * 2);
    wg_commit();
    wg_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    const int* kt_tile = reinterpret_cast<const int*>(smem + L.ktab + s * BN * 4) + cb;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int2 e = *reinterpret_cast<const int2*>(kt_tile + 8 * j);
      const float a0 = ex2(fmaf(sc[4 * j] + bias_at(rel0, e.x), LOG2E, -l0)) * (dp[4 * j] - d0);
      const float a1 =
          ex2(fmaf(sc[4 * j + 1] + bias_at(rel0, e.y), LOG2E, -l0)) * (dp[4 * j + 1] - d0);
      const float a2 =
          ex2(fmaf(sc[4 * j + 2] + bias_at(rel1, e.x), LOG2E, -l1)) * (dp[4 * j + 2] - d1);
      const float a3 =
          ex2(fmaf(sc[4 * j + 3] + bias_at(rel1, e.y), LOG2E, -l1)) * (dp[4 * j + 3] - d1);
      split2(a0, a1, hi[j >> 1][(j & 1) * 2 + 0], lo[j >> 1][(j & 1) * 2 + 0]);
      split2(a2, a3, hi[j >> 1][(j & 1) * 2 + 1], lo[j >> 1][(j & 1) * 2 + 1]);
    }
    const uint32_t eb = sbase + L.e + s * BN * NP * 2;
    reg_fence(dq);
    reg_fence(dr);
    wg_fence();
    issue_ab<D>(dq, hi, sbase + L.k + s * BN * D * 2);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t de = plain_desc(eb + kk * NP * 32, 128, 256);
      Wg<NP>::template rs<0>(dr, hi[kk], de);
      Wg<NP>::template rs<0>(dr, lo[kk], de);
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(dq);
    reg_fence(dr);
    reg_fence(hi);
    reg_fence(lo);
  }

  // epilogue: dq * scale (+ g), one rounding; drel in its dtype
  const int HD = p.H * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= p.Lq) continue;
    const size_t base = ((size_t)b * p.Lq + row) * HD + h * D + cb;
    const bool res = row >= p.res_from;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float x0 = dq[4 * j + 2 * half] * p.scale, x1 = dq[4 * j + 2 * half + 1] * p.scale;
      if (res) {
        const __nv_bfloat162 gg = *reinterpret_cast<const __nv_bfloat162*>(p.g + base + 8 * j);
        x0 += __low2float(gg);
        x1 += __high2float(gg);
      }
      *reinterpret_cast<__nv_bfloat162*>(p.dq + base + 8 * j) = __floats2bfloat162_rn(x0, x1);
    }
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + cb + e;
        if (c >= K) continue;
        int cc;
        const int part = rel_part(c, p.kt, p.kh, cc);
        from_f32(p.drel.p[part] + ((size_t)b * p.Lq + row) * p.drel.ld[part] + h * p.drel.hs + cc,
                 dr[4 * j + 2 * half + e]);
      }
    }
  }
}

template <int D, int NP, typename R>
__global__ void __launch_bounds__(NTHREADS, 2)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                  const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const QParams<R> p) {
  constexpr int CH = D / 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const QSmem L = q_layout(D, p.kt + p.kh + p.kw);
  // mbarriers: one per ring slot, then Q and G
  const uint32_t bars = sbase + L.bar, qgbar = bars + 8 * STAGES;
  const int bh = blockIdx.x / p.qtiles, q0 = (blockIdx.x - bh * p.qtiles) * BM;
  const int b = bh / p.H, h = bh - b * p.H;

  if (threadIdx.x == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // Q, G and the first key tiles
    const int col = h * D;
    mbar_expect_tx(qgbar, 2 * BM * D * 2);
    for (int c = 0; c < CH; ++c) {
      tma_load(sbase + L.q + c * BM * 64, &tq, qgbar, col + 32 * c, q0, b);
      tma_load(sbase + L.g + c * BM * 64, &tg, qgbar, col + 32 * c, q0, b);
    }
    for (int it = 0; it < STAGES && it < 2 * p.ntiles; ++it)
      dq_load<D, NP, R>(p, L, sbase, bars, &tk, &tv, b, h, it);
  }
  dq_consumer<D, NP, R>(p, smem, sbase, L, bars, &tk, &tv, b, h, q0, threadIdx.x);
}

// ------------------------------------------------- kernel 2: dk, dv parts ---

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
    bwd_dkv_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                   const __grid_constant__ CUtensorMap trel, const KParams p) {
  constexpr int CH = D / 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const int K = p.kt + p.kh + p.kw, KP = relp_cols(K);
  const KSmem L = k_layout(D, K);
  // mbarriers: one per ring slot, then K and V
  const uint32_t bars = sbase + L.bar, full = bars, kvbar = bars + 8 * STAGES;
  const int per_bh = p.splits * p.ktiles;
  const int bh = blockIdx.x / per_bh, rem = blockIdx.x - bh * per_bh;
  const int split = rem / p.ktiles, kb = rem - split * p.ktiles;
  const int b = bh / p.H, h = bh - b * p.H;
  const int n_qt = (p.Lq + BN - 1) / BN, qt0 = split * p.per;
  const int n = max(0, min(n_qt, qt0 + p.per) - qt0);  // query tiles of this split

  // query tile `it` of this split (Q, G and its relp rows) into ring slot
  // it % STAGES, completing on that slot's barrier
  const int col = h * D, rel_bytes = BN * KP * 4;
  auto load = [&](int it) {
    const int s = it % STAGES, q0 = (qt0 + it) * BN;
    const uint32_t off = s * BN * D * 2;
    mbar_expect_tx(full + 8 * s, 2 * BN * D * 2 + rel_bytes);
    for (int c = 0; c < CH; ++c) {
      tma_load(sbase + L.q + off + c * BN * 64, &tq, full + 8 * s, col + 32 * c, q0, b);
      tma_load(sbase + L.g + off + c * BN * 64, &tg, full + 8 * s, col + 32 * c, q0, b);
    }
    tma_load(sbase + L.rel + s * rel_bytes, &trel, full + 8 * s, 0, q0, bh);
  };
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(bars + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (t == 0) {  // K and V of this key block, and the first query tiles
    mbar_expect_tx(kvbar, 2 * BM * D * 2);
    for (int c = 0; c < CH; ++c) {
      tma_load(sbase + L.k + c * BM * 64, &tk, kvbar, col + 32 * c, kb * BM, b);
      tma_load(sbase + L.v + c * BM * 64, &tv, kvbar, col + 32 * c, kb * BM, b);
    }
    for (int it = 0; it < STAGES && it < n; ++it) load(it);
  }

  const int r0 = warp * 16 + (lane >> 2);  // this thread's keys: r0 and r0 + 8 of the block
  const int cb = 2 * (lane & 3);           // and query columns cb, cb + 1 of each 8
  const int e0 = key_index(kb * BM + r0, p.Lk, p.kt, p.kh, p.kw);
  const int e1 = key_index(kb * BM + r0 + 8, p.Lk, p.kt, p.kh, p.kw);
  const uint32_t ka = sbase + L.k, va = sbase + L.v, qs = sbase + L.qs;
  float dk[D / 2], dv[D / 2], sc[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
  uint32_t pa[BN / 16][4], da[BN / 16][4];
  mbar_wait(kvbar, 0);

  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES;
    const uint32_t qb = sbase + L.q + s * BN * D * 2, gb = sbase + L.g + s * BN * D * 2;
    const float* rp = reinterpret_cast<const float*>(smem + L.rel + s * BN * KP * 4);
    // every thread is done with tile it - 1 (its products read the scaled
    // copy and its ring slot, which now takes tile it - 1 + STAGES)
    __syncthreads();
    if (t == 0 && it >= 1 && it - 1 + STAGES < n) load(it - 1 + STAGES);
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
    // this tile's Q scaled and rounded to bf16 for S (dK takes it unscaled)
    for (int i = t; i < CH * 256; i += 128) {
      uint4 vec = *reinterpret_cast<const uint4*>(smem + L.q + s * BN * D * 2 + i * 16);
      bf16* e = reinterpret_cast<bf16*>(&vec);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * p.scale_q);
      *reinterpret_cast<uint4*>(smem + L.qs + i * 16) = vec;
    }
    fence_async_smem();
    __syncthreads();
    reg_fence(sc);
    reg_fence(dp);
    wg_fence();
    issue_abt<D>(sc, ka, qs);  // S^T = K (q * scale)^T
    issue_abt<D>(dp, va, gb);  // dP^T = V G^T
    wg_commit();
    wg_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float* ra = rp + (8 * j + cb) * KP;  // query column 8 j + cb
      const float* rb = ra + KP;                 // and the next
      const float la = ra[K + 2] * LOG2E, lb = rb[K + 2] * LOG2E, dla = ra[K + 3],
                  dlb = rb[K + 3];
      const float p0 = ex2(fmaf(sc[4 * j + 0] + bias_at(ra, e0), LOG2E, -la));
      const float p1 = ex2(fmaf(sc[4 * j + 1] + bias_at(rb, e0), LOG2E, -lb));
      const float p2 = ex2(fmaf(sc[4 * j + 2] + bias_at(ra, e1), LOG2E, -la));
      const float p3 = ex2(fmaf(sc[4 * j + 3] + bias_at(rb, e1), LOG2E, -lb));
      pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      da[j >> 1][(j & 1) * 2 + 0] =
          pack_bf16(p0 * (dp[4 * j + 0] - dla), p1 * (dp[4 * j + 1] - dlb));
      da[j >> 1][(j & 1) * 2 + 1] =
          pack_bf16(p2 * (dp[4 * j + 2] - dla), p3 * (dp[4 * j + 3] - dlb));
    }
    reg_fence(dk);
    reg_fence(dv);
    wg_fence();
    issue_ab<D>(dv, pa, gb);  // dV += P_lo^T G
    issue_ab<D>(dk, da, qb);  // dK += dS_lo^T Q
    wg_commit();
    wg_wait<0>();
    reg_fence(dk);
    reg_fence(dv);
    reg_fence(pa);
    reg_fence(da);
  }

  // partial sums of this split -> work[0 (dk) | 1 (dv)][split][b][key][h * D + d]
  const int HD = p.H * D;
  const size_t plane = (size_t)p.splits * p.B * p.Lk * HD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kb * BM + r0 + 8 * half;
    if (key >= p.Lk) continue;
    float* dst = p.work + ((size_t)split * p.B + b) * p.Lk * HD + (size_t)key * HD + h * D + cb;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(dk[4 * j + 2 * half] * p.scale, dk[4 * j + 2 * half + 1] * p.scale);
      *reinterpret_cast<float2*>(dst + plane + 8 * j) =
          make_float2(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
    }
  }
}

// kernel 3: dk, dv = sum over splits of the partials, in split order
__global__ void bwd_reduce_kernel(const float* __restrict__ work, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, long long n, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < splits; ++s) {
      sk += work[(size_t)s * n + i];
      sv += work[((size_t)splits + s) * n + i];
    }
    dk[i] = __float2bfloat16(sk);
    dv[i] = __float2bfloat16(sv);
  }
}

// --------------------------------------------------------------- host ---

// (batches * heads, Lq, KP) f32 relp rows, boxes of KP columns x 64 rows x
// 1, no swizzle; rows past Lq read as zeros
bool make_relp_map(CUtensorMap* map, const void* ptr, int BH, int Lq, int KP) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)KP, (cuuint64_t)Lq, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)KP * 4, (cuuint64_t)Lq * KP * 4};
  const cuuint32_t box[3] = {(cuuint32_t)KP, (cuuint32_t)BN, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename KernelT>
cudaError_t set_smem(KernelT kernel, int bytes, int& done) {
  if (bytes <= done) return cudaSuccess;  // the attribute only grows; set it once per size
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = bytes;
  return err;
}

struct Args {
  const void *q, *k, *v, *g, *lse;
  void *dq, *dk, *dv, *relp, *e_all, *ktab, *work;
  int B, Lq, Lk, H, D, kt, kh, kw, splits;
  float scale_q, scale;
  cudaStream_t stream;
};

template <int D, int NP, typename R>
int launch_dq(const Args& a, const QParams<R>& p, const CUtensorMap& tq, const CUtensorMap& tg,
              const CUtensorMap& tk, const CUtensorMap& tv, int smem) {
  static int done = 0;
  cudaError_t err = set_smem(bwd_dq_kernel<D, NP, R>, smem, done);
  if (err != cudaSuccess) return (int)err;
  bwd_dq_kernel<D, NP, R><<<a.B * a.H * p.qtiles, NTHREADS, smem, a.stream>>>(tq, tg, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a, const KParams& p, const CUtensorMap& tk, const CUtensorMap& tv,
               const CUtensorMap& tq, const CUtensorMap& tg, const CUtensorMap& trel, int smem) {
  static int done = 0;
  cudaError_t err = set_smem(bwd_dkv_kernel<D>, smem, done);
  if (err != cudaSuccess) return (int)err;
  bwd_dkv_kernel<D><<<a.B * a.H * p.splits * p.ktiles, NTHREADS, smem, a.stream>>>(tk, tv, tq, tg,
                                                                                  trel, p);
  return (int)cudaGetLastError();
}

template <int D, typename R>
int run(const Args& a, RelIn<R> rel, RelOut<R> drel, int res_from) {
  const int K = a.kt + a.kh + a.kw, NP = pad_bins(K), KP = relp_cols(K);
  const int HD = a.H * D, ntiles = (a.Lk + BN - 1) / BN;
  const QSmem LQ = q_layout(D, K);
  const KSmem LK = k_layout(D, K);
  if (LQ.total > SMEM_MAX || LK.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tg, tk, tv, trel;
  if (!make_map(&tq, a.q, a.B, a.Lq, HD, BM) || !make_map(&tg, a.g, a.B, a.Lq, HD, BM) ||
      !make_map(&tk, a.k, a.B, a.Lk, HD, BN) || !make_map(&tv, a.v, a.B, a.Lk, HD, BN) ||
      !make_relp_map(&trel, a.relp, a.B * a.H, a.Lq, KP))
    return (int)cudaErrorInvalidValue;

  const int tb = (ntiles * NP * 8 + 255) / 256;
  bwd_tables_kernel<<<tb, 256, 0, a.stream>>>(static_cast<unsigned char*>(a.e_all),
                                              static_cast<int*>(a.ktab), ntiles, a.Lk, a.kt, a.kh,
                                              a.kw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  QParams<R> qp;
  qp.rel = rel;
  qp.drel = drel;
  qp.g = static_cast<const bf16*>(a.g);
  qp.dq = static_cast<bf16*>(a.dq);
  qp.lse = static_cast<const float*>(a.lse);
  qp.relp = static_cast<float*>(a.relp);
  qp.e_all = static_cast<const unsigned char*>(a.e_all);
  qp.ktab_all = static_cast<const int*>(a.ktab);
  qp.Lq = a.Lq; qp.Lk = a.Lk; qp.H = a.H; qp.kt = a.kt; qp.kh = a.kh; qp.kw = a.kw;
  qp.res_from = res_from;
  qp.ntiles = ntiles;
  qp.qtiles = (a.Lq + BM - 1) / BM;
  qp.scale_q = a.scale_q;
  qp.scale = a.scale;
  int rc;
  switch (NP) {
    case 32: rc = launch_dq<D, 32, R>(a, qp, tq, tg, tk, tv, LQ.total); break;
    case 48: rc = launch_dq<D, 48, R>(a, qp, tq, tg, tk, tv, LQ.total); break;
    default: rc = launch_dq<D, 128, R>(a, qp, tq, tg, tk, tv, LQ.total); break;
  }
  if (rc != 0) return rc;

  KParams kp;
  kp.work = static_cast<float*>(a.work);
  kp.B = a.B; kp.Lq = a.Lq; kp.Lk = a.Lk; kp.H = a.H; kp.kt = a.kt; kp.kh = a.kh; kp.kw = a.kw;
  kp.ktiles = (a.Lk + BM - 1) / BM;
  kp.splits = a.splits;
  const int n_qt = (a.Lq + BN - 1) / BN;
  kp.per = (n_qt + a.splits - 1) / a.splits;
  kp.scale_q = a.scale_q;
  kp.scale = a.scale;
  rc = launch_dkv<D>(a, kp, tk, tv, tq, tg, trel, LK.total);
  if (rc != 0) return rc;

  const long long n = (long long)a.B * a.Lk * HD;
  const long long blocks = (n + 255) / 256;
  bwd_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, a.stream>>>(
      static_cast<const float*>(a.work), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), n,
      a.splits);
  return (int)cudaGetLastError();
}

template <typename R>
int dispatch(const Args& a, RelIn<R> rel, RelOut<R> drel, int res_from) {
  const int K = a.kt + a.kh + a.kw;
  if (a.Lq < 1 || a.Lk < 1 || a.splits < 1 || K < 1 || K > 128 || a.lse == nullptr)
    return (int)cudaErrorInvalidValue;
  switch (a.D) {
    case 64: return run<64, R>(a, rel, drel, res_from);
    case 96: return run<96, R>(a, rel, drel, res_from);
    case 128: return run<128, R>(a, rel, drel, res_from);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K5: q, k, v, g, dq, dk, dv (B, L, H*D) bf16; rel, drel (B, Lq, H,
// kt+kh+kw) bf16; lse (B, H, Lq) f32 from the forward; workspaces relp (B,
// H, Lq, KP) f32, e_all and ktab (the tables of every key tile), work (2,
// splits, B, Lk, H*D) f32
extern "C" int dsal_bias_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* rel, const void* g, const void* lse, void* dq,
                                       void* dk, void* dv, void* drel, void* relp, void* e_all,
                                       void* ktab, void* work, int B, int Lq, int Lk, int H, int D,
                                       int kt, int kh, int kw, int splits, float scale_q,
                                       float scale, int residual, void* stream) {
  const bf16* rp = static_cast<const bf16*>(rel);
  bf16* drp = static_cast<bf16*>(drel);
  const int K = kt + kh + kw;
  const RelIn<bf16> r = {{rp, rp + kt, rp + kt + kh}, {H * K, H * K, H * K}, K};
  const RelOut<bf16> dr = {{drp, drp + kt, drp + kt + kh}, {H * K, H * K, H * K}, K};
  const Args a = {q, k, v, g, lse, dq, dk, dv, relp, e_all, ktab, work, B, Lq, Lk, H, D, kt, kh,
                  kw, splits, scale_q, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(a, r, dr, residual ? 0 : Lq);
}

// K12's backward: q, k, v, g, dq, dk, dv (BH, L, D) bf16 with cls at row 0;
// rel_t/h/w and drel_t/h/w (BH, Lq, kt/kh/kw) f32; lse (BH, Lq) f32; dq's
// residual skips row 0; workspaces as for K5 with B = BH, H = 1
extern "C" int dsal_cls_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* rel_t, const void* rel_h, const void* rel_w,
                                      const void* g, const void* lse, void* dq, void* dk, void* dv,
                                      void* drel_t, void* drel_h, void* drel_w, void* relp,
                                      void* e_all, void* ktab, void* work, int BH, int Lq, int Lk,
                                      int D, int kt, int kh, int kw, int splits, float scale_q,
                                      float scale, int residual, void* stream) {
  const RelIn<float> r = {{static_cast<const float*>(rel_t), static_cast<const float*>(rel_h),
                           static_cast<const float*>(rel_w)},
                          {kt, kh, kw},
                          0};
  const RelOut<float> dr = {{static_cast<float*>(drel_t), static_cast<float*>(drel_h),
                             static_cast<float*>(drel_w)},
                            {kt, kh, kw},
                            0};
  const Args a = {q, k, v, g, lse, dq, dk, dv, relp, e_all, ktab, work, BH, Lq, Lk, 1, D, kt, kh,
                  kw, splits, scale_q, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(a, r, dr, residual ? 1 : Lq);
}
