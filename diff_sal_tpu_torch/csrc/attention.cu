// K1: pooled attention with decomposed (T, H, W) rel-pos bias and residual
// pooling, forward, written for Hopper (sm_90a).
//
// Replaces the TPU kernel diff_sal_tpu/ops/attention.py:601
// fused_bias_attention_v2 (body _attn_v2_kernel :477). Per (batch, head):
//   out = softmax(q k^T * scale + bias) v (+ q on rows >= res_from)
//   bias[l, j] = rel_t[l, t(j)] + rel_h[l, h(j)] + rel_w[l, w(j)], j >= 1
// with (t, h, w) = unravel(j - 1) over (kt, kh, kw); key 0 (cls) gets zero.
//
// K12 is the same kernel on MViT's token-concat layout. It replaces the TPU
// kernel diff_sal_tpu/ops/attention.py:119 fused_bias_attention (body
// _attn_kernel :62): q, k, v (B*heads, L, D) with the cls token at row 0 of q
// as well as of k and v, the bias as three f32 tensors rel_t (B*heads, Lq,
// kt), rel_h (.., kh), rel_w (.., kw) whose row 0 the caller zeroes, and the
// residual added to rows >= 1 only: K1's layout with B*heads batches of one
// head, the rel parts read through per-part pointers and row strides.
//
// Bound by operations on the H100 (4 * Lq * Lk * D flops per head against one
// pass over q, k, v, rel and out). The design:
// - Warp specialisation. Warpgroup 0 is the producer: one thread issues every
//   TMA load. NC = 1 or 2 consumer warpgroups each own 64 query rows (64 or
//   128 rows per CTA, as the host-side plan `fwd_plan` in ops/attention.py
//   chooses). With two, setmaxnreg moves registers from the producer (24) to
//   the consumers (240).
// - TMA. 3-D tensor maps over (B, L, H*D) zero-fill rows past L, both at the
//   ragged end of a batch's queries and in the last key tile, so nothing is
//   padded in memory. Q is loaded once; K and V tiles of BN keys (64 with two
//   consumer warpgroups, 128 with one) fill two rings of `stages` buffers,
//   each buffer guarded by a full/empty mbarrier pair, so a K buffer is
//   refilled as soon as its S product is done.
// - Shared-memory layout: the 64-byte swizzle. A row of D = 96 bf16 is 192
//   bytes, 1.5 atoms of the 128-byte swizzle but exactly three of the 64-byte
//   one, so every operand is stored as D/32 column chunks of [rows][32]
//   elements (64-byte rows, TMA box {32, rows, 1}, CU_TENSOR_MAP_SWIZZLE_64B)
//   and every wgmma descriptor uses the matching layout type. This serves D =
//   64 and 128 unchanged.
// - S = Q K^T with wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulated in
//   registers), Q and K both K-major from shared memory: D/16 k-steps.
// - The bias is added in registers. Each warpgroup keeps per query row one
//   f32 row in shared memory: rel_t[t] + rel_h[h] for every (t, h) (summed
//   once, in f32, in the order the TPU body sums), rel_w, zeros and a -inf
//   entry; the CTA keeps one table of every key column's two indices into
//   such a row (cls -> the zeros, columns >= Lk -> -inf), so a score takes two
//   loads and two adds and the mask costs nothing.
// - Online softmax in registers: each thread holds two rows' values, the row
//   max and sum reduce over the 4 lanes of a quad; exp2 with log2e folded in.
//   P is rounded to bf16 in registers and fed as the register A operand of
//   the second wgmma (m64nDk16, V MN-major from shared memory, transposed).
//   O stays in f32 registers: no S, P or O tile passes through shared memory.
// - A software pipeline over the key tiles: S_{i+1} is issued before
//   O += P_i V_i, and its bias and softmax run while that product is on the
//   tensor cores.
// - Epilogue: O * 1/l, the residual q (unscaled, read from device memory)
//   added in f32, one rounding, bf16x2 stores (a quad writes 16 contiguous
//   bytes). When the caller asks for it (training), each row's logsumexp
//   m + log l in f32, which the backward (csrc/attention_bwd.cu) reads
//   instead of recomputing it.
// - CTAs of one (batch, head) are adjacent in the 1-D grid, so they run
//   together and share that head's K and V in L2.
//
// Rounding follows the TPU kernel: q * scale rounded to bf16 before the
// product (done in place in shared memory, then fence.proxy.async before the
// first wgmma); the bias terms summed in f32; f32 scores; unnormalised
// probabilities rounded to bf16 for the P V product; the row sum kept in f32
// and applied after it; residual q added in f32 before the single rounding.

#include "hopper.cuh"

namespace {

constexpr int SMEM_MAX = 232448;   // dynamic shared memory one CTA may use
constexpr float LOG2E = 1.4426950408889634f;

// Byte offsets into the (1024-aligned) dynamic shared memory. Mirrored by
// `fwd_plan` in ops/attention.py, which checks the total against SMEM_MAX.
struct Smem {
  int q, k, v, rel, ktab, bar, total;
  int rs;  // floats per query row of the bias table
};

// smallest n' >= n with n' = 4 (mod 32): the 8 rows a warp reads at one
// (t, h) index land in 8 distinct banks
__host__ __device__ inline int rel_stride(int n) { return (n + 27) / 32 * 32 + 4; }

__host__ __device__ inline Smem smem_layout(int D, int rows, int BN, int stages, int ntiles,
                                            int kt, int kh, int kw) {
  Smem s;
  s.rs = rel_stride(kt * kh + kw + 3 + kt + kh);
  int off = 0;
  s.q = off;    off += rows * D * 2;
  s.k = off;    off += stages * BN * D * 2;
  s.v = off;    off += stages * BN * D * 2;
  s.rel = off;  off += rows * s.rs * 4;
  s.ktab = off; off += ntiles * BN * 4;
  s.bar = off;  off += (4 * stages + 1) * 8;  // K full/empty, V full/empty, Q
  s.total = off + 1024;  // room to align the base
  return s;
}

struct Params {
  const bf16* q;  // unscaled q, for the residual
  bf16* out;
  float* lse;  // each row's logsumexp of the biased scores, (B, H, Lq) f32, or null
  const void* rel[3];  // t, h, w parts (bf16 for K1, f32 for K12): element c of
  int rel_ld[3];       //   part p for (b, row, h) at rel[p][(b * Lq + row) *
                       //   rel_ld[p] + h * rel_hs + c]
  int rel_hs;
  int Lq, Lk, H, kt, kh, kw, res_from, ntiles, qtiles, stages;
  float scale;
};

// ------------------------------------------------------------- kernel ---

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename R>
__device__ __forceinline__ float rel_at(const Params& p, int part, size_t row, int c) {
  return to_f32(static_cast<const R*>(p.rel[part])[row * p.rel_ld[part] + c]);
}

// S = (q * scale) K^T for the K tile at shared address kb: issued and
// committed, not waited for. Q and K are K-major; the second 16 columns of a
// 32-column chunk start 32 bytes into its rows.
template <int D, int ROWS, int BN>
__device__ __forceinline__ void issue_s(float (&sc)[BN / 2], uint32_t qa, uint32_t kb) {
  reg_fence(sc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t ko = (kk & 1) * 32;
    wgmma_ss<BN>(sc, sw64_desc(qa + (kk >> 1) * ROWS * 64 + ko, 16, 512),
                 sw64_desc(kb + (kk >> 1) * BN * 64 + ko, 16, 512), kk > 0);
  }
  wg_commit();
}

// Online softmax state of one thread's two rows (r0, r0 + 8).
struct Softmax {
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, alpha0 = 0.f, alpha1 = 0.f;

  // Adds the bias (masking columns >= Lk) to one S tile, updates the running
  // max and sum, sets the tile's rescale factors and turns the tile, in
  // place, into its unnormalised probabilities.
  template <int BN>
  __device__ __forceinline__ void tile(float (&sc)[BN / 2], const int* kt_tile,
                                       const float* rel0, const float* rel1) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int2 e = *reinterpret_cast<const int2*>(kt_tile + 8 * j);
      const int a0 = e.x & 0xffff, w0 = e.x >> 16, a1 = e.y & 0xffff, w1 = e.y >> 16;
      sc[4 * j + 0] += rel0[a0] + rel0[w0];
      sc[4 * j + 1] += rel0[a1] + rel0[w1];
      sc[4 * j + 2] += rel1[a0] + rel1[w0];
      sc[4 * j + 3] += rel1[a1] + rel1[w1];
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds a valid key, so the new max is finite
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    alpha0 = ex2((m0 - n0) * LOG2E);
    alpha1 = ex2((m1 - n1) * LOG2E);
    const float b0 = n0 * LOG2E, b1 = n1 * LOG2E;
    m0 = n0;
    m1 = n1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      sc[4 * j + 0] = ex2(fmaf(sc[4 * j + 0], LOG2E, -b0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], LOG2E, -b0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], LOG2E, -b1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], LOG2E, -b1));
      s0 += sc[4 * j + 0] + sc[4 * j + 1];
      s1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * alpha0 + s0;
    l1 = l1 * alpha1 + s1;
  }
};

// The probabilities of one tile rounded to bf16, as the A fragments of the
// P V product (k-step kk holds key columns 16 kk .. 16 kk + 15).
template <int BN>
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2], uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(sc[4 * j + 0], sc[4 * j + 1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

// O * alpha of the newest tile, before any product is in flight
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const Softmax& sm) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= sm.alpha0;
    o[4 * j + 1] *= sm.alpha0;
    o[4 * j + 2] *= sm.alpha1;
    o[4 * j + 3] *= sm.alpha1;
  }
  reg_fence(o);
}

// O += P V for the V tile at shared address vb once its barrier `full`
// reaches `parity`: issued and committed, not waited for. V is MN-major:
// 32-column chunks BN * 64 bytes apart, 16 keys 1024 bytes apart.
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BN / 16][4],
                                         uint32_t vb, uint32_t full, int parity) {
  mbar_wait(full, parity);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<D>(o, pa[kk], sw64_desc(vb + kk * 1024, BN * 64, 512));
  wg_commit();
}

// Consumer warpgroup `wg` (0 .. NC-1) of one CTA: rows [q0 + 64 wg, +64).
template <int D, int NC, int BN, typename R>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, uint32_t sbase,
                                        const Smem& L, uint32_t bars, int b, int h, int q0,
                                        int ct) {
  constexpr int ROWS = 64 * NC;
  constexpr int CH = D / 32;  // 64-byte column chunks of a row
  const int wg = ct >> 7, t = ct & 127, warp = t >> 5, lane = t & 31;
  const int kth = p.kt * p.kh, zt = kth, neg = kth + 1, woff = kth + 2, zw = woff + p.kw;
  float* rel = reinterpret_cast<float*>(smem + L.rel);
  int* ktab = reinterpret_cast<int*>(smem + L.ktab);

  // key table: each key column's (t, h) index and w index into a bias row
  const int khw = p.kh * p.kw;
  for (int j = ct; j < p.ntiles * BN; j += NC * 128) {
    int e = neg | (zw << 16);
    if (j == 0) {
      e = zt | (zw << 16);
    } else if (j < p.Lk) {
      const int jj = j - 1, tt = jj / khw, rem = jj - tt * khw, hh = rem / p.kw;
      e = (tt * p.kh + hh) | ((woff + rem - hh * p.kw) << 16);
    }
    ktab[j] = e;
  }
  // bias rows of this warpgroup's 64 query rows: [rel_t + rel_h | 0 | -inf |
  // rel_w | 0 | raw rel_t, rel_h | pad]; rows past Lq hold zeros. First the
  // raw terms (independent loads, many in flight), then the (t, h) sums.
  const int K = p.kt + p.kh + p.kw, raw = zw + 1;
  float* rows = rel + wg * 64 * L.rs;
  constexpr int RB = 8;  // loads in flight per thread
  for (int i0 = t; i0 < 64 * K; i0 += 128 * RB) {
    float x[RB];
    int dst[RB];
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const int i = i0 + u * 128, r = i / K, c = i - r * K, row = q0 + wg * 64 + r;
      const int part = c < p.kt ? 0 : (c < p.kt + p.kh ? 1 : 2);
      const int cc = c - (part == 0 ? 0 : (part == 1 ? p.kt : p.kt + p.kh));
      dst[u] = i < 64 * K ? r * L.rs + (part == 2 ? woff + cc : raw + c) : -1;
      x[u] = i < 64 * K && row < p.Lq
                 ? rel_at<R>(p, part, (size_t)b * p.Lq + row, h * p.rel_hs + cc)
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < RB; ++u)
      if (dst[u] >= 0) rows[dst[u]] = x[u];
  }
  if (t < 64) {
    rows[t * L.rs + zt] = 0.f;
    rows[t * L.rs + neg] = -INFINITY;
    rows[t * L.rs + zw] = 0.f;
  }
  named_sync(2 + wg, 128);
  {
    float* mine = rows + (t >> 1) * L.rs;  // two threads per row
    for (int tt = t & 1; tt < p.kt; tt += 2) {
      const float a = mine[raw + tt];
      for (int hh = 0; hh < p.kh; ++hh) mine[tt * p.kh + hh] = a + mine[raw + p.kt + hh];
    }
  }
  // this warpgroup's Q rows, scaled in place and rounded to bf16
  mbar_wait(bars + 32 * p.stages, 0);  // Q
  for (int i = t; i < CH * 256; i += 128) {
    uint4* ptr = reinterpret_cast<uint4*>(smem + L.q + (i >> 8) * ROWS * 64 + wg * 4096 +
                                          (i & 255) * 16);
    uint4 vec = *ptr;
    bf16* e = reinterpret_cast<bf16*>(&vec);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * p.scale);
    *ptr = vec;
  }
  fence_async_smem();
  named_sync(1, NC * 128);

  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int cb = 2 * (lane & 3);           // and columns cb, cb + 1 of each 8
  const float* rel0 = rel + (wg * 64 + r0) * L.rs;
  const float* rel1 = rel0 + 8 * L.rs;
  const uint32_t qa = sbase + L.q + wg * 4096;
  float o[D / 2], sc[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  Softmax sm;
  uint32_t pa[BN / 16][4];

  // Software pipeline over the key tiles: S_{i+1} is issued before
  // O += P_i V_i, and its bias and softmax run while that product is on the
  // tensor cores. A K buffer is released as soon as its S product is done, a
  // V buffer when its P V product is.
  const uint32_t kfull = bars, kempty = kfull + 8 * p.stages, vfull = kempty + 8 * p.stages,
                 vempty = vfull + 8 * p.stages;
  mbar_wait(kfull, 0);
  issue_s<D, ROWS, BN>(sc, qa, sbase + L.k);
  wg_wait<0>();
  reg_fence(sc);
  mbar_arrive(kempty);
  sm.tile<BN>(sc, ktab + cb, rel0, rel1);
  pack_p<BN>(sc, pa);
  // The last tile is peeled off, so every wait below retires a product that
  // was issued on every path to it.
  for (int i = 0; i + 1 < p.ntiles; ++i) {
    const int s = i % p.stages, s1 = (i + 1) % p.stages;
    rescale<D>(o, sm);
    mbar_wait(kfull + 8 * s1, ((i + 1) / p.stages) & 1);
    issue_s<D, ROWS, BN>(sc, qa, sbase + L.k + s1 * BN * D * 2);
    issue_pv<D, BN>(o, pa, sbase + L.v + s * BN * D * 2, vfull + 8 * s, (i / p.stages) & 1);
    wg_wait<1>();  // S_{i+1}; P_i V_i may still run
    reg_fence(sc);
    mbar_arrive(kempty + 8 * s1);
    sm.tile<BN>(sc, ktab + (i + 1) * BN + cb, rel0, rel1);
    wg_wait<0>();
    reg_fence(o);
    reg_fence(pa);  // P_i stays in its registers until its product is done
    mbar_arrive(vempty + 8 * s);
    pack_p<BN>(sc, pa);
  }
  {
    const int i = p.ntiles - 1, s = i % p.stages;
    rescale<D>(o, sm);
    issue_pv<D, BN>(o, pa, sbase + L.v + s * BN * D * 2, vfull + 8 * s, (i / p.stages) & 1);
    wg_wait<0>();
    reg_fence(o);
  }

  float l0 = sm.l0, l1 = sm.l1;
  // epilogue: 1/l, the residual in f32, one rounding
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int HD = p.H * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wg * 64 + r0 + 8 * half;
    if (row >= p.Lq) continue;
    const float inv = 1.f / (half ? l1 : l0);
    // the backward recomputes p = exp(s - lse) from it
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[((size_t)b * p.H + h) * p.Lq + row] = (half ? sm.m1 : sm.m0) + logf(half ? l1 : l0);
    const size_t base = ((size_t)b * p.Lq + row) * HD + h * D + cb;
    const bool res = row >= p.res_from;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float x0 = o[4 * j + 2 * half] * inv, x1 = o[4 * j + 2 * half + 1] * inv;
      if (res) {
        const __nv_bfloat162 qq = *reinterpret_cast<const __nv_bfloat162*>(p.q + base + 8 * j);
        x0 += __low2float(qq);
        x1 += __high2float(qq);
      }
      *reinterpret_cast<__nv_bfloat162*>(p.out + base + 8 * j) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

// One CTA: (NC + 1) warpgroups, 64 * NC query rows of one (batch, head).
// With two consumer warpgroups the 384 threads start at 168 registers each;
// the producer gives its registers up (24) and the consumers take them (240).
// With one, the 256 threads may start at up to 255 registers (one CTA per SM,
// as its shared memory allows anyway), and ptxas allocates the consumer's
// registers without spilling; setmaxnreg has nothing to move there.
template <int D, int NC, int BN, typename R>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
    bias_attn_fwd(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int ROWS = 64 * NC;
  constexpr int CH = D / 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const Smem L = smem_layout(D, ROWS, BN, p.stages, p.ntiles, p.kt, p.kh, p.kw);
  // mbarriers: K full, K empty, V full, V empty (one per stage each), Q
  const uint32_t bars = sbase + L.bar, qbar = bars + 32 * p.stages;
  const int bh = blockIdx.x / p.qtiles, q0 = (blockIdx.x - bh * p.qtiles) * ROWS;
  const int b = bh / p.H, h = bh - b * p.H;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                                // K full
      mbar_init(bars + 8 * (p.stages + s), NC * 128);            // K empty
      mbar_init(bars + 8 * (2 * p.stages + s), 1);               // V full
      mbar_init(bars + 8 * (3 * p.stages + s), NC * 128);        // V empty
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int col = h * D;
      mbar_expect_tx(qbar, ROWS * D * 2);
      for (int c = 0; c < CH; ++c) tma_load(sbase + L.q + c * ROWS * 64, &tq, qbar, col + 32 * c, q0, b);
      for (int i = 0; i < p.ntiles; ++i) {
        const int s = i % p.stages, parity = ((i / p.stages) & 1) ^ 1;
        const uint32_t off = s * BN * D * 2;
        for (int kv = 0; kv < 2; ++kv) {
          const uint32_t full = bars + 8 * (2 * kv * p.stages + s);
          mbar_wait(full + 8 * p.stages, parity);  // the matching empty barrier
          mbar_expect_tx(full, BN * D * 2);
          for (int c = 0; c < CH; ++c)
            tma_load(sbase + (kv ? L.v : L.k) + off + c * BN * 64, kv ? &tv : &tk, full,
                     col + 32 * c, i * BN, b);
        }
      }
    }
  } else {  // consumer warpgroups
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<D, NC, BN, R>(p, smem, sbase, L, bars, b, h, q0, threadIdx.x - 128);
  }
}

template <int D, int NC, int BN, typename R>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
           int grid, int smem, cudaStream_t stream) {
  static int smem_set = 0;  // the attribute only grows; set it once per size
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(bias_attn_fwd<D, NC, BN, R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  bias_attn_fwd<D, NC, BN, R><<<grid, (NC + 1) * 128, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// rows (64 or 128 per CTA) and stages come from the host-side plan
template <int NC, int BN, typename R>
int launch_d(int D, const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
             const Params& p, int grid, int smem, cudaStream_t s) {
  switch (D) {
    case 64: return launch<64, NC, BN, R>(tq, tk, tv, p, grid, smem, s);
    case 96: return launch<96, NC, BN, R>(tq, tk, tv, p, grid, smem, s);
    default: return launch<128, NC, BN, R>(tq, tk, tv, p, grid, smem, s);
  }
}

// rows (64 or 128 per CTA) and stages come from the host-side plan. Two
// consumer warpgroups take 64-key tiles in a deeper ring, one takes 128-key
// tiles (the faster choice for each on the H100 at MViT's shapes, PERF.md).
template <typename R>
int dispatch(const void* q, const void* k, const void* v, Params p, int B, int D, int rows,
             int stages, void* stream) {
  const int HD = p.H * D, bn = rows == 128 ? 64 : 128;
  if ((D != 64 && D != 96 && D != 128) || (rows != 64 && rows != 128) || stages < 1 ||
      stages > 4 || p.Lq < 1 || p.Lk < 1)
    return (int)cudaErrorInvalidValue;
  p.q = static_cast<const bf16*>(q);
  p.ntiles = (p.Lk + bn - 1) / bn;
  p.qtiles = (p.Lq + rows - 1) / rows;
  p.stages = stages;
  const Smem L = smem_layout(D, rows, bn, stages, p.ntiles, p.kt, p.kh, p.kw);
  if (L.total > SMEM_MAX || L.rs > 0xffff) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, p.Lq, HD, rows) || !make_map(&tk, k, B, p.Lk, HD, bn) ||
      !make_map(&tv, v, B, p.Lk, HD, bn))
    return (int)cudaErrorInvalidValue;
  const int grid = B * p.H * p.qtiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rows == 128 ? launch_d<2, 64, R>(D, tq, tk, tv, p, grid, L.total, s)
                     : launch_d<1, 128, R>(D, tq, tk, tv, p, grid, L.total, s);
}

}  // namespace

// K1: q (B, Lq, H*D), k and v (B, Lk, H*D) bf16, rel (B, Lq, H, kt+kh+kw)
// bf16; the residual covers every row
extern "C" int dsal_bias_attention(const void* q, const void* k, const void* v,
                                   const void* rel, void* out, void* lse, int B, int Lq,
                                   int Lk, int H, int D, int kt, int kh, int kw, float scale,
                                   int residual, int rows, int stages, void* stream) {
  const bf16* rp = static_cast<const bf16*>(rel);
  const int K = kt + kh + kw;
  Params p = {};
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.rel[0] = rp;
  p.rel[1] = rp + kt;
  p.rel[2] = rp + kt + kh;
  p.rel_ld[0] = p.rel_ld[1] = p.rel_ld[2] = H * K;
  p.rel_hs = K;
  p.Lq = Lq; p.Lk = Lk; p.H = H; p.kt = kt; p.kh = kh; p.kw = kw;
  p.res_from = residual ? 0 : Lq;
  p.scale = scale;
  return dispatch<bf16>(q, k, v, p, B, D, rows, stages, stream);
}

// K12: q, k, v (BH, L, D) bf16 with cls at row 0; rel_t/h/w (BH, Lq, kt/kh/kw)
// f32; the residual skips row 0
extern "C" int dsal_cls_attention(const void* q, const void* k, const void* v,
                                  const void* rel_t, const void* rel_h, const void* rel_w,
                                  void* out, void* lse, int BH, int Lq, int Lk, int D, int kt,
                                  int kh, int kw, float scale, int residual, int rows, int stages,
                                  void* stream) {
  Params p = {};
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.rel[0] = rel_t;
  p.rel[1] = rel_h;
  p.rel[2] = rel_w;
  p.rel_ld[0] = kt; p.rel_ld[1] = kh; p.rel_ld[2] = kw;
  p.rel_hs = 0;
  p.Lq = Lq; p.Lk = Lk; p.H = 1; p.kt = kt; p.kh = kh; p.kw = kw;
  p.res_from = residual ? 1 : Lq;
  p.scale = scale;
  return dispatch<float>(q, k, v, p, BH, D, rows, stages, stream);
}
