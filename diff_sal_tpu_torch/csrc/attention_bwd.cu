// K5: backward of K1 (pooled attention with decomposed (T, H, W) rel-pos
// bias and residual pooling): dq, dk, dv and drel from the output gradient g.
//
// Replaces the TPU kernel diff_sal_tpu/ops/attention.py:761 _fba2_bwd (body
// _attn_v2_bwd_kernel :697). Per (batch, head), with s = (q * scale) k^T +
// bias and p = softmax(s) recomputed in f32:
//   dv = p_lo^T g,  dp = g v^T,  ds = p * (dp - rowsum(dp * p)),
//   dq = (ds_lo k) * scale (+ g when residual),  dk = (ds_lo^T q) * scale,
//   drel[l, t] = sum_{j >= 1, t(j) = t} ds[l, j]  (and likewise for h, w),
// where p_lo and ds_lo are p and ds rounded to bf16, as the TPU kernel feeds
// them to its products; every product accumulates in f32.
//
// Bound by operations on the H100: five (Lq, Lk, D) products per head,
// ~10 * Lq * Lk * D flops, against one pass over q, k, v, rel, g and the
// outputs. The score matrix is recomputed, never stored. Three kernels:
//  1. q-major, one CTA of four warps per (batch, head, 64 query rows): walks
//     the key tiles three times (row logsumexp; delta = rowsum(dp * p); ds),
//     with S = Q K^T, dP = G V^T and dQ += dS K on the tensor cores (WMMA,
//     bf16 in, f32 accumulation). dQ stays in WMMA fragments. drel is a
//     product too, as on the TPU: dRel += dS E^T with E the tile's one-hot
//     (key -> t, kt + h, kt + kh + w) matrix, built in shared memory from
//     index math as in K1; dS enters as two bf16 terms (hi + lo, ~16
//     mantissa bits) with f32 accumulation, so the sums keep f32-level
//     precision without atomics. dQ and drel are written once, with the row
//     logsumexp and delta for kernel 2.
//  2. k-major, one CTA per (batch, head, 64 keys, query split): walks its
//     split of the query tiles, recomputes p and ds for its keys, and adds
//     dV += P^T G and dK += dS^T Q into fragments held in registers. Where
//     Lk is small (673 keys at MViT block 0) the query range is split so
//     the grid fills the card; each split writes its f32 partial sums to a
//     workspace.
//  3. a reduction over the splits in a fixed order, cast to bf16.
// No atomics anywhere, so results do not depend on scheduling. Key columns
// past Lk and query rows past Lq are masked, never padded in memory.
// head_dim D is a template parameter (64, 96 or 128).
//
// K12's backward is the same three kernels on MViT's token-concat layout. It
// replaces the TPU kernel diff_sal_tpu/ops/attention.py:280 _fba_bwd (body
// _attn_bwd_kernel :193): q, k, v, g (B*heads, L, D) bf16 with the cls query
// at row 0 inside the tiles, the bias terms as three f32 tensors rel_t/h/w
// read and their gradients written in f32 (from the same hi + lo product,
// ~16 mantissa bits of the unrounded f32 dS), and dq's residual term on rows
// >= 1 only. dk and dv use the rounded dS and P, as the TPU body does. The
// rel layouts go through RelIn/RelOut (per-part pointers and row strides), so
// one template serves K5 and K12.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;  // query rows (kernel 1) or keys (kernel 2) per CTA
constexpr int BN = 64;  // keys (kernel 1) or query rows (kernel 2) per tile
constexpr int NW = 4;   // warps; warp w owns rows [16w, 16w + 16) of a tile
constexpr int NT = NW * 32;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout common to both kernels. Kernel 1: a = Q (scaled),
// b = G, c = K tile, d = V tile, e = the one-hot E tile (Kp x 64 bf16).
// Kernel 2: a = Q tile (scaled), b = G tile, c = K (this CTA's keys), d = V,
// e = Q tile unscaled. s and dp hold f32 scores and dP; the f32 output
// staging o aliases them at the end. p and ds hold bf16 tiles (kernel 2: P
// and dS; kernel 1: the lo and hi parts of dS). r is the rel tile in f32;
// x is kernel 1's drel accumulator (64 x Kp f32) or kernel 2's (lse,
// delta) rows.
struct Layout {
  int ldq, lds, ldp, ldo, kp, ldr;
  size_t a, b, c, d, e, s, dp, p, ds, r, x, total;
};

__host__ __device__ inline Layout make_layout(int D, int K, bool kmajor) {
  Layout L;
  L.ldq = D + 8;   // bf16 rows, padded against bank conflicts
  L.lds = BN + 4;  // f32 score rows
  L.ldp = BN + 8;  // bf16 probability rows (and E rows)
  L.ldo = D + 4;   // f32 output rows
  L.kp = (K + 15) / 16 * 16;  // rel bins padded to the MMA width
  L.ldr = L.kp + 4;           // f32 drel rows
  const size_t tile = (size_t)BM * L.ldq * 2;
  const size_t sbytes = (size_t)BM * L.lds * 4;
  const size_t obytes = (size_t)BM * L.ldo * 4;
  size_t off = 0;
  L.a = off; off = align128(off + tile);
  L.b = off; off = align128(off + tile);
  L.c = off; off = align128(off + tile);
  L.d = off; off = align128(off + tile);
  L.e = off; off = align128(off + (kmajor ? tile : (size_t)L.kp * L.ldp * 2));
  L.s = off;
  L.dp = off + sbytes;
  off = align128(off + (2 * sbytes > obytes ? 2 * sbytes : obytes));
  L.p = off; off = align128(off + (size_t)BM * L.ldp * 2);
  L.ds = off; off = align128(off + (size_t)BM * L.ldp * 2);
  L.r = off; off = align128(off + (size_t)BM * K * 4);
  L.x = off; off = align128(off + (kmajor ? (size_t)BM * 2 * 4 : (size_t)BM * L.ldr * 4));
  L.total = off;
  return L;
}

// Where the three parts (t, h, w) of the bias terms of one query row lie:
// element c of part p for (batch b, row, head h) is at
// p[part][(b * Lq + row) * ld[part] + h * hs + c]. K5: one packed bf16
// (B, Lq, H, kt + kh + kw) tensor; K12: three f32 tensors of one head.
template <typename R>
struct RelIn {
  const R* p[3];
  int ld[3];
  int hs;
};

template <typename R>
struct RelOut {
  R* p[3];
  int ld[3];
  int hs;
};

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(bf16* dst, float x) { *dst = __float2bfloat16(x); }
__device__ __forceinline__ void from_f32(float* dst, float x) { *dst = x; }

// part (0 = t, 1 = h, 2 = w) of bias column c, and c's index within it
__device__ __forceinline__ int rel_part(int c, int kt, int kh, int& cc) {
  const int part = c < kt ? 0 : (c < kt + kh ? 1 : 2);
  cc = c - (part == 0 ? 0 : (part == 1 ? kt : kt + kh));
  return part;
}

__device__ __forceinline__ void key_coord(int j, int khw, int kw, int& t, int& h, int& w) {
  const int jj = j - 1;
  t = jj / khw;
  const int rem = jj - t * khw;
  h = rem / kw;
  w = rem - h * kw;
}

__device__ __forceinline__ float key_bias(const float* R, int j, int t, int h, int w, int kt,
                                          int kh) {
  return j > 0 ? R[t] + R[kt + h] + R[kt + kh + w] : 0.f;
}

// Rows [row0, row0 + 64) of a (B, L, H*D) bf16 tensor at head h into shared
// memory (ld = D + 8), optionally multiplied by `scale` and rounded to bf16;
// rows past L are zero.
template <int D>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src, bf16* dst, int ld,
                                          int b, int L, int row0, int HD, int h, bool scaled,
                                          float scale) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BM * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, row = row0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row < L) raw = *reinterpret_cast<const uint4*>(src + ((size_t)b * L + row) * HD + h * D + c);
    if (scaled) {
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = raw;
  }
}

// rel rows [row0, row0 + 64) of head h in f32; rows past Lq are zero
template <typename R>
__device__ __forceinline__ void load_rel(const RelIn<R>& rel, float* Rs, int b, int Lq, int row0,
                                         int h, int kt, int kh, int K) {
  for (int i = threadIdx.x; i < BM * K; i += NT) {
    const int r = i / K, c = i - r * K, row = row0 + r;
    int cc;
    const int part = rel_part(c, kt, kh, cc);
    Rs[i] = row < Lq ? to_f32(rel.p[part][((size_t)b * Lq + row) * rel.ld[part] + h * rel.hs + cc])
                     : 0.f;
  }
}

// out[16 rows of this warp, 64 cols] = A[rows] . B[cols]^T, f32, into S (ld lds):
// A rows at A + r0 * ld, B rows (the 64 columns) at B, both bf16 with ld.
template <int D>
__device__ __forceinline__ void rows_dot_cols(const bf16* A, const bf16* Bm, int ld, float* S,
                                              int lds, int r0) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(a[kk], A + r0 * ld + kk * 16, ld);
#pragma unroll
  for (int n = 0; n < BN / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
      wmma::load_matrix_sync(bk, Bm + n * 16 * ld + kk * 16, ld);
      wmma::mma_sync(acc, a[kk], bk, acc);
    }
    wmma::store_matrix_sync(S + r0 * lds + n * 16, acc, lds, wmma::mem_row_major);
  }
}

// ---------------------------------------------------------------------------
// kernel 1: dq, drel, and the row logsumexp and delta
// ---------------------------------------------------------------------------
// dq gets the residual term g on rows >= res_from (K5: 0, K12: 1; no
// residual: Lq)
template <int D, typename R>
__global__ void __launch_bounds__(NT) attn_bwd_q_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const RelIn<R> rel, const bf16* __restrict__ g, bf16* __restrict__ dq, const RelOut<R> drel,
    float* __restrict__ lse_out, float* __restrict__ delta_out, int Lq, int Lk, int H, int kt,
    int kh, int kw, float scale_q, float scale, int res_from) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = kt + kh + kw;
  const Layout L = make_layout(D, K, false);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.a);
  bf16* Gs = reinterpret_cast<bf16*>(smem + L.b);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.c);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.d);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* DPs = reinterpret_cast<float*>(smem + L.dp);
  float* Os = reinterpret_cast<float*>(smem + L.s);  // aliases Ss/DPs at the end
  bf16* DSs = reinterpret_cast<bf16*>(smem + L.ds);  // hi part of dS
  bf16* DLs = reinterpret_cast<bf16*>(smem + L.p);   // lo part of dS
  bf16* Es = reinterpret_cast<bf16*>(smem + L.e);
  float* Rs = reinterpret_cast<float*>(smem + L.r);
  float* dRs = reinterpret_cast<float*>(smem + L.x);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HD = H * D;
  const int r0 = warp * 16;
  const int khw = kh * kw;

  load_rows<D>(q, Qs, L.ldq, b, Lq, q0, HD, h, true, scale_q);
  load_rows<D>(g, Gs, L.ldq, b, Lq, q0, HD, h, false, 0.f);
  load_rel(rel, Rs, b, Lq, q0, h, kt, kh, K);
  for (int i = tid; i < BM * L.ldr; i += NT) dRs[i] = 0.f;

  float lse[16], delta[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lse[i] = -INFINITY;  // running max in pass 1
    delta[i] = 0.f;      // running sum in pass 1, then delta
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dqf[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dqf[n], 0.f);

  for (int pass = 0; pass < 3; ++pass) {
    float dsum[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) dsum[i] = 0.f;
    for (int j0 = 0; j0 < Lk; j0 += BN) {
      __syncthreads();  // everyone is done with the previous K/V tile
      load_rows<D>(k, Ks, L.ldq, b, Lk, j0, HD, h, false, 0.f);
      if (pass > 0) load_rows<D>(v, Vs, L.ldq, b, Lk, j0, HD, h, false, 0.f);
      if (pass == 2 && tid < BN) {  // thread c writes column c of the one-hot E tile
        const int j = j0 + tid;
        for (int r = 0; r < L.kp; ++r) Es[r * L.ldp + tid] = __float2bfloat16(0.f);
        if (j > 0 && j < Lk) {
          int tj, hj, wj;
          key_coord(j, khw, kw, tj, hj, wj);
          const bf16 one = __float2bfloat16(1.f);
          Es[tj * L.ldp + tid] = one;
          Es[(kt + hj) * L.ldp + tid] = one;
          Es[(kt + kh + wj) * L.ldp + tid] = one;
        }
      }
      __syncthreads();
      rows_dot_cols<D>(Qs, Ks, L.ldq, Ss, L.lds, r0);
      if (pass > 0) rows_dot_cols<D>(Gs, Vs, L.ldq, DPs, L.lds, r0);
      __syncwarp();

      // each lane owns key columns lane and lane + 32 of the tile
      const int jA = j0 + lane, jB = j0 + lane + 32;
      const bool vA = jA < Lk, vB = jB < Lk;
      int tA = 0, hA = 0, wA = 0, tB = 0, hB = 0, wB = 0;
      if (jA > 0) key_coord(jA, khw, kw, tA, hA, wA);
      if (jB > 0) key_coord(jB, khw, kw, tB, hB, wB);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = r0 + i;
        const float* R = Rs + r * K;
        const float sA = vA ? Ss[r * L.lds + lane] + key_bias(R, jA, tA, hA, wA, kt, kh) : -INFINITY;
        const float sB =
            vB ? Ss[r * L.lds + lane + 32] + key_bias(R, jB, tB, hB, wB, kt, kh) : -INFINITY;
        if (pass == 0) {  // online max and sum of exp
          float mx = fmaxf(sA, sB);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(lse[i], mx);
          float ps = exp2f((sA - m_new) * LOG2E) + exp2f((sB - m_new) * LOG2E);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
          delta[i] = delta[i] * exp2f((lse[i] - m_new) * LOG2E) + ps;
          lse[i] = m_new;
          continue;
        }
        const float pA = vA ? exp2f((sA - lse[i]) * LOG2E) : 0.f;
        const float pB = vB ? exp2f((sB - lse[i]) * LOG2E) : 0.f;
        const float dpA = DPs[r * L.lds + lane], dpB = DPs[r * L.lds + lane + 32];
        if (pass == 1) {
          dsum[i] += pA * dpA + pB * dpB;
          continue;
        }
        const float dsA = pA * (dpA - delta[i]);
        const float dsB = pB * (dpB - delta[i]);
        const bf16 hiA = __float2bfloat16(dsA), hiB = __float2bfloat16(dsB);
        DSs[r * L.ldp + lane] = hiA;
        DSs[r * L.ldp + lane + 32] = hiB;
        DLs[r * L.ldp + lane] = __float2bfloat16(dsA - __bfloat162float(hiA));
        DLs[r * L.ldp + lane + 32] = __float2bfloat16(dsB - __bfloat162float(hiB));
      }
      if (pass < 2) continue;
      __syncwarp();
      // dQ += dS K for this warp's 16 rows (dS rounded to bf16, as on the TPU)
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> da[BN / 16];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wmma::load_matrix_sync(da[kk], DSs + r0 * L.ldp + kk * 16, L.ldp);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
          wmma::load_matrix_sync(bk, Ks + kk * 16 * L.ldq + n * 16, L.ldq);
          wmma::mma_sync(dqf[n], da[kk], bk, dqf[n]);
        }
      }
      // dRel += (dS_hi + dS_lo) E^T for this warp's 16 rows, f32 accumulator
      // kept in shared memory
      for (int n = 0; n < L.kp / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, dRs + r0 * L.ldr + n * 16, L.ldr, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> lo;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> be;
          wmma::load_matrix_sync(lo, DLs + r0 * L.ldp + kk * 16, L.ldp);
          wmma::load_matrix_sync(be, Es + n * 16 * L.ldp + kk * 16, L.ldp);
          wmma::mma_sync(acc, da[kk], be, acc);
          wmma::mma_sync(acc, lo, be, acc);
        }
        wmma::store_matrix_sync(dRs + r0 * L.ldr + n * 16, acc, L.ldr, wmma::mem_row_major);
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        lse[i] = lse[i] + logf(delta[i]);
        delta[i] = 0.f;
      }
    } else if (pass == 1) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float d = dsum[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        delta[i] = d;
      }
    }
  }

  __syncthreads();  // Os aliases every warp's Ss/DPs rows
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(Os + r0 * L.ldo + n * 16, dqf[n], L.ldo, wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Lq) continue;
    const size_t off = ((size_t)b * Lq + row) * HD + h * D;
    for (int c = lane; c < D; c += 32) {
      float o = Os[(r0 + i) * L.ldo + c] * scale;
      if (row >= res_from) o += __bfloat162float(Gs[(r0 + i) * L.ldq + c]);
      dq[off + c] = __float2bfloat16(o);
    }
    if (lane == 0) {
      lse_out[((size_t)b * H + h) * Lq + row] = lse[i];
      delta_out[((size_t)b * H + h) * Lq + row] = delta[i];
    }
  }
  __syncthreads();  // every warp's drel sums are complete
  for (int i = tid; i < BM * K; i += NT) {
    const int r = i / K, c = i - r * K, row = q0 + r;
    if (row >= Lq) continue;
    int cc;
    const int part = rel_part(c, kt, kh, cc);
    from_f32(drel.p[part] + ((size_t)b * Lq + row) * drel.ld[part] + h * drel.hs + cc,
             dRs[r * L.ldr + c]);
  }
}

// ---------------------------------------------------------------------------
// kernel 2: partial dk, dv of 64 keys over one split of the query tiles
// ---------------------------------------------------------------------------
template <int D, typename R>
__global__ void __launch_bounds__(NT) attn_bwd_kv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const RelIn<R> rel, const bf16* __restrict__ g, const float* __restrict__ lse_in,
    const float* __restrict__ delta_in, float* __restrict__ work, int B, int Lq, int Lk, int H,
    int kt, int kh, int kw, int splits, float scale_q, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = kt + kh + kw;
  const Layout L = make_layout(D, K, true);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.a);
  bf16* Gs = reinterpret_cast<bf16*>(smem + L.b);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.c);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.d);
  bf16* Qr = reinterpret_cast<bf16*>(smem + L.e);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* DPs = reinterpret_cast<float*>(smem + L.dp);
  float* Os = reinterpret_cast<float*>(smem + L.s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  bf16* DSs = reinterpret_cast<bf16*>(smem + L.ds);
  float* Rs = reinterpret_cast<float*>(smem + L.r);
  float* LSE = reinterpret_cast<float*>(smem + L.x);
  float* DLT = LSE + BM;

  const int b = blockIdx.z, h = blockIdx.y / splits, split = blockIdx.y % splits;
  const int k0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HD = H * D;
  const int r0 = warp * 16;
  const int khw = kh * kw;
  const int n_qt = (Lq + BN - 1) / BN;
  const int per = (n_qt + splits - 1) / splits;
  const int qt_end = min(n_qt, (split + 1) * per);

  load_rows<D>(k, Ks, L.ldq, b, Lk, k0, HD, h, false, 0.f);
  load_rows<D>(v, Vs, L.ldq, b, Lk, k0, HD, h, false, 0.f);
  const int jA = k0 + lane, jB = k0 + lane + 32;
  const bool vA = jA < Lk, vB = jB < Lk;
  int tA = 0, hA = 0, wA = 0, tB = 0, hB = 0, wB = 0;
  if (jA > 0) key_coord(jA, khw, kw, tA, hA, wA);
  if (jB > 0) key_coord(jB, khw, kw, tB, hB, wB);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dkf[D / 16], dvf[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dkf[n], 0.f);
    wmma::fill_fragment(dvf[n], 0.f);
  }

  for (int qt = split * per; qt < qt_end; ++qt) {
    const int q0 = qt * BN;
    __syncthreads();  // everyone is done with the previous query tile
    load_rows<D>(q, Qs, L.ldq, b, Lq, q0, HD, h, true, scale_q);
    load_rows<D>(q, Qr, L.ldq, b, Lq, q0, HD, h, false, 0.f);
    load_rows<D>(g, Gs, L.ldq, b, Lq, q0, HD, h, false, 0.f);
    load_rel(rel, Rs, b, Lq, q0, h, kt, kh, K);
    for (int i = tid; i < BN; i += NT) {
      const int row = q0 + i;
      const size_t o = ((size_t)b * H + h) * Lq + row;
      LSE[i] = row < Lq ? lse_in[o] : 0.f;
      DLT[i] = row < Lq ? delta_in[o] : 0.f;
    }
    __syncthreads();
    rows_dot_cols<D>(Qs, Ks, L.ldq, Ss, L.lds, r0);
    rows_dot_cols<D>(Gs, Vs, L.ldq, DPs, L.lds, r0);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = r0 + i;
      const bool vr = q0 + r < Lq;
      const float* R = Rs + r * K;
      const float lse = LSE[r], dlt = DLT[r];
      float pA = 0.f, pB = 0.f;
      if (vr && vA) pA = exp2f((Ss[r * L.lds + lane] + key_bias(R, jA, tA, hA, wA, kt, kh) - lse) * LOG2E);
      if (vr && vB)
        pB = exp2f((Ss[r * L.lds + lane + 32] + key_bias(R, jB, tB, hB, wB, kt, kh) - lse) * LOG2E);
      Ps[r * L.ldp + lane] = __float2bfloat16(pA);
      Ps[r * L.ldp + lane + 32] = __float2bfloat16(pB);
      DSs[r * L.ldp + lane] = __float2bfloat16(pA * (DPs[r * L.lds + lane] - dlt));
      DSs[r * L.ldp + lane + 32] = __float2bfloat16(pB * (DPs[r * L.lds + lane + 32] - dlt));
    }
    __syncthreads();  // dV and dK contract over all 64 query rows of the tile
    // warp w owns keys [16w, 16w + 16): dV += P^T G, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pa, da;
      wmma::load_matrix_sync(pa, Ps + kk * 16 * L.ldp + r0, L.ldp);
      wmma::load_matrix_sync(da, DSs + kk * 16 * L.ldp + r0, L.ldp);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bg, bq;
        wmma::load_matrix_sync(bg, Gs + kk * 16 * L.ldq + n * 16, L.ldq);
        wmma::load_matrix_sync(bq, Qr + kk * 16 * L.ldq + n * 16, L.ldq);
        wmma::mma_sync(dvf[n], pa, bg, dvf[n]);
        wmma::mma_sync(dkf[n], da, bq, dkf[n]);
      }
    }
  }

  // partial sums of this split -> work[0 (dk) | 1 (dv)][split][b][key][h*D + d]
  const size_t plane = (size_t)splits * B * Lk * HD;
  for (int part = 0; part < 2; ++part) {
    __syncthreads();  // Os aliases every warp's Ss/DPs rows
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      if (part == 0) {
#pragma unroll
        for (int e = 0; e < dkf[n].num_elements; ++e) dkf[n].x[e] *= scale;
        wmma::store_matrix_sync(Os + r0 * L.ldo + n * 16, dkf[n], L.ldo, wmma::mem_row_major);
      } else {
        wmma::store_matrix_sync(Os + r0 * L.ldo + n * 16, dvf[n], L.ldo, wmma::mem_row_major);
      }
    }
    __syncthreads();
    float* dst = work + part * plane + ((size_t)split * B + b) * Lk * HD + h * D;
    for (int i = tid; i < BM * D; i += NT) {
      const int r = i / D, c = i - r * D, key = k0 + r;
      if (key < Lk) dst[(size_t)key * HD + c] = Os[r * L.ldo + c];
    }
  }
}

// kernel 3: dk, dv = sum over splits of the partials, in split order, to bf16
__global__ void attn_bwd_reduce_kernel(const float* __restrict__ work, bf16* __restrict__ dk,
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

template <int D, typename R>
int launch(const bf16* q, const bf16* k, const bf16* v, RelIn<R> rel, const bf16* g, bf16* dq,
           bf16* dk, bf16* dv, RelOut<R> drel, float* lse, float* delta, float* work, int B,
           int Lq, int Lk, int H, int kt, int kh, int kw, int splits, float scale_q, float scale,
           int res_from, cudaStream_t stream) {
  const int K = kt + kh + kw;
  const Layout L1 = make_layout(D, K, false), L2 = make_layout(D, K, true);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_q_kernel<D, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L1.total);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_kv_kernel<D, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L2.total);
  if (err != cudaSuccess) return (int)err;
  dim3 g1((Lq + BM - 1) / BM, H, B);
  attn_bwd_q_kernel<D, R><<<g1, NT, L1.total, stream>>>(q, k, v, rel, g, dq, drel, lse, delta,
                                                        Lq, Lk, H, kt, kh, kw, scale_q, scale,
                                                        res_from);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g2((Lk + BM - 1) / BM, H * splits, B);
  attn_bwd_kv_kernel<D, R><<<g2, NT, L2.total, stream>>>(q, k, v, rel, g, lse, delta, work, B,
                                                         Lq, Lk, H, kt, kh, kw, splits, scale_q,
                                                         scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * Lk * H * D;
  const long long blocks = (n + 255) / 256;
  attn_bwd_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      work, dk, dv, n, splits);
  return (int)cudaGetLastError();
}

template <typename R>
int dispatch(const void* q, const void* k, const void* v, RelIn<R> rel, const void* g, void* dq,
             void* dk, void* dv, RelOut<R> drel, void* lse, void* delta, void* work, int B,
             int Lq, int Lk, int H, int D, int kt, int kh, int kw, int splits, float scale_q,
             float scale, int res_from, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* gp = static_cast<const bf16*>(g);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  float* lp = static_cast<float*>(lse);
  float* dp = static_cast<float*>(delta);
  float* wp = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DSAL_BWD(DD)                                                                            \
  return launch<DD>(qp, kp, vp, rel, gp, dqp, dkp, dvp, drel, lp, dp, wp, B, Lq, Lk, H, kt, kh, \
                    kw, splits, scale_q, scale, res_from, s)
  switch (D) {
    case 64: DSAL_BWD(64);
    case 96: DSAL_BWD(96);
    case 128: DSAL_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DSAL_BWD
}

}  // namespace

extern "C" int dsal_bias_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* rel, const void* g, void* dq, void* dk,
                                       void* dv, void* drel, void* lse, void* delta, void* work,
                                       int B, int Lq, int Lk, int H, int D, int kt, int kh, int kw,
                                       int splits, float scale_q, float scale, int residual,
                                       void* stream) {
  const bf16* rp = static_cast<const bf16*>(rel);
  bf16* drp = static_cast<bf16*>(drel);
  const int K = kt + kh + kw;
  const RelIn<bf16> r = {{rp, rp + kt, rp + kt + kh}, {H * K, H * K, H * K}, K};
  const RelOut<bf16> dr = {{drp, drp + kt, drp + kt + kh}, {H * K, H * K, H * K}, K};
  return dispatch(q, k, v, r, g, dq, dk, dv, dr, lse, delta, work, B, Lq, Lk, H, D, kt, kh, kw,
                  splits, scale_q, scale, residual ? 0 : Lq, stream);
}

// K12's backward: q, k, v, g, dq, dk, dv (BH, L, D) bf16 with cls at row 0;
// rel_t/h/w and drel_t/h/w (BH, Lq, kt/kh/kw) f32; dq's residual skips row 0
extern "C" int dsal_cls_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* rel_t, const void* rel_h, const void* rel_w,
                                      const void* g, void* dq, void* dk, void* dv, void* drel_t,
                                      void* drel_h, void* drel_w, void* lse, void* delta,
                                      void* work, int BH, int Lq, int Lk, int D, int kt, int kh,
                                      int kw, int splits, float scale_q, float scale,
                                      int residual, void* stream) {
  const RelIn<float> r = {{static_cast<const float*>(rel_t), static_cast<const float*>(rel_h),
                           static_cast<const float*>(rel_w)},
                          {kt, kh, kw},
                          0};
  const RelOut<float> dr = {{static_cast<float*>(drel_t), static_cast<float*>(drel_h),
                             static_cast<float*>(drel_w)},
                            {kt, kh, kw},
                            0};
  return dispatch(q, k, v, r, g, dq, dk, dv, dr, lse, delta, work, BH, Lq, Lk, 1, D, kt, kh, kw,
                  splits, scale_q, scale, residual ? 1 : Lq, stream);
}
