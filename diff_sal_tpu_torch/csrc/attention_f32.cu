// K5 and K12's backward in f32, on the tensor cores: the instances an f32
// model (both packages' default compute dtype) runs on the card when it
// takes a gradient. The f32 forward (K1 and K12 in f32) is
// csrc/attention_f32_fwd.cu; these kernels read the logsumexp it saves.
//
// The same functions as csrc/attention_bwd.cu (the TPU kernels
// diff_sal_tpu/ops/attention.py:761 _fba2_bwd, body _attn_v2_bwd_kernel
// :697, and :280 _fba_bwd, body _attn_bwd_kernel :193, which take f32 as
// they take bf16). Per (batch, head), with p = exp(s - lse) recomputed from
// the biased scores s:
//   dp = g v^T, delta = rowsum(dp * p), ds = p * (dp - delta),
//   dv = p^T g, dq = ds k * scale (+ g on rows >= res_from),
//   dk = ds^T q * scale, drel = ds summed over the keys of each t, h, w bin.
// In f32 nothing is rounded between the steps (p_lo = p, ds_lo = ds), as
// the plain versions compute at f32.
//
// What bounds it: operations. Five (Lq, Lk, D) products per head make the
// function; these kernels run nine (below) plus drel. Every product runs on
// the tensor cores in split TF32 (csrc/tf32.cuh: mma.sync m16n8k8, three
// TF32 products per product, f32's accuracy at up to 165 TFLOP/s, against
// 67 for FFMA), each operand split into hi and lo in registers as its
// fragment loads. drel = ds E^T with E the one-hot (key -> bin) matrix,
// built in registers from each key's three bin indices: E is exact in TF32,
// so it takes two products (ds hi and lo), not three. The tensor cores'
// accumulation does not round to nearest, so every product starts from
// zero every FLUSH k-steps and is added into f32 registers.
//
// Two kernels and, where the queries are split, a reduction:
//  - q-major (dq, drel, delta): a CTA of 1, 2 or 4 warps owns 16 query rows
//    per warp of one (batch, head) and walks the key tiles (32 keys, a
//    cp.async double buffer) twice: S = (q * scale) K^T and dP = G V^T give
//    delta, then S and dP again give ds, and dq += ds K, drel += ds E^T
//    (five products and drel). Rows per CTA shrink from 64 to 32 or 16
//    where the row tiles would leave SMs idle (the small models).
//  - k-major (dk, dv): a CTA of four warps owns 16 keys per warp and walks
//    its split of the query tiles (32 rows, Q, G, the bias rows, lse and
//    delta through a cp.async double buffer): S^T = K (q * scale)^T, p,
//    dv += p^T G, dP^T = V G^T, ds, dk += ds^T Q (four products; Q is
//    loaded once, its fragment scaled for S^T and dk scaled at the end).
//    Query splits fill the card in whole waves; their partial sums go to
//    an f32 workspace that a third kernel reduces in a fixed order.
// No atomics: two runs give the same bits.
//
// Fragments: in a product whose A and B both come from shared memory
// (S, dP and their transposes) k-step kk takes head-dim columns 8 kk + t
// and 8 kk + t + 4 (the natural order). In a product whose A is an
// accumulator (p or ds), k-step j takes keys (or query rows) 8 j + 2t and
// 8 j + 2t + 1, exactly the accumulator's columns a thread holds, so p and
// ds go from the accumulator to the A operand without a shuffle. Every
// tile's row stride is D + 4 floats (4 mod 32 banks), which makes both
// access patterns free of bank conflicts. The geometry (rows per CTA, bins
// padded to the drel product's N, splits, shared memory) is chosen here
// and mirrored by `f32_bwd_plan` in ops/attention.py, which the CPU tests
// check.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bias.cuh"
#include "tf32.cuh"

namespace {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory one CTA may use
constexpr int SM_SMEM = 233472;   // shared memory of an SM (each CTA also holds 1 KB)
constexpr int NUM_SMS = 132;
constexpr int MAX_WAVES = 8;  // of k-major CTAs, at most, that query splits make
constexpr int MAX_K = 128;  // kt + kh + kw
constexpr int BN = 32;      // keys per tile of the q-major kernel
constexpr int BM = 32;      // query rows per tile of the k-major kernel
constexpr int KW = 4;       // warps of the k-major kernel
constexpr int KROWS = 16 * KW;  // keys per k-major CTA

struct Params {
  const float *q, *k, *v, *g, *lse;
  float *dq, *delta, *work, *dk, *dv;
  RelIn<float> rel;
  RelOut<float> drel;
  int B, Lq, Lk, H, kt, kh, kw, res_from, splits;
  float scale;
};

// Shared memory, in floats. q-major: Q and G (rows x D + 4), the K and V
// double buffers (BN x D + 4 each), the key table of both buffers (BN ints
// each) and the bias rows (rows x K + 2). k-major: K and V (KROWS x D + 4),
// the Q and G double buffers (BM x D + 4 each), the bias rows, lse and
// delta of both buffers. Mirrored by `f32_bwd_smem` in ops/attention.py.
__host__ __device__ inline int q_smem(int D, int rows, int K) {
  return 4 * (2 * rows * (D + 4) + 4 * BN * (D + 4) + 2 * BN + rows * (K + 2));
}
__host__ __device__ inline int k_smem(int D, int K) {
  return 4 * (2 * KROWS * (D + 4) + 4 * BM * (D + 4) + 2 * BM * (K + 2) + 4 * BM);
}

// `n` rows [row0, row0 + n) of one head (columns col0 .. col0 + D) of a
// (B, L, HD) tensor into shared memory at row stride ld floats by cp.async;
// rows past L are zeros
template <int D, int NT>
__device__ __forceinline__ void load_rows(uint32_t dst, int ld, const float* __restrict__ src,
                                          int n, int b, int L, int row0, int HD, int col0) {
  constexpr int V4 = D / 4;
  for (int i = threadIdx.x; i < n * V4; i += NT) {
    const int r = i / V4, c = (i - r * V4) * 4, row = row0 + r;
    const bool ok = row < L;
    cp16(dst + (r * ld + c) * 4, src + ((size_t)b * L + (ok ? row : 0)) * HD + col0 + c, ok);
  }
}

// acc[n] = A B_n^T for the 16 rows of A at `a` (row stride D + 4) and the
// four 8-row n-tiles of B at `b`, over the D columns, in split TF32 (k-step
// kk: columns 8 kk + t, 8 kk + t + 4). With SCALE, B's elements are
// multiplied by `mul` (rounded in f32, as the plain versions round
// q * scale) before they are split.
template <int D, bool SCALE>
__device__ __forceinline__ void tile_nt(float (&acc)[4][4], const float* a, const float* b,
                                        float mul) {
  constexpr int SD = D + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * SD + t;
  const float* b0 = b + g * SD + t;
  float part[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    split(a0[8 * kk], ah[0], al[0]);
    split(a0[8 * SD + 8 * kk], ah[1], al[1]);
    split(a0[8 * kk + 4], ah[2], al[2]);
    split(a0[8 * SD + 8 * kk + 4], ah[3], al[3]);
    float bb[4][2];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      bb[n][0] = b0[8 * n * SD + 8 * kk];
      bb[n][1] = b0[8 * n * SD + 8 * kk + 4];
      if (SCALE) {
        bb[n][0] *= mul;
        bb[n][1] *= mul;
      }
    }
    if (kk % FLUSH == 0)
      mma3<4, true>(part, ah, al, bb);
    else
      mma3<4, false>(part, ah, al, bb);
    if (kk % FLUSH == FLUSH - 1 || kk == D / 8 - 1) flush<4>(acc, part);
  }
}

// the A fragments (hi, lo) of k-step j from accumulator n-tile j: columns
// 2t and 2t + 1 of rows g and g + 8
__device__ __forceinline__ void split_acc(const float (&x)[4][4], uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(x[j][0], hi[j][0], lo[j][0]);
    split(x[j][2], hi[j][1], lo[j][1]);
    split(x[j][1], hi[j][2], lo[j][2]);
    split(x[j][3], hi[j][3], lo[j][3]);
  }
}

// acc[n] += A B for the D / 8 n-tiles of acc: A the split accumulator
// fragments of four k-steps (32 keys or query rows), B the 32 rows at `b`
// (row stride D + 4; k-step j reads rows 8 j + 2t and 8 j + 2t + 1, column
// 8 n + g), four n-tiles at a time, flushed every FLUSH k-steps
template <int D>
__device__ __forceinline__ void acc_tn(float (*acc)[4], const uint32_t (&hi)[4][4],
                                       const uint32_t (&lo)[4][4], const float* b) {
  constexpr int SD = D + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* b0 = b + 2 * t * SD + g;
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += 4) {
    float part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float bb[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        bb[n][0] = b0[8 * j * SD + 8 * (n0 + n)];
        bb[n][1] = b0[(8 * j + 1) * SD + 8 * (n0 + n)];
      }
      if (j % FLUSH == 0)
        mma3<4, true>(part, hi[j], lo[j], bb);
      else
        mma3<4, false>(part, hi[j], lo[j], bb);
      if (j % FLUSH == FLUSH - 1) flush<4>(acc + n0, part);
    }
  }
}

// ------------------------------------------- backward: dq, drel, delta ---

// NB: n-tiles of the drel product (bins padded to 32, 48 or 128)
template <int D, int NW, int NB>
__global__ void __launch_bounds__(NW * 32) f32_bwd_q_kernel(const Params p) {
  constexpr int NT = NW * 32, ROWS = NW * 16, SD = D + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.kt + p.kh + p.kw, LR = K + 2;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + ROWS * SD;
  float* Ks = Gs + ROWS * SD;      // 2 x BN x SD
  float* Vs = Ks + 2 * BN * SD;    // 2 x BN x SD
  int* ktab = reinterpret_cast<int*>(Vs + 2 * BN * SD);  // 2 x BN
  float* Rs = reinterpret_cast<float*>(ktab + 2 * BN);   // ROWS x LR
  const uint32_t sb = smem_u32(smem);
  const int qtiles = (p.Lq + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / qtiles, q0 = (blockIdx.x - bh * qtiles) * ROWS;
  const int b = bh / p.H, h = bh - b * p.H, HD = p.H * D, col0 = h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ntiles = (p.Lk + BN - 1) / BN, steps = 2 * ntiles;
  const uint32_t kbuf = sb + (uint32_t)(2 * ROWS * SD) * 4, vbuf = kbuf + BN * SD * 8;

  load_rows<D, NT>(sb, SD, p.q, ROWS, b, p.Lq, q0, HD, col0);
  load_rows<D, NT>(sb + ROWS * SD * 4, SD, p.g, ROWS, b, p.Lq, q0, HD, col0);
  load_rows<D, NT>(kbuf, SD, p.k, BN, b, p.Lk, 0, HD, col0);
  load_rows<D, NT>(vbuf, SD, p.v, BN, b, p.Lk, 0, HD, col0);
  cp_commit();
  // the key table of tile 0 and the raw bias rows while the copies are in
  // flight
  for (int j = threadIdx.x; j < BN; j += NT) ktab[j] = key_index(j, p.Lk, p.kt, p.kh, p.kw);
  for (int i = threadIdx.x; i < ROWS * K; i += NT) {
    const int r = i / K, c = i - r * K, row = q0 + r;
    int cc;
    const int part = rel_part(c, p.kt, p.kh, cc);
    Rs[r * LR + c] = row < p.Lq ? p.rel.p[part][((size_t)b * p.Lq + row) * p.rel.ld[part] +
                                                h * p.rel.hs + cc]
                                : 0.f;
  }
  for (int r = threadIdx.x; r < ROWS; r += NT) {
    Rs[r * LR + K] = 0.f;
    Rs[r * LR + K + 1] = -INFINITY;
  }

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int row0 = q0 + r0, row1 = row0 + 8;
  const float lse0 = row0 < p.Lq ? p.lse[(size_t)bh * p.Lq + row0] : 0.f;
  const float lse1 = row1 < p.Lq ? p.lse[(size_t)bh * p.Lq + row1] : 0.f;
  const float* rel0 = Rs + r0 * LR;
  const float* rel1 = rel0 + 8 * LR;
  float dsum0 = 0.f, dsum1 = 0.f;  // rowsum(dp * p): this thread's keys, then the row's
  float dq[D / 8][4], dr[NB][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NB; ++n) dr[n][0] = dr[n][1] = dr[n][2] = dr[n][3] = 0.f;

  for (int it = 0; it < steps; ++it) {  // pass 0 (delta), then pass 1
    const int st = it & 1;
    if (it + 1 < steps) {  // the next tile into the other buffer
      const int nx = it + 1 < ntiles ? it + 1 : it + 1 - ntiles;
      load_rows<D, NT>(kbuf + (st ^ 1) * BN * SD * 4, SD, p.k, BN, b, p.Lk, nx * BN, HD, col0);
      load_rows<D, NT>(vbuf + (st ^ 1) * BN * SD * 4, SD, p.v, BN, b, p.Lk, nx * BN, HD, col0);
      for (int j = threadIdx.x; j < BN; j += NT)
        ktab[(st ^ 1) * BN + j] = key_index(nx * BN + j, p.Lk, p.kt, p.kh, p.kw);
    }
    cp_commit();
    cp_wait<1>();  // every group but the newest: tile `it` (and Q, G) has landed
    if (it == 0) {  // each thread scales the Q elements it copied
      for (int e = threadIdx.x; e < ROWS * (D / 4); e += NT) {
        const int r = e / (D / 4), c = (e - r * (D / 4)) * 4;
        float4* ptr = reinterpret_cast<float4*>(Qs + r * SD + c);
        float4 x = *ptr;
        x.x *= p.scale;
        x.y *= p.scale;
        x.z *= p.scale;
        x.w *= p.scale;
        *ptr = x;
      }
    }
    __syncthreads();

    const float* kt_s = Ks + st * BN * SD;
    const int* kt_tab = ktab + st * BN;
    float sc[4][4], dp[4][4];
    tile_nt<D, false>(sc, Qs + warp * 16 * SD, kt_s, 1.f);
    tile_nt<D, false>(dp, Gs + warp * 16 * SD, Vs + st * BN * SD, 1.f);
    // p = exp(s + bias - lse); keys past Lk have a -inf bias
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int2 e = *reinterpret_cast<const int2*>(kt_tab + 8 * n + 2 * t);
      sc[n][0] = expf(sc[n][0] + bias_at(rel0, e.x) - lse0);
      sc[n][1] = expf(sc[n][1] + bias_at(rel0, e.y) - lse0);
      sc[n][2] = expf(sc[n][2] + bias_at(rel1, e.x) - lse1);
      sc[n][3] = expf(sc[n][3] + bias_at(rel1, e.y) - lse1);
    }
    if (it < ntiles) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        dsum0 = fmaf(sc[n][0], dp[n][0], dsum0);
        dsum0 = fmaf(sc[n][1], dp[n][1], dsum0);
        dsum1 = fmaf(sc[n][2], dp[n][2], dsum1);
        dsum1 = fmaf(sc[n][3], dp[n][3], dsum1);
      }
      if (it == ntiles - 1) {  // delta: the quad's sums, in a fixed order
        dsum0 += __shfl_xor_sync(0xffffffffu, dsum0, 1);
        dsum0 += __shfl_xor_sync(0xffffffffu, dsum0, 2);
        dsum1 += __shfl_xor_sync(0xffffffffu, dsum1, 1);
        dsum1 += __shfl_xor_sync(0xffffffffu, dsum1, 2);
      }
    } else {
      // ds = p * (dp - delta), as the A fragments of dq and drel
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        sc[n][0] *= dp[n][0] - dsum0;
        sc[n][1] *= dp[n][1] - dsum0;
        sc[n][2] *= dp[n][2] - dsum1;
        sc[n][3] *= dp[n][3] - dsum1;
      }
      uint32_t dh[4][4], dl[4][4];
      split_acc(sc, dh, dl);
      acc_tn<D>(dq, dh, dl, kt_s);
      // drel += ds E^T: E's column for key 8 j + 2t (+ 1) holds a one in
      // the rows of its three bins
      int et[4][2], eh[4][2], ew[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int2 e = *reinterpret_cast<const int2*>(kt_tab + 8 * j + 2 * t);
        et[j][0] = e.x & 1023;
        eh[j][0] = (e.x >> 10) & 1023;
        ew[j][0] = e.x >> 20;
        et[j][1] = e.y & 1023;
        eh[j][1] = (e.y >> 10) & 1023;
        ew[j][1] = e.y >> 20;
      }
      constexpr uint32_t ONE = 0x3f800000u;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int bin = 8 * nb + g;
        float part[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b0 =
              (bin == et[j][0] || bin == eh[j][0] || bin == ew[j][0]) ? ONE : 0u;
          const uint32_t b1 =
              (bin == et[j][1] || bin == eh[j][1] || bin == ew[j][1]) ? ONE : 0u;
          if (j % FLUSH == 0)
            mma_z(part, dl[j], b0, b1);
          else
            mma(part, dl[j], b0, b1);
          mma(part, dh[j], b0, b1);
          if (j % FLUSH == FLUSH - 1) {
            dr[nb][0] += part[0];
            dr[nb][1] += part[1];
            dr[nb][2] += part[2];
            dr[nb][3] += part[3];
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= p.Lq) continue;
    const size_t base = ((size_t)b * p.Lq + row) * HD + col0 + 2 * t;
    const bool res = row >= p.res_from;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float2 x = make_float2(dq[n][2 * half] * p.scale, dq[n][2 * half + 1] * p.scale);
      if (res) {
        const float2 gg = *reinterpret_cast<const float2*>(p.g + base + 8 * n);
        x.x += gg.x;
        x.y += gg.y;
      }
      *reinterpret_cast<float2*>(p.dq + base + 8 * n) = x;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int bin = 8 * nb + 2 * t + c;
        if (bin >= K) continue;
        int cc;
        const int part = rel_part(bin, p.kt, p.kh, cc);
        p.drel.p[part][((size_t)b * p.Lq + row) * p.drel.ld[part] + h * p.drel.hs + cc] =
            dr[nb][2 * half + c];
      }
    }
    if (t == 0) p.delta[(size_t)bh * p.Lq + row] = half ? dsum1 : dsum0;
  }
}

// ------------------------------------------ backward: dk, dv partials ---

template <int D>
__global__ void __launch_bounds__(KW * 32) f32_bwd_kv_kernel(const Params p) {
  constexpr int NT = KW * 32, SD = D + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.kt + p.kh + p.kw, LR = K + 2;
  float* Ks = reinterpret_cast<float*>(smem);  // KROWS x SD (this CTA's keys)
  float* Vs = Ks + KROWS * SD;
  float* Qs = Vs + KROWS * SD;     // 2 x BM x SD
  float* Gs = Qs + 2 * BM * SD;    // 2 x BM x SD
  float* Rs = Gs + 2 * BM * SD;    // 2 x BM x LR
  float* Ls = Rs + 2 * BM * LR;    // 2 x BM lse
  float* Ds = Ls + 2 * BM;         // 2 x BM delta
  const uint32_t sb = smem_u32(smem);
  const uint32_t qbuf = sb + (uint32_t)(2 * KROWS * SD) * 4, gbuf = qbuf + BM * SD * 8;
  const int ktiles = (p.Lk + KROWS - 1) / KROWS, per_bh = p.splits * ktiles;
  const int bh = blockIdx.x / per_bh, rem = blockIdx.x - bh * per_bh;
  const int si = rem / ktiles, k0 = (rem - si * ktiles) * KROWS;  // query split si
  const int b = bh / p.H, h = bh - b * p.H, HD = p.H * D, col0 = h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_qt = (p.Lq + BM - 1) / BM, per = (n_qt + p.splits - 1) / p.splits;
  const int qt0 = si * per, qt1 = min(n_qt, qt0 + per);

  // the query tile qt's rows, bias terms, lse and delta into buffer st
  auto load_q = [&](int qt, int st) {
    const int r0 = qt * BM;
    load_rows<D, NT>(qbuf + st * BM * SD * 4, SD, p.q, BM, b, p.Lq, r0, HD, col0);
    load_rows<D, NT>(gbuf + st * BM * SD * 4, SD, p.g, BM, b, p.Lq, r0, HD, col0);
    const uint32_t rb = smem_u32(Rs + st * BM * LR);
    for (int i = threadIdx.x; i < BM * K; i += NT) {
      const int r = i / K, c = i - r * K, row = r0 + r;
      const bool ok = row < p.Lq;
      int cc;
      const int part = rel_part(c, p.kt, p.kh, cc);
      cp4(rb + (r * LR + c) * 4,
          p.rel.p[part] + ((size_t)b * p.Lq + (ok ? row : 0)) * p.rel.ld[part] + h * p.rel.hs +
              cc,
          ok);
    }
    for (int r = threadIdx.x; r < BM; r += NT) {
      const int row = r0 + r;
      const bool ok = row < p.Lq;
      const size_t at = (size_t)bh * p.Lq + (ok ? row : 0);
      cp4(smem_u32(Ls + st * BM + r), p.lse + at, ok);
      cp4(smem_u32(Ds + st * BM + r), p.delta + at, ok);
    }
  };

  load_rows<D, NT>(sb, SD, p.k, KROWS, b, p.Lk, k0, HD, col0);
  load_rows<D, NT>(sb + KROWS * SD * 4, SD, p.v, KROWS, b, p.Lk, k0, HD, col0);
  if (qt0 < qt1) load_q(qt0, 0);
  cp_commit();
  // the bias rows' constant columns: 0 (the cls key) and -inf (keys past Lk)
  for (int r = threadIdx.x; r < 2 * BM; r += NT) {
    Rs[r * LR + K] = 0.f;
    Rs[r * LR + K + 1] = -INFINITY;
  }
  const int kr = warp * 16 + g;  // this thread's keys: kr and kr + 8 of the CTA
  const int e0 = key_index(k0 + kr, p.Lk, p.kt, p.kh, p.kw);
  const int e1 = key_index(k0 + kr + 8, p.Lk, p.kt, p.kh, p.kw);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int qt = qt0; qt < qt1; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < qt1) load_q(qt + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();  // every group but the newest: tile qt (and K, V) has landed
    __syncthreads();

    const float* q_s = Qs + st * BM * SD;
    const float* g_s = Gs + st * BM * SD;
    const float* r_s = Rs + st * BM * LR;
    const float* l_s = Ls + st * BM;
    const float* d_s = Ds + st * BM;
    const int nvalid = p.Lq - qt * BM;  // query rows of the tile inside Lq
    // p^T = exp(s^T + bias - lse): rows are this warp's keys, columns the
    // tile's query rows (8 n + 2t, + 1); padded rows give p = 0
    float sc[4][4];
    tile_nt<D, true>(sc, Ks + warp * 16 * SD, q_s, p.scale);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * n + 2 * t + (c & 1);
        const float x = expf(sc[n][c] + bias_at(r_s + col * LR, c < 2 ? e0 : e1) - l_s[col]);
        sc[n][c] = col < nvalid ? x : 0.f;
      }
    }
    uint32_t xh[4][4], xl[4][4];
    split_acc(sc, xh, xl);
    acc_tn<D>(dv, xh, xl, g_s);  // dv += p^T G
    float dp[4][4];
    tile_nt<D, false>(dp, Vs + warp * 16 * SD, g_s, 1.f);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[n][c] *= dp[n][c] - d_s[8 * n + 2 * t + (c & 1)];
    }
    split_acc(sc, xh, xl);
    acc_tn<D>(dk, xh, xl, q_s);  // dk += ds^T Q (scaled below)
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // this split's partial sums (or, unsplit, dk and dv themselves)
  const size_t plane = (size_t)p.splits * p.B * p.Lk * HD;
  float* dk_out = p.splits > 1 ? p.work + (size_t)si * p.B * p.Lk * HD : p.dk;
  float* dv_out = p.splits > 1 ? p.work + plane + (size_t)si * p.B * p.Lk * HD : p.dv;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + kr + 8 * half;
    if (key >= p.Lk) continue;
    const size_t base = ((size_t)b * p.Lk + key) * HD + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dk_out + base + 8 * n) =
          make_float2(dk[n][2 * half] * p.scale, dk[n][2 * half + 1] * p.scale);
      *reinterpret_cast<float2*>(dv_out + base + 8 * n) =
          make_float2(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

__global__ void f32_reduce_kernel(const float* __restrict__ work, float* __restrict__ dk,
                                  float* __restrict__ dv, long long n, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < splits; ++s) {
      sk += work[(size_t)s * n + i];
      sv += work[((size_t)splits + s) * n + i];
    }
    dk[i] = sk;
    dv[i] = sv;
  }
}

// --------------------------------------------------------------- host ---

// The plan: query rows per q-major CTA, 64 (four warps) where that gives
// every SM a CTA, else 32, else 16; the drel product's N, the bins padded
// to 32, 48 or 128; query splits of the k-major kernel, the count (none
// empty, at most MAX_WAVES waves of CTAs) that gives the fewest query tiles
// per CTA times waves of CTAs over the card (two per SM where two fit), the
// fewest splits on a tie: a CTA walks its split's tiles serially, and a
// last wave that fills a third of the card costs a whole wave; the cap
// keeps the split partials' workspace small. Mirrored by `f32_bwd_plan` in
// ops/attention.py.
int q_rows(int BH, int Lq) {
  if (BH * ((Lq + 63) / 64) >= NUM_SMS) return 64;
  return BH * ((Lq + 31) / 32) >= NUM_SMS ? 32 : 16;
}

int pad_bins(int K) { return K <= 32 ? 32 : (K <= 48 ? 48 : 128); }

int plan_splits(int BH, int Lq, int Lk, int D, int K) {
  const int ctas = BH * ((Lk + KROWS - 1) / KROWS), n_qt = (Lq + BM - 1) / BM;
  const long long slots = (2 * (k_smem(D, K) + 1024) <= SM_SMEM ? 2 : 1) * NUM_SMS;
  const long long cap = MAX_WAVES * slots / ctas;
  long long best = -1;
  int splits = 1;
  for (int s = 1; s <= n_qt && (s == 1 || s <= cap); ++s) {
    const int per = (n_qt + s - 1) / s;
    if ((n_qt + per - 1) / per != s) continue;  // a split would be empty
    const long long cost = ((long long)ctas * s + slots - 1) / slots * per;
    if (best < 0 || cost < best) {
      best = cost;
      splits = s;
    }
  }
  return splits;
}

template <typename KernelT>
int launch(KernelT kernel, int grid, int threads, int smem, cudaStream_t s, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D, int NW>
int launch_q(const Params& p, int nb, int smem, cudaStream_t s) {
  const int grid = p.B * p.H * ((p.Lq + 16 * NW - 1) / (16 * NW));
  if (nb == 32) return launch(f32_bwd_q_kernel<D, NW, 4>, grid, NW * 32, smem, s, p);
  if (nb == 48) return launch(f32_bwd_q_kernel<D, NW, 6>, grid, NW * 32, smem, s, p);
  return launch(f32_bwd_q_kernel<D, NW, 16>, grid, NW * 32, smem, s, p);
}

template <int D>
int bwd(const Params& p, cudaStream_t s) {
  const int K = p.kt + p.kh + p.kw, rows = q_rows(p.B * p.H, p.Lq), nb = pad_bins(K);
  const int sq = q_smem(D, rows, K), sk = k_smem(D, K);
  if (sq > SMEM_MAX || sk > SMEM_MAX) return (int)cudaErrorInvalidValue;
  int rc = rows == 64 ? launch_q<D, 4>(p, nb, sq, s)
                      : (rows == 32 ? launch_q<D, 2>(p, nb, sq, s) : launch_q<D, 1>(p, nb, sq, s));
  if (rc != 0) return rc;
  const int kgrid = p.B * p.H * p.splits * ((p.Lk + KROWS - 1) / KROWS);
  rc = launch(f32_bwd_kv_kernel<D>, kgrid, KW * 32, sk, s, p);
  if (rc != 0 || p.splits == 1) return rc;
  const long long n = (long long)p.B * p.Lk * p.H * D;
  const long long blocks = (n + 255) / 256;
  f32_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(p.work, p.dk, p.dv,
                                                                            n, p.splits);
  return (int)cudaGetLastError();
}

int run_bwd(const Params& p, int D, void* stream) {
  const int K = p.kt + p.kh + p.kw;
  if ((D != 64 && D != 96 && D != 128) || p.Lq < 1 || p.Lk < 1 || K < 1 || K > MAX_K ||
      p.lse == nullptr || p.splits != plan_splits(p.B * p.H, p.Lq, p.Lk, D, K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? bwd<64>(p, s) : (D == 96 ? bwd<96>(p, s) : bwd<128>(p, s));
}

RelIn<float> packed_rel(const void* rel, int H, int kt, int kh, int kw) {
  const float* r = static_cast<const float*>(rel);
  const int K = kt + kh + kw;
  return {{r, r + kt, r + kt + kh}, {H * K, H * K, H * K}, K};
}

}  // namespace

// K5 in f32: as dsal_bias_attention_f32 plus g, lse (B, H, Lq) from the
// forward, outputs dq, dk, dv, drel, workspaces delta (B, H, Lq) and work
// (2, splits, B, Lk, H*D); `splits` as `f32_bwd_plan` gives it (the entry
// refuses another)
extern "C" int dsal_bias_attention_bwd_f32(const void* q, const void* k, const void* v,
                                           const void* rel, const void* g, const void* lse,
                                           void* dq, void* dk, void* dv, void* drel, void* delta,
                                           void* work, int B, int Lq, int Lk, int H, int D,
                                           int kt, int kh, int kw, int splits, float scale,
                                           int residual, void* stream) {
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.g = static_cast<const float*>(g);
  p.lse = static_cast<const float*>(lse);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.delta = static_cast<float*>(delta);
  p.work = static_cast<float*>(work);
  p.rel = packed_rel(rel, H, kt, kh, kw);
  float* dr = static_cast<float*>(drel);
  const int K = kt + kh + kw;
  p.drel = {{dr, dr + kt, dr + kt + kh}, {H * K, H * K, H * K}, K};
  p.B = B; p.Lq = Lq; p.Lk = Lk; p.H = H; p.kt = kt; p.kh = kh; p.kw = kw;
  p.res_from = residual ? 0 : Lq;
  p.splits = splits;
  p.scale = scale;
  return run_bwd(p, D, stream);
}

// K12's backward in f32: (BH, L, D) layouts, three rel and drel tensors
extern "C" int dsal_cls_attention_bwd_f32(const void* q, const void* k, const void* v,
                                          const void* rel_t, const void* rel_h, const void* rel_w,
                                          const void* g, const void* lse, void* dq, void* dk,
                                          void* dv, void* drel_t, void* drel_h, void* drel_w,
                                          void* delta, void* work, int BH, int Lq, int Lk, int D,
                                          int kt, int kh, int kw, int splits, float scale,
                                          int residual, void* stream) {
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.g = static_cast<const float*>(g);
  p.lse = static_cast<const float*>(lse);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.delta = static_cast<float*>(delta);
  p.work = static_cast<float*>(work);
  p.rel = {{static_cast<const float*>(rel_t), static_cast<const float*>(rel_h),
            static_cast<const float*>(rel_w)}, {kt, kh, kw}, 0};
  p.drel = {{static_cast<float*>(drel_t), static_cast<float*>(drel_h),
             static_cast<float*>(drel_w)}, {kt, kh, kw}, 0};
  p.B = BH; p.Lq = Lq; p.Lk = Lk; p.H = 1; p.kt = kt; p.kh = kh; p.kw = kw;
  p.res_from = residual ? 1 : Lq;
  p.splits = splits;
  p.scale = scale;
  return run_bwd(p, D, stream);
}
