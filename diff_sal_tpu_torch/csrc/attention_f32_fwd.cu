// K1 and K12 forward in f32, on the tensor cores: the instances an f32 model
// (both packages' default compute dtype) runs on the card.
//
// Replaces, for f32 inputs, the TPU kernels diff_sal_tpu/ops/attention.py:601
// fused_bias_attention_v2 (body _attn_v2_kernel :477) and :119
// fused_bias_attention (body _attn_kernel :62), which take f32 as they take
// bf16. Per (batch, head):
//   out = softmax(q k^T * scale + bias) v (+ q on rows >= res_from)
//   bias[l, j] = (rel_t[l, t(j)] + rel_h[l, h(j)]) + rel_w[l, w(j)], j >= 1,
// key 0 (cls) without bias; each row's logsumexp (natural base) when asked,
// which the f32 backward (csrc/attention_f32.cu) reads. Nothing is rounded
// between the steps, as the plain versions compute at f32.
//
// What bounds it: operations (4 Lq Lk D flops per head against one pass over
// q, k, v, rel and out). f32 FFMA peaks at ~67 TFLOP/s. The tensor cores
// take f32 only as TF32 (10 mantissa bits), but split TF32 keeps about
// f32's accuracy: x = hi + lo with hi = x rounded to TF32 and lo = x - hi
// (exact), and a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b, small
// products first, f32 accumulation (the dropped lo lo term is ~2^-22 of
// |a b|; the split itself is Veltkamp's, exact, on the f32 pipe). Three
// TF32 products run at 495 / 3 = 165 TFLOP/s, 2.5x the FFMA peak.
//
// The design:
// - A CTA of NW warps (4 or 8) owns 16 NW query rows of one (batch, head);
//   each warp owns 16 rows and runs mma.sync m16n8k8 .tf32 on its fragments
//   (register operands: no shared-memory descriptors, no transposed copies).
// - K and V tiles of BN keys (64, or 32 where shared memory is short) come
//   by cp.async (16 bytes a thread, rows past L zero-filled) into a double
//   buffer: tile i + 1 is in flight while tile i is computed. Q is loaded
//   once and scaled in place (q * scale rounded in f32, as the plain
//   version rounds it).
// - Operands are split into hi and lo in registers as their fragments are
//   loaded. The reduction index of each product is permuted so that a
//   thread's fragment elements are adjacent: in S = Q K^T the k-step's
//   columns t and t + 4 are head-dim columns 2t and 2t + 1 (one 8-byte
//   load from Q and one from K); in O += P V they are keys 2t and 2t + 1,
//   exactly the two columns of the S accumulator the thread holds, so P
//   goes from the S accumulator to the A operand without a shuffle. Row
//   strides (D + 8 floats for Q and K, D + 4 for V) make every fragment
//   load free of bank conflicts.
// - The bias is added in registers from a per-row table in shared memory
//   ([K raw terms | 0 | -inf], csrc/attention_bias.cuh) through a key table
//   of each key's three indices (cls -> zeros, keys past Lk -> -inf), summed
//   in the plain versions' order.
// - Online softmax in f32 registers: each thread holds two rows, the row
//   max and sum reduce over the 4 lanes of a quad; O stays in registers.
// - Epilogue: O / l, the residual q (unscaled, from device memory) added in
//   f32; the logsumexp m + log l.
// - Grids with fewer row tiles than SMs (small models) split each row
//   tile's keys over a thread-block cluster of 2-8 CTAs, whose partials are
//   combined through distributed shared memory (`combine`): a CTA's key
//   loop is serial, so otherwise most of the card idles.
// The launch geometry (rows per CTA, keys per tile, shared memory) is chosen
// here and mirrored by `f32_fwd_plan` in ops/attention.py, which the CPU
// tests check.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bias.cuh"
#include "tf32.cuh"

namespace {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory one CTA may use
constexpr int SM_SMEM = 233472;   // shared memory of an SM (each CTA also holds 1 KB)
constexpr int NUM_SMS = 132;
constexpr int MAX_K = 128;  // kt + kh + kw
constexpr int MAX_SPLITS = 8;  // CTAs of a cluster that share one row tile's keys
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float *q, *k, *v;
  float *out, *lse;
  RelIn<float> rel;
  int B, Lq, Lk, H, kt, kh, kw, res_from, ntiles, qtiles, splits;
  float scale;
};

// Byte offsets into the dynamic shared memory: Q (rows x D + 8), the K and
// V double buffers (BN x D + 8, BN x D + 4), the key table (one int per key
// of every tile) and the bias rows (rows x K + 2). Mirrored by
// `f32_fwd_smem` in ops/attention.py.
struct Smem {
  int q, k, v, ktab, rel, total;
};

__host__ __device__ inline Smem smem_layout(int D, int rows, int bn, int ntiles, int K) {
  Smem s;
  int off = 0;
  s.q = off;    off += rows * (D + 8) * 4;
  s.k = off;    off += 2 * bn * (D + 8) * 4;
  s.v = off;    off += 2 * bn * (D + 4) * 4;
  s.ktab = off; off += ntiles * bn * 4;
  s.rel = off;  off += rows * (K + 2) * 4;
  s.total = off;
  return s;
}

// `n` rows [row0, row0 + n) of one head (columns col0 .. col0 + D) of a
// (B, L, HD) tensor into shared memory at row stride ld floats; rows past L
// are zeros
template <int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, int ld, const float* __restrict__ src,
                                          int n, int b, int L, int row0, int HD, int col0) {
  constexpr int V4 = D / 4;
  for (int i = threadIdx.x; i < n * V4; i += NT) {
    const int r = i / V4, c = (i - r * V4) * 4, row = row0 + r;
    const bool ok = row < L;
    cp16(dst + (r * ld + c) * 4, src + ((size_t)b * L + (ok ? row : 0)) * HD + col0 + c, ok);
  }
}

// A row tile whose keys were split over the S CTAs of a cluster: each CTA
// leaves its unnormalised O, row max m and row sum l in its shared memory
// (O over its Q buffer, m and l over its bias rows; the tile loop has
// ended with a CTA barrier), then, after a cluster barrier, CTA rank r
// finishes rows r, r + S, .. from all S partials through distributed
// shared memory, in rank order: M = max m_s, L = sum e^(m_s - M) l_s,
// out = sum e^(m_s - M) O_s / L (+ q), lse = M + log L. A second cluster
// barrier keeps every CTA's shared memory until the others have read it.
template <int D, int NW>
__device__ __forceinline__ void combine(const Params& p, const float (&o)[D / 8][4], float m0,
                                        float m1, float l0, float l1, float* Qs, float* Rs,
                                        int b, int bh, int q0, int col0) {
  constexpr int NT = NW * 32, ROWS = NW * 16, SQ = D + 8;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.splits, rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
  float* Ms = Rs;
  float* Ls = Rs + ROWS;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(Qs + r * SQ + 8 * n + 2 * t) =
          make_float2(o[n][2 * half], o[n][2 * half + 1]);
    if (t == 0) {
      Ms[r] = half ? m1 : m0;
      Ls[r] = half ? l1 : l0;
    }
  }
  cluster.sync();
  const float* Os_r[MAX_SPLITS];
  const float* Ms_r[MAX_SPLITS];
  for (int s = 0; s < S; ++s) {
    Os_r[s] = cluster.map_shared_rank(Qs, s);
    Ms_r[s] = cluster.map_shared_rank(Rs, s);
  }
  // per row of this CTA: each split's weight e^(m_s - M) / L and the
  // logsumexp, into the bias rows past m and l (K >= 3 leaves room)
  const int mine = (ROWS - rank + S - 1) / S, HD = p.H * D;
  float* Wt = Rs + 2 * ROWS;
  for (int i = threadIdx.x; i < mine; i += NT) {
    const int r = rank + i * S;
    float M = -INFINITY;
    for (int s = 0; s < S; ++s) M = fmaxf(M, Ms_r[s][r]);
    float L = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = expf(Ms_r[s][r] - M);
      Wt[i * (S + 1) + s] = w;
      L = fmaf(w, Ms_r[s][ROWS + r], L);
    }
    for (int s = 0; s < S; ++s) Wt[i * (S + 1) + s] /= L;
    Wt[i * (S + 1) + S] = M + logf(L);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < mine * D; e += NT) {
    const int i = e / D, c = e - i * D, r = rank + i * S, row = q0 + r;
    if (row >= p.Lq) continue;
    float x = 0.f;
    for (int s = 0; s < S; ++s) x = fmaf(Wt[i * (S + 1) + s], Os_r[s][r * SQ + c], x);
    const size_t at = ((size_t)b * p.Lq + row) * HD + col0 + c;
    if (row >= p.res_from) x += p.q[at];
    p.out[at] = x;
    if (c == 0 && p.lse != nullptr) p.lse[(size_t)bh * p.Lq + row] = Wt[i * (S + 1) + S];
  }
  cluster.sync();
}

template <int D, int NW, int BN>
__global__ void __launch_bounds__(NW * 32) f32_attn_fwd(const Params p) {
  constexpr int NT = NW * 32, ROWS = NW * 16, SQ = D + 8, SK = D + 8, SV = D + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.kt + p.kh + p.kw, LR = K + 2;
  const Smem L = smem_layout(D, ROWS, BN, p.ntiles, K);
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  const float* Ks = reinterpret_cast<const float*>(smem + L.k);
  const float* Vs = reinterpret_cast<const float*>(smem + L.v);
  int* ktab = reinterpret_cast<int*>(smem + L.ktab);
  float* Rs = reinterpret_cast<float*>(smem + L.rel);
  const uint32_t sb = smem_u32(smem);
  // a cluster of `splits` CTAs shares one row tile; rank r takes key tiles
  // [t_begin, t_end)
  const int S = p.splits, tile = blockIdx.x / S, rank = blockIdx.x - tile * S;
  const int per = (p.ntiles + S - 1) / S, t_begin = rank * per;
  const int t_end = t_begin + per < p.ntiles ? t_begin + per : p.ntiles;
  const int bh = tile / p.qtiles, q0 = (tile - bh * p.qtiles) * ROWS;
  const int b = bh / p.H, h = bh - b * p.H, HD = p.H * D, col0 = h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  load_tile<D, NT>(sb + L.q, SQ, p.q, ROWS, b, p.Lq, q0, HD, col0);
  load_tile<D, NT>(sb + L.k, SK, p.k, BN, b, p.Lk, t_begin * BN, HD, col0);
  load_tile<D, NT>(sb + L.v, SV, p.v, BN, b, p.Lk, t_begin * BN, HD, col0);
  cp_commit();
  // the key table and the raw bias rows while the first copies are in flight
  for (int j = threadIdx.x; j < p.ntiles * BN; j += NT)
    ktab[j] = key_index(j, p.Lk, p.kt, p.kh, p.kw);
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
  const float* qrow0 = Qs + r0 * SQ + 2 * t;
  const float* qrow1 = qrow0 + 8 * SQ;
  const float* rel0 = Rs + r0 * LR;
  const float* rel1 = rel0 + 8 * LR;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int i = t_begin; i < t_end; ++i) {
    const int st = (i - t_begin) & 1;
    if (i + 1 < t_end) {  // the next tile into the other buffer
      load_tile<D, NT>(sb + L.k + (st ^ 1) * BN * SK * 4, SK, p.k, BN, b, p.Lk, (i + 1) * BN,
                       HD, col0);
      load_tile<D, NT>(sb + L.v + (st ^ 1) * BN * SV * 4, SV, p.v, BN, b, p.Lk, (i + 1) * BN,
                       HD, col0);
    }
    cp_commit();
    cp_wait<1>();  // every group but the newest: tile i (and Q) has landed
    if (i == t_begin) {  // each thread scales the Q elements it copied
      for (int e = threadIdx.x; e < ROWS * (D / 4); e += NT) {
        const int r = e / (D / 4), c = (e - r * (D / 4)) * 4;
        float4* ptr = reinterpret_cast<float4*>(Qs + r * SQ + c);
        float4 x = *ptr;
        x.x *= p.scale;
        x.y *= p.scale;
        x.z *= p.scale;
        x.w *= p.scale;
        *ptr = x;
      }
    }
    __syncthreads();

    // S = (q * scale) K^T: k-step kk takes head-dim columns 8 kk + 2t, + 1
    const float* kt_s = Ks + st * BN * SK + g * SK + 2 * t;
    float sc[BN / 8][4], part[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(qrow0 + 8 * kk);
      const float2 x1 = *reinterpret_cast<const float2*>(qrow1 + 8 * kk);
      uint32_t ah[4], al[4];
      split(x0.x, ah[0], al[0]);
      split(x1.x, ah[1], al[1]);
      split(x0.y, ah[2], al[2]);
      split(x1.y, ah[3], al[3]);
      float kb[BN / 8][2];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(kt_s + 8 * n * SK + 8 * kk);
        kb[n][0] = y.x;
        kb[n][1] = y.y;
      }
      if (kk % FLUSH == 0)
        mma3<BN / 8, true>(part, ah, al, kb);
      else
        mma3<BN / 8, false>(part, ah, al, kb);
      if (kk % FLUSH == FLUSH - 1 || kk == D / 8 - 1) flush<BN / 8>(sc, part);
    }

    // bias (keys past Lk -> -inf), online softmax of rows r0 and r0 + 8
    const int* kt_tile = ktab + i * BN + 2 * t;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int2 e = *reinterpret_cast<const int2*>(kt_tile + 8 * n);
      sc[n][0] += bias_at(rel0, e.x);
      sc[n][1] += bias_at(rel0, e.y);
      sc[n][2] += bias_at(rel1, e.x);
      sc[n][3] += bias_at(rel1, e.y);
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds a valid key, so the new max is finite
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    // exp(s - m) as 2^((s - m) log2 e): the difference first, so the
    // exponent's rounding error scales with s - m, not with m
    const float alpha0 = ex2((m0 - n0) * LOG2E), alpha1 = ex2((m1 - n1) * LOG2E);
    m0 = n0;
    m1 = n1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      sc[n][0] = ex2((sc[n][0] - n0) * LOG2E);
      sc[n][1] = ex2((sc[n][1] - n0) * LOG2E);
      sc[n][2] = ex2((sc[n][2] - n1) * LOG2E);
      sc[n][3] = ex2((sc[n][3] - n1) * LOG2E);
      s0 += sc[n][0] + sc[n][1];
      s1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * alpha0 + s0;
    l1 = l1 * alpha1 + s1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += P V: k-step j takes keys 8 j + 2t, + 1, the S columns this
    // thread holds
    const float* vt = Vs + st * BN * SV + 2 * t * SV + g;
    float ot[D / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      uint32_t ah[4], al[4];
      split(sc[j][0], ah[0], al[0]);
      split(sc[j][2], ah[1], al[1]);
      split(sc[j][1], ah[2], al[2]);
      split(sc[j][3], ah[3], al[3]);
      const float* v0 = vt + 8 * j * SV;
#pragma unroll
      for (int n0 = 0; n0 < D / 8; n0 += 4) {  // four n-tiles at a time
        float vb[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          vb[n][0] = v0[8 * (n0 + n)];
          vb[n][1] = v0[SV + 8 * (n0 + n)];
        }
        if (j % FLUSH == 0)
          mma3<4, true>(ot + n0, ah, al, vb);
        else
          mma3<4, false>(ot + n0, ah, al, vb);
      }
      if (j % FLUSH == FLUSH - 1 || j == BN / 8 - 1) flush<D / 8>(o, ot);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (S > 1) {
    combine<D, NW>(p, o, m0, m1, l0, l1, Qs, Rs, b, bh, q0, col0);
    return;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + 8 * half;
    if (row >= p.Lq) continue;
    const float l = half ? l1 : l0, inv = 1.f / l;
    if (p.lse != nullptr && t == 0) p.lse[(size_t)bh * p.Lq + row] = (half ? m1 : m0) + logf(l);
    const size_t base = ((size_t)b * p.Lq + row) * HD + col0 + 2 * t;
    const bool res = row >= p.res_from;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float2 x = make_float2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
      if (res) {
        const float2 qq = *reinterpret_cast<const float2*>(p.q + base + 8 * n);
        x.x += qq.x;
        x.y += qq.y;
      }
      *reinterpret_cast<float2*>(p.out + base + 8 * n) = x;
    }
  }
}

template <int D, int NW, int BN>
int launch(const Params& p, int smem, cudaStream_t s) {
  static int smem_set = 0;  // the attribute only grows; set it once per size
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(f32_attn_fwd<D, NW, BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.H * p.qtiles * p.splits);
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, f32_attn_fwd<D, NW, BN>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const Params& p, int rows, int bn, int smem, cudaStream_t s) {
  if (rows == 128) return bn == 64 ? launch<D, 8, 64>(p, smem, s) : launch<D, 8, 32>(p, smem, s);
  return bn == 64 ? launch<D, 4, 64>(p, smem, s) : launch<D, 4, 32>(p, smem, s);
}

// The plan: 128 rows per CTA (8 warps share each K/V tile) where that
// still gives every SM a CTA, else 64. 64-key tiles, unless 32-key tiles
// let two CTAs share an SM where 64 do not and the grid holds more CTAs than
// SMs, or 64 do not fit; refused where neither fits. Where the row tiles
// are fewer than the SMs, the keys are split over a cluster of up to eight
// CTAs (`combine`), at most two CTAs per SM in all.
int run(Params p, int D, void* stream) {
  const int K = p.kt + p.kh + p.kw;
  if ((D != 64 && D != 96 && D != 128) || p.Lq < 1 || p.Lk < 1 || K < 1 || K > MAX_K)
    return (int)cudaErrorInvalidValue;
  const int first = p.B * p.H * ((p.Lq + 127) / 128) >= NUM_SMS ? 128 : 64;
  for (int rows = first; rows >= 64; rows /= 2) {
    const int ctas = p.B * p.H * ((p.Lq + rows - 1) / rows);
    const Smem L64 = smem_layout(D, rows, 64, (p.Lk + 63) / 64, K);
    const Smem L32 = smem_layout(D, rows, 32, (p.Lk + 31) / 32, K);
    int bn = L64.total <= SMEM_MAX ? 64 : 0;
    if (L32.total <= SMEM_MAX &&
        (bn == 0 || (ctas > NUM_SMS && 2 * (L32.total + 1024) <= SM_SMEM &&
                     2 * (L64.total + 1024) > SM_SMEM)))
      bn = 32;
    if (bn == 0) continue;
    p.splits = 1;
    if (ctas < NUM_SMS && p.Lk > 32 && L32.total <= SMEM_MAX) {
      // too few row tiles for the card: split the keys over a cluster of
      // up to MAX_SPLITS CTAs, at most two CTAs per SM in all (32-key tiles
      // where two fit)
      if (2 * (L32.total + 1024) <= SM_SMEM) bn = 32;
      const int nt = (p.Lk + bn - 1) / bn, want = 2 * NUM_SMS / ctas;
      int split = want < MAX_SPLITS ? want : MAX_SPLITS;
      split = split < nt ? split : nt;
      const int per = (nt + split - 1) / split;
      p.splits = (nt + per - 1) / per;  // no split without a key tile
    }
    const Smem& L = bn == 64 ? L64 : L32;
    p.ntiles = (p.Lk + bn - 1) / bn;
    p.qtiles = (p.Lq + rows - 1) / rows;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return D == 64 ? launch_d<64>(p, rows, bn, L.total, s)
                   : (D == 96 ? launch_d<96>(p, rows, bn, L.total, s)
                              : launch_d<128>(p, rows, bn, L.total, s));
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K1 in f32: q (B, Lq, H*D), k, v (B, Lk, H*D), rel (B, Lq, H, kt+kh+kw),
// out, all f32; lse (B, H, Lq) f32 or null; the residual covers every row
extern "C" int dsal_bias_attention_f32(const void* q, const void* k, const void* v,
                                       const void* rel, void* out, void* lse, int B, int Lq,
                                       int Lk, int H, int D, int kt, int kh, int kw, float scale,
                                       int residual, void* stream) {
  const float* r = static_cast<const float*>(rel);
  const int K = kt + kh + kw;
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.rel = {{r, r + kt, r + kt + kh}, {H * K, H * K, H * K}, K};
  p.B = B; p.Lq = Lq; p.Lk = Lk; p.H = H; p.kt = kt; p.kh = kh; p.kw = kw;
  p.res_from = residual ? 0 : Lq;
  p.scale = scale;
  return run(p, D, stream);
}

// K12 in f32: q, k, v, out (BH, L, D) with cls at row 0; rel_t/h/w (BH, Lq,
// kt/kh/kw); lse (BH, Lq) or null; the residual skips row 0
extern "C" int dsal_cls_attention_f32(const void* q, const void* k, const void* v,
                                      const void* rel_t, const void* rel_h, const void* rel_w,
                                      void* out, void* lse, int BH, int Lq, int Lk, int D, int kt,
                                      int kh, int kw, float scale, int residual, void* stream) {
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.rel = {{static_cast<const float*>(rel_t), static_cast<const float*>(rel_h),
            static_cast<const float*>(rel_w)}, {kt, kh, kw}, 0};
  p.B = BH; p.Lq = Lq; p.Lk = Lk; p.H = 1; p.kt = kt; p.kh = kh; p.kw = kw;
  p.res_from = residual ? 1 : Lq;
  p.scale = scale;
  return run(p, D, stream);
}
