// K1: pooled attention with decomposed (T, H, W) rel-pos bias and residual
// pooling, flash-style forward.
//
// Replaces the TPU kernel diff_sal_tpu/ops/attention.py:601
// fused_bias_attention_v2 (body _attn_v2_kernel :477). Per (batch, head):
//   out = softmax(q k^T * scale + bias) v (+ q when residual)
//   bias[l, j] = rel[l, t(j)] + rel[l, kt + h(j)] + rel[l, kt + kh + w(j)], j >= 1
// with (t, h, w) = unravel(j - 1) over (kt, kh, kw); key 0 (cls) gets zero.
//
// Bound by operations on the H100 (4 * Lq * Lk * D flops per head against
// one pass over q, k, v, rel and out). One CTA of four warps owns 64 query
// rows of one (batch, head); K/V tiles of 64 keys stream through shared
// memory. Each warp computes its 16 rows of S = Q K^T with WMMA (bf16 in, f32
// accumulation), runs the online softmax in f32 with the bias taken from
// index math on each key column's (t, h, w) (columns past Lk masked, never
// padded in memory), rescales its rows of the f32 output tile and adds P V
// with WMMA. The score matrix never leaves shared memory. head_dim D is a
// template parameter (64, 96 or 128: multiples of 16, so no padding).
//
// Rounding follows the TPU kernel: q * scale rounded to bf16 before the
// product; unnormalized probabilities rounded to bf16 for the P V product;
// the row sum kept in f32 and applied after it; residual q added in f32
// before the single rounding of the output.
//
// K12 is the same kernel on MViT's token-concat layout. It replaces the TPU
// kernel diff_sal_tpu/ops/attention.py:119 fused_bias_attention (body
// _attn_kernel :62): q, k, v (B*heads, L, D) with the cls token at row 0 of q
// as well as of k and v, the bias as three f32 tensors rel_t (B*heads, Lq,
// kt), rel_h (.., kh), rel_w (.., kw) whose row 0 the caller zeroes, and the
// residual added to rows >= 1 only. The layout is K1's with B*heads batches
// of one head; the rel parts are read through per-part pointers and row
// strides (RelIn), so one template serves both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;  // query rows per CTA
constexpr int BN = 64;  // keys per tile
constexpr int NW = 4;   // warps; warp w owns rows [16w, 16w + 16)
constexpr int NT = NW * 32;
constexpr float LOG2E = 1.4426950408889634f;

struct Layout {
  int ldq, lds, ldp, ldo;
  size_t q, k, v, s, p, o, r, total;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline Layout make_layout(int D, int K) {
  Layout L;
  L.ldq = D + 8;   // bf16 Q/K/V rows, padded against bank conflicts
  L.lds = BN + 4;  // f32 scores
  L.ldp = BN + 8;  // bf16 probabilities
  L.ldo = D + 4;   // f32 output accumulator
  size_t off = 0;
  L.q = off; off = align128(off + (size_t)BM * L.ldq * 2);
  L.k = off; off = align128(off + (size_t)BN * L.ldq * 2);
  L.v = off; off = align128(off + (size_t)BN * L.ldq * 2);
  L.s = off; off = align128(off + (size_t)BM * L.lds * 4);
  L.p = off; off = align128(off + (size_t)BM * L.ldp * 2);
  L.o = off; off = align128(off + (size_t)BM * L.ldo * 4);
  L.r = off; off = align128(off + (size_t)BM * K * 4);
  L.total = off;
  return L;
}

// Where the three parts (t, h, w) of the bias terms of one query row lie:
// element c of part p for (batch b, row, head h) is at
// p[part][(b * Lq + row) * ld[part] + h * hs + c]. K1: one packed bf16
// (B, Lq, H, kt + kh + kw) tensor; K12: three f32 tensors of one head.
template <typename R>
struct RelIn {
  const R* p[3];
  int ld[3];
  int hs;
};

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

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

// residual q is added to the output rows >= res_from (K1: 0, K12: 1; no
// residual: Lq)
template <int D, typename R>
__global__ void __launch_bounds__(NT) bias_attn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const RelIn<R> rel, bf16* __restrict__ out, int Lq, int Lk, int H, int kt, int kh, int kw,
    float scale, int res_from) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = kt + kh + kw;
  const Layout L = make_layout(D, K);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  float* Os = reinterpret_cast<float*>(smem + L.o);
  float* Rs = reinterpret_cast<float*>(smem + L.r);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HD = H * D;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  const int r0 = warp * 16;
  const int khw = kh * kw;

  // Q tile, scaled in bf16; rows past Lq are zero
  for (int i = tid; i < BM * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8, row = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row < Lq) raw = *reinterpret_cast<const uint4*>(q + ((size_t)b * Lq + row) * HD + h * D + c);
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    *reinterpret_cast<uint4*>(Qs + r * L.ldq + c) = raw;
  }
  // rel tile in f32
  for (int i = tid; i < BM * K; i += NT) {
    const int r = i / K, c = i - r * K, row = q0 + r;
    int cc;
    const int part = rel_part(c, kt, kh, cc);
    Rs[i] = row < Lq ? to_f32(rel.p[part][((size_t)b * Lq + row) * rel.ld[part] + h * rel.hs + cc])
                     : 0.f;
  }
  for (int i = tid; i < BM * L.ldo; i += NT) Os[i] = 0.f;

  float m_run[16], l_run[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  for (int j0 = 0; j0 < Lk; j0 += BN) {
    __syncthreads();  // everyone is done with the previous K/V tile
    for (int i = tid; i < BN * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8, j = j0 + r;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (j < Lk) {
        const size_t off = ((size_t)b * Lk + j) * HD + h * D + c;
        kr = *reinterpret_cast<const uint4*>(k + off);
        vr = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * L.ldq + c) = kr;
      *reinterpret_cast<uint4*>(Vs + r * L.ldq + c) = vr;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[D / 16];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wmma::load_matrix_sync(a[kk], Qs + r0 * L.ldq + kk * 16, L.ldq);
#pragma unroll
      for (int n = 0; n < BN / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, Ks + n * 16 * L.ldq + kk * 16, L.ldq);
          wmma::mma_sync(acc, a[kk], bk, acc);
        }
        wmma::store_matrix_sync(Ss + r0 * L.lds + n * 16, acc, L.lds, wmma::mem_row_major);
      }
    }
    __syncwarp();

    // online softmax; each lane owns key columns lane and lane + 32
    const int jA = j0 + lane, jB = j0 + lane + 32;
    const bool vA = jA < Lk, vB = jB < Lk;
    int tA = 0, hA = 0, wA = 0, tB = 0, hB = 0, wB = 0;
    if (jA > 0) key_coord(jA, khw, kw, tA, hA, wA);
    if (jB > 0) key_coord(jB, khw, kw, tB, hB, wB);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = r0 + i;
      const float* R = Rs + r * K;
      float sA = -INFINITY, sB = -INFINITY;
      if (vA) sA = Ss[r * L.lds + lane] + (jA > 0 ? R[tA] + R[kt + hA] + R[kt + kh + wA] : 0.f);
      if (vB) sB = Ss[r * L.lds + lane + 32] + (jB > 0 ? R[tB] + R[kt + hB] + R[kt + kh + wB] : 0.f);
      float mx = fmaxf(sA, sB);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = exp2f((m_run[i] - m_new) * LOG2E);
      const float pA = exp2f((sA - m_new) * LOG2E);
      const float pB = exp2f((sB - m_new) * LOG2E);
      float ps = pA + pB;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run[i] = l_run[i] * alpha + ps;
      m_run[i] = m_new;
      Ps[r * L.ldp + lane] = __float2bfloat16(pA);
      Ps[r * L.ldp + lane + 32] = __float2bfloat16(pB);
      for (int c = lane; c < D; c += 32) Os[r * L.ldo + c] *= alpha;
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[BN / 16];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], Ps + r0 * L.ldp + kk * 16, L.ldp);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, Os + r0 * L.ldo + n * 16, L.ldo, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(bv, Vs + kk * 16 * L.ldq + n * 16, L.ldq);
          wmma::mma_sync(acc, pa[kk], bv, acc);
        }
        wmma::store_matrix_sync(Os + r0 * L.ldo + n * 16, acc, L.ldo, wmma::mem_row_major);
      }
    }
  }
  __syncwarp();

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Lq) continue;
    const float inv = 1.f / l_run[i];
    const size_t off = ((size_t)b * Lq + row) * HD + h * D;
    for (int c = lane; c < D; c += 32) {
      float o = Os[(r0 + i) * L.ldo + c] * inv;
      if (row >= res_from) o += __bfloat162float(q[off + c]);
      out[off + c] = __float2bfloat16(o);
    }
  }
}

template <int D, typename R>
int launch(const bf16* q, const bf16* k, const bf16* v, RelIn<R> rel, bf16* out, int B, int Lq,
           int Lk, int H, int kt, int kh, int kw, float scale, int res_from,
           cudaStream_t stream) {
  const Layout L = make_layout(D, kt + kh + kw);
  cudaError_t err = cudaFuncSetAttribute(
      bias_attn_kernel<D, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BM - 1) / BM, H, B);
  bias_attn_kernel<D, R><<<grid, NT, L.total, stream>>>(q, k, v, rel, out, Lq, Lk, H, kt, kh,
                                                        kw, scale, res_from);
  return (int)cudaGetLastError();
}

template <typename R>
int dispatch(const void* q, const void* k, const void* v, RelIn<R> rel, void* out, int B, int Lq,
             int Lk, int H, int D, int kt, int kh, int kw, float scale, int res_from,
             void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(qp, kp, vp, rel, op, B, Lq, Lk, H, kt, kh, kw, scale, res_from, s);
    case 96: return launch<96>(qp, kp, vp, rel, op, B, Lq, Lk, H, kt, kh, kw, scale, res_from, s);
    case 128: return launch<128>(qp, kp, vp, rel, op, B, Lq, Lk, H, kt, kh, kw, scale, res_from, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int dsal_bias_attention(const void* q, const void* k, const void* v,
                                   const void* rel, void* out, int B, int Lq, int Lk, int H,
                                   int D, int kt, int kh, int kw, float scale, int residual,
                                   void* stream) {
  const bf16* rp = static_cast<const bf16*>(rel);
  const int K = kt + kh + kw;
  const RelIn<bf16> r = {{rp, rp + kt, rp + kt + kh}, {H * K, H * K, H * K}, K};
  return dispatch(q, k, v, r, out, B, Lq, Lk, H, D, kt, kh, kw, scale, residual ? 0 : Lq,
                  stream);
}

// K12: q, k, v (BH, L, D) bf16 with cls at row 0; rel_t/h/w (BH, Lq, kt/kh/kw)
// f32; the residual skips row 0
extern "C" int dsal_cls_attention(const void* q, const void* k, const void* v,
                                  const void* rel_t, const void* rel_h, const void* rel_w,
                                  void* out, int BH, int Lq, int Lk, int D, int kt, int kh,
                                  int kw, float scale, int residual, void* stream) {
  const RelIn<float> r = {{static_cast<const float*>(rel_t), static_cast<const float*>(rel_h),
                           static_cast<const float*>(rel_w)},
                          {kt, kh, kw},
                          0};
  return dispatch(q, k, v, r, out, BH, Lq, Lk, 1, D, kt, kh, kw, scale, residual ? 1 : Lq,
                  stream);
}
