// K7: the decoder's CvT cross-attention, softmax(q k^T * scale) v per head,
// with few keys.
//
// Replaces the TPU kernel diff_sal_tpu/ops/attention.py:893
// cvt_cross_attention (body _cvt_attn_kernel :841), which keeps k/v (S <= 128
// keys, padded to 128 lanes and masked) resident in VMEM and streams q in
// row tiles so that the (L, S) scores never reach HBM. The decoder pools k/v
// to S = 18 tokens while q keeps the full grid (L up to 5376): on the H100
// the function is bound by the bytes of q and out (4 S flops per q element).
// So a CTA of four warps owns 64 query rows of one head of one batch item
// and keeps everything else on chip:
//   * it stages the q tile and the head's k and v (S padded to a multiple of
//     16 with zero rows) in shared memory with 16-byte loads;
//   * each warp computes its 16 rows' scores q k^T on the tensor cores (bf16
//     WMMA, f32 accumulation) into shared memory;
//   * one lane per row takes the softmax in f32 with a row max, masks the
//     padded keys and rounds p to bf16, as the TPU kernel feeds p to its
//     p v product;
//   * p v runs on the tensor cores, 16 output columns at a time, and each
//     16 x 16 f32 tile is rounded once and written out.
// Layouts: q (Bt, L, C), k and v (Bt, S, C), out (Bt, L, C), all bf16 and
// contiguous, C = heads * hd with hd % 16 == 0, S <= 128, the whole tile
// set within the 227 KB of shared memory a CTA may use.
//
// The f32 instance (`dsal_cvt_attention_f32`, for an f32 model) keeps the
// products in f32 by FFMA on the CUDA cores (TF32 keeps too few mantissa
// bits for the f32 tolerance): a CTA of four warps owns 32 query rows of one
// head, stages them and the head's k and v in shared memory (f32, key rows
// padded by one float against bank conflicts), lane u of a warp takes keys
// u, u + 32, .. for the scores of the warp's 8 rows, the softmax reduces by
// warp shuffles, and p v runs over the lanes' head-dim columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int WARPS = 4;
constexpr int ROWS = 16 * WARPS;  // query rows per CTA
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_S = 128;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a CTA may use

struct Layout {
  int sp, lds, ldp;  // padded keys, score and probability row strides
  size_t q, k, v, s, p, scratch, total;  // byte offsets
};

__host__ __device__ inline Layout layout(int S, int hd) {
  Layout l;
  l.sp = (S + 15) / 16 * 16;
  l.lds = l.sp + 4;  // f32 row stride: a multiple of 4, off the 32-bank period
  l.ldp = l.sp + 8;  // bf16 row stride: a multiple of 8
  l.q = 0;
  l.k = l.q + (size_t)ROWS * hd * 2;
  l.v = l.k + (size_t)l.sp * hd * 2;
  l.s = l.v + (size_t)l.sp * hd * 2;
  l.p = l.s + (size_t)ROWS * l.lds * 4;
  l.scratch = l.p + (size_t)ROWS * l.ldp * 2;
  l.total = l.scratch + (size_t)WARPS * 256 * 4;
  return l;
}

__global__ void __launch_bounds__(THREADS)
cvt_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                int L, int S, int C, int hd, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(S, hd);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + lay.k);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + lay.v);
  float* sc = reinterpret_cast<float*>(smem + lay.s);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + lay.p);
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch);
  const int sp = lay.sp, lds = lay.lds, ldp = lay.ldp;

  const int bt = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int vecs = hd / 8;  // 16-byte vectors per row of one head
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = threadIdx.x; i < sp * vecs; i += THREADS) {
    const int j = i / vecs, c = (i - j * vecs) * 8;
    const long long src = ((long long)bt * S + j) * C + h * hd + c;
    *reinterpret_cast<uint4*>(ks + j * hd + c) =
        j < S ? *reinterpret_cast<const uint4*>(k + src) : zero;
    *reinterpret_cast<uint4*>(vs + j * hd + c) =
        j < S ? *reinterpret_cast<const uint4*>(v + src) : zero;
  }
  for (int i = threadIdx.x; i < ROWS * vecs; i += THREADS) {
    const int r = i / vecs, c = (i - r * vecs) * 8;
    const int row = row0 + r;
    *reinterpret_cast<uint4*>(qs + r * hd + c) =
        row < L ? *reinterpret_cast<const uint4*>(q + ((long long)bt * L + row) * C + h * hd + c)
                : zero;
  }
  __syncthreads();

  // scores of this warp's 16 rows against every key tile
  const __nv_bfloat16* qw = qs + warp * 16 * hd;
  for (int kt = 0; kt < sp / 16; ++kt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int d0 = 0; d0 < hd; d0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, qw + d0, hd);
      wmma::load_matrix_sync(b, ks + kt * 16 * hd + d0, hd);  // k^T as a column-major tile
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sc + warp * 16 * lds + kt * 16, acc, lds, wmma::mem_row_major);
  }
  __syncwarp();

  // softmax of each row in f32, p rounded to bf16, padded keys masked to 0
  if (lane < 16) {
    float* sr = sc + (warp * 16 + lane) * lds;
    __nv_bfloat16* pr = ps + (warp * 16 + lane) * ldp;
    float m = -INFINITY;
    for (int j = 0; j < S; ++j) m = fmaxf(m, sr[j] * scale);
    float sum = 0.f;
    for (int j = 0; j < S; ++j) {
      const float e = expf(sr[j] * scale - m);
      sr[j] = e;
      sum += e;
    }
    for (int j = 0; j < sp; ++j) pr[j] = __float2bfloat16(j < S ? sr[j] / sum : 0.f);
  }
  __syncwarp();

  // p v, 16 output columns at a time, each tile rounded once and written
  float* sw = scratch + warp * 256;
  const __nv_bfloat16* pw = ps + warp * 16 * ldp;
  for (int n0 = 0; n0 < hd; n0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kt = 0; kt < sp / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, pw + kt * 16, ldp);
      wmma::load_matrix_sync(b, vs + kt * 16 * hd + n0, hd);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sw, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 128; e += 32) {
      const int r = e / 8, c = (e % 8) * 2;
      const int row = row0 + warp * 16 + r;
      if (row < L)
        *reinterpret_cast<__nv_bfloat162*>(out + ((long long)bt * L + row) * C + h * hd + n0 + c) =
            __floats2bfloat162_rn(sw[r * 16 + c], sw[r * 16 + c + 1]);
    }
    __syncwarp();
  }
}

constexpr int FR = 32;           // query rows per CTA of the f32 instance, 8 per warp
constexpr int MAX_HD32 = 384 / 32;  // head-dim columns per lane (hd <= 384)

__host__ __device__ inline size_t smem_f32(int S, int hd) {
  return ((size_t)FR * hd + 2 * (size_t)S * (hd + 1)) * 4;
}

__global__ void __launch_bounds__(THREADS)
cvt_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out, int L, int S, int C,
                    int hd, float scale) {
  extern __shared__ float fs[];
  float* qs = fs;                   // FR x hd
  float* ks = qs + FR * hd;         // S x (hd + 1)
  float* vs = ks + S * (hd + 1);    // S x (hd + 1)
  const int bt = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * FR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < S * hd; i += THREADS) {
    const int j = i / hd, c = i - j * hd;
    const long long src = ((long long)bt * S + j) * C + h * hd + c;
    ks[j * (hd + 1) + c] = k[src];
    vs[j * (hd + 1) + c] = v[src];
  }
  for (int i = threadIdx.x; i < FR * hd; i += THREADS) {
    const int r = i / hd, c = i - r * hd, row = row0 + r;
    qs[i] = row < L ? q[((long long)bt * L + row) * C + h * hd + c] : 0.f;
  }
  __syncthreads();
  for (int rr = 0; rr < FR / WARPS; ++rr) {
    const int r = warp * (FR / WARPS) + rr, row = row0 + r;
    float sc[MAX_S / 32];
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < MAX_S / 32; ++u) {
      const int j = lane + 32 * u;
      float s = -INFINITY;
      if (j < S) {
        s = 0.f;
        for (int c = 0; c < hd; ++c) s = fmaf(qs[r * hd + c], ks[j * (hd + 1) + c], s);
        s *= scale;
      }
      sc[u] = s;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_S / 32; ++u) {
      sc[u] = lane + 32 * u < S ? expf(sc[u] - m) : 0.f;
      sum += sc[u];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    float o[MAX_HD32];
#pragma unroll
    for (int c = 0; c < MAX_HD32; ++c) o[c] = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_S / 32; ++u) {
      if (32 * u >= S) break;
      const float pu = sc[u] / sum;
      for (int jj = 0; jj < 32 && 32 * u + jj < S; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pu, jj);
        const float* vr = vs + (32 * u + jj) * (hd + 1);
#pragma unroll
        for (int c = 0; c < MAX_HD32; ++c)
          if (lane + 32 * c < hd) o[c] = fmaf(pj, vr[lane + 32 * c], o[c]);
      }
    }
    if (row < L) {
#pragma unroll
      for (int c = 0; c < MAX_HD32; ++c)
        if (lane + 32 * c < hd) out[((long long)bt * L + row) * C + h * hd + lane + 32 * c] = o[c];
    }
  }
}

}  // namespace

extern "C" int dsal_cvt_attention(const void* q, const void* k, const void* v, void* out,
                                  int Bt, int L, int S, int C, int heads, float scale,
                                  void* stream) {
  const int hd = heads > 0 ? C / heads : 0;
  if (S < 1 || S > MAX_S || hd < 16 || hd % 16 != 0 || hd * heads != C)
    return (int)cudaErrorInvalidValue;
  const size_t smem = layout(S, hd).total;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(cvt_attn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + ROWS - 1) / ROWS, heads, Bt);
  cvt_attn_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), L, S, C, hd,
      scale);
  return (int)cudaGetLastError();
}

// the f32 instance: q, k, v, out f32; S <= 128, hd <= 384, the tiles within
// one CTA's shared memory
extern "C" int dsal_cvt_attention_f32(const void* q, const void* k, const void* v, void* out,
                                      int Bt, int L, int S, int C, int heads, float scale,
                                      void* stream) {
  const int hd = heads > 0 ? C / heads : 0;
  if (S < 1 || S > MAX_S || hd < 1 || hd > 32 * MAX_HD32 || hd * heads != C)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_f32(S, hd);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(cvt_attn_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + FR - 1) / FR, heads, Bt);
  cvt_attn_f32_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), L, S, C, hd, scale);
  return (int)cudaGetLastError();
}
