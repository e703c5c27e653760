// K3: fused transformer-block tail,
//   y = skip + attn;  out = y + fc2(gelu(fc1(LayerNorm(y))))
//
// Replaces the TPU kernel diff_sal_tpu/ops/mlp.py:132 fused_block_tail (body
// _tail_kernel :47). At the decoder's widths (C = 96..768, hidden Hd = 2C)
// the tail is bound by operations, so both products run on the tensor cores
// (WMMA, bf16 in, f32 accumulation), and the (R, Hd) hidden activation never
// reaches device memory ("flash-MLP"):
//   1. a CTA of eight warps owns BR = 32 rows; each warp takes four rows,
//      computes y = skip + attn and its LayerNorm in f32 (warp shuffles) and
//      stores LN(y) in shared memory as bf16;
//   2. the hidden axis is walked in chunks of 64: the eight warps compute the
//      32x64 chunk h = LN(y) w1[chunk]^T (one 16x16 fragment each), add b1 and
//      apply GELU in f32, round to bf16 in shared memory, then every warp adds
//      h w2[:, chunk]^T into its own output fragments, which stay in registers
//      for the whole walk (warp w owns row half w & 1 and column blocks
//      (w >> 1) + 4i, at most 12 fragments for C = 768);
//   3. each fragment is staged through shared memory and written as
//      bf16(y + out + b2), with y re-read from skip and attn.
// Weight fragments are loaded straight from global memory (L2-resident:
// 2.4 MB per matrix at C = 768) instead of being held in shared memory.
// Rows past R are zero and are not written.
//
// The f32 instance (`dsal_block_tail_f32`, the tail of an f32 model, which
// the JAX K3 takes as well) computes every product in f32 by FFMA on the
// CUDA cores: TF32 keeps too few mantissa bits for the f32 tolerance. A CTA
// of eight warps owns BRF = 16 rows: LN(y) in f32 in shared memory, then
// per hidden chunk of 64 h = LN(y) w1[chunk]^T + b1 with w1 staged in
// 32-column slices (thread: one hidden unit, four rows), GELU, and out +=
// h w2[:, chunk]^T with w2 staged in 16-unit slices (thread: every 256th
// output column of all 16 rows, in registers). Its shared memory, 16 * C +
// 16 * 64 + 32 * 64 + 16 * C floats, is 110.6 KB at C = 768 (`f32_smem` in
// ops/mlp.py checks it for every C up to MAX_C).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BR = 32;     // rows per CTA
constexpr int HC = 64;     // hidden chunk
constexpr int NW = 8;      // warps
constexpr int NT = NW * 32;
constexpr int MAXC = 768;
constexpr int MAXF = MAXC / 16 / 4;  // output column blocks per warp (12)
constexpr int MAXV = MAXC / 32;      // LayerNorm values per lane (24)
constexpr int LDH = HC + 4;          // f32 hidden chunk
constexpr int LDHB = HC + 8;         // bf16 hidden chunk

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline size_t smem_bytes(int C) {
  return align128((size_t)BR * (C + 8) * 2) + align128((size_t)BR * LDH * 4) +
         align128((size_t)BR * LDHB * 2);
}

__device__ __forceinline__ float gelu(float h, int mode) {
  if (mode == 0) {
    const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * h * (1.f + tanhf(k0 * (h + 0.044715f * h * h * h)));
  }
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

__global__ void __launch_bounds__(NT) block_tail_kernel(
    const bf16* __restrict__ skip, const bf16* __restrict__ attn,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b,
    const bf16* __restrict__ w1, const float* __restrict__ b1,
    const bf16* __restrict__ w2, const float* __restrict__ b2, bf16* __restrict__ out,
    int R, int C, int Hd, float eps, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = C + 8;
  bf16* Xn = reinterpret_cast<bf16*>(smem);
  float* Hs = reinterpret_cast<float*>(smem + align128((size_t)BR * ldx * 2));
  bf16* Hb = reinterpret_cast<bf16*>(smem + align128((size_t)BR * ldx * 2) +
                                     align128((size_t)BR * LDH * 4));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * BR;

  // 1. y and LN(y), four rows per warp
  for (int rr = 0; rr < BR / NW; ++rr) {
    const int r = warp * (BR / NW) + rr;
    const long long row = row0 + r;
    if (row < R) {
      const bf16* sp = skip + row * C;
      const bf16* ap = attn + row * C;
      float v[MAXV];
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const int c = lane + 32 * i;
        v[i] = c < C ? __bfloat162float(sp[c]) + __bfloat162float(ap[c]) : 0.f;
        s += v[i];
        ss += v[i] * v[i];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      const float mean = s / C;
      const float rs = rsqrtf(fmaxf(ss / C - mean * mean, 0.f) + eps);
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const int c = lane + 32 * i;
        if (c < C) Xn[r * ldx + c] = __float2bfloat16((v[i] - mean) * rs * ln_w[c] + ln_b[c]);
      }
    } else {
      for (int c = lane; c < C; c += 32) Xn[r * ldx + c] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  const int rf = warp & 1;         // row half of this warp's output fragments
  const int cf0 = warp >> 1;       // first output column block
  const int ncf = C / 16;          // output column blocks
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXF];
#pragma unroll
  for (int i = 0; i < MAXF; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int hc0 = 0; hc0 < Hd; hc0 += HC) {
    // 2a. one 16x16 block of h = LN(y) w1[chunk]^T per warp
    {
      const int hf = warp >> 1;  // hidden column block within the chunk
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
      wmma::fill_fragment(hacc, 0.f);
      for (int kk = 0; kk < C / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Xn + rf * 16 * ldx + kk * 16, ldx);
        wmma::load_matrix_sync(b, w1 + (size_t)(hc0 + hf * 16) * C + kk * 16, C);
        wmma::mma_sync(hacc, a, b, hacc);
      }
      wmma::store_matrix_sync(Hs + rf * 16 * LDH + hf * 16, hacc, LDH, wmma::mem_row_major);
    }
    __syncthreads();
    // 2b. bias + GELU in f32, rounded to bf16
    for (int i = tid; i < BR * HC; i += NT) {
      const int r = i / HC, c = i % HC;
      Hb[r * LDHB + c] = __float2bfloat16(gelu(Hs[r * LDH + c] + b1[hc0 + c], act));
    }
    __syncthreads();
    // 2c. out += h w2[:, chunk]^T into this warp's fragments
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ha[HC / 16];
#pragma unroll
      for (int kk = 0; kk < HC / 16; ++kk)
        wmma::load_matrix_sync(ha[kk], Hb + rf * 16 * LDHB + kk * 16, LDHB);
#pragma unroll
      for (int i = 0; i < MAXF; ++i) {
        const int cf = cf0 + 4 * i;
        if (cf < ncf) {
#pragma unroll
          for (int kk = 0; kk < HC / 16; ++kk) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
            wmma::load_matrix_sync(b, w2 + (size_t)cf * 16 * Hd + hc0 + kk * 16, Hd);
            wmma::mma_sync(acc[i], ha[kk], b, acc[i]);
          }
        }
      }
    }
  }
  __syncthreads();

  // 3. epilogue through a per-warp 16x16 staging tile (reusing Hs)
  float* stage = Hs + warp * 256;
#pragma unroll
  for (int i = 0; i < MAXF; ++i) {
    const int cf = cf0 + 4 * i;
    if (cf < ncf) {
      wmma::store_matrix_sync(stage, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        const long long row = row0 + rf * 16 + r;
        const int col = cf * 16 + c;
        if (row < R) {
          const long long off = row * C + col;
          const float y = __bfloat162float(skip[off]) + __bfloat162float(attn[off]);
          out[off] = __float2bfloat16(y + stage[e] + b2[col]);
        }
      }
      __syncwarp();
    }
  }
}

constexpr int BRF = 16;  // rows per CTA of the f32 instance
constexpr int MAXCOL = MAXC / NT;  // output columns per thread (3)

__host__ __device__ inline size_t smem_f32(int C) {
  return ((size_t)BRF * C * 2 + BRF * HC + 32 * HC) * 4;
}

__global__ void __launch_bounds__(NT) block_tail_f32_kernel(
    const float* __restrict__ skip, const float* __restrict__ attn,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out,
    int R, int C, int Hd, float eps, int act) {
  extern __shared__ float fs[];
  float* Xn = fs;                 // BRF x C: LN(y)
  float* Hs = Xn + BRF * C;       // BRF x HC: the hidden chunk after GELU
  float* W1s = Hs + BRF * HC;     // 32 x HC: a slice of w1[chunk]^T
  float* W2s = W1s + 32 * HC;     // 16 x C: a slice of w2[:, chunk]^T
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * BRF;

  // y and LN(y) in f32, two rows per warp
  for (int rr = 0; rr < BRF / NW; ++rr) {
    const int r = warp * (BRF / NW) + rr;
    const long long row = row0 + r;
    if (row >= R) {
      for (int c = lane; c < C; c += 32) Xn[r * C + c] = 0.f;
      continue;
    }
    float v[MAXV], s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? skip[row * C + c] + attn[row * C + c] : 0.f;
      s += v[i];
      ss += v[i] * v[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float mean = s / C;
    const float rs = 1.f / sqrtf(fmaxf(ss / C - mean * mean, 0.f) + eps);
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int c = lane + 32 * i;
      if (c < C) Xn[r * C + c] = (v[i] - mean) * rs * ln_w[c] + ln_b[c];
    }
  }

  float acc[BRF][MAXCOL];
#pragma unroll
  for (int r = 0; r < BRF; ++r)
#pragma unroll
    for (int m = 0; m < MAXCOL; ++m) acc[r][m] = 0.f;
  const int hn = tid % HC, hr = (tid / HC) * 4;  // this thread's hidden unit and four rows
  for (int hc0 = 0; hc0 < Hd; hc0 += HC) {
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < C; c0 += 32) {
      __syncthreads();  // the previous slice is consumed (and, first, Xn is written)
      for (int i = tid; i < HC * 32; i += NT) {
        const int n = i >> 5, c = i & 31;
        W1s[c * HC + n] = w1[(size_t)(hc0 + n) * C + c0 + c];
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        const float w = W1s[c * HC + hn];
#pragma unroll
        for (int u = 0; u < 4; ++u) h[u] = fmaf(Xn[(hr + u) * C + c0 + c], w, h[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) Hs[(hr + u) * HC + hn] = gelu(h[u] + b1[hc0 + hn], act);
    for (int k0 = 0; k0 < HC; k0 += 16) {
      __syncthreads();  // Hs is written, the previous w2 slice consumed
      for (int i = tid; i < 16 * C; i += NT) {
        const int col = i >> 4, k = i & 15;
        W2s[k * C + col] = w2[(size_t)col * Hd + hc0 + k0 + k];
      }
      __syncthreads();
      for (int k = 0; k < 16; ++k) {
#pragma unroll
        for (int m = 0; m < MAXCOL; ++m) {
          const int col = tid + NT * m;
          if (col < C) {
            const float w = W2s[k * C + col];
#pragma unroll
            for (int r = 0; r < BRF; ++r) acc[r][m] = fmaf(Hs[r * HC + k0 + k], w, acc[r][m]);
          }
        }
      }
    }
  }
  // out = y + (h w2^T + b2), as the plain version adds
#pragma unroll
  for (int m = 0; m < MAXCOL; ++m) {
    const int col = tid + NT * m;
    if (col >= C) continue;
#pragma unroll
    for (int r = 0; r < BRF; ++r) {
      const long long row = row0 + r;
      if (row < R) {
        const long long off = row * C + col;
        out[off] = (skip[off] + attn[off]) + (acc[r][m] + b2[col]);
      }
    }
  }
}

}  // namespace

extern "C" int dsal_block_tail(const void* skip, const void* attn, const float* ln_w,
                               const float* ln_b, const void* w1, const float* b1,
                               const void* w2, const float* b2, void* out, int R, int C,
                               int Hd, float eps, int act, void* stream) {
  if (C % 16 != 0 || C > MAXC || Hd % HC != 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      block_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((R + BR - 1) / BR);
  block_tail_kernel<<<blocks, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(skip), static_cast<const bf16*>(attn), ln_w, ln_b,
      static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2,
      static_cast<bf16*>(out), R, C, Hd, eps, act);
  return (int)cudaGetLastError();
}

// the f32 instance: every tensor f32, the same shapes and conditions
extern "C" int dsal_block_tail_f32(const void* skip, const void* attn, const float* ln_w,
                                   const float* ln_b, const void* w1, const float* b1,
                                   const void* w2, const float* b2, void* out, int R, int C,
                                   int Hd, float eps, int act, void* stream) {
  if (C % 32 != 0 || C > MAXC || Hd % HC != 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_f32(C);
  cudaError_t err = cudaFuncSetAttribute(
      block_tail_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((R + BRF - 1) / BRF);
  block_tail_f32_kernel<<<blocks, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(skip), static_cast<const float*>(attn), ln_w, ln_b,
      static_cast<const float*>(w1), b1, static_cast<const float*>(w2), b2,
      static_cast<float*>(out), R, C, Hd, eps, act);
  return (int)cudaGetLastError();
}
