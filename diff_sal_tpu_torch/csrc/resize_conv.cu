// K8: the decoder's fused head, relu(conv3x3_same(sum_i resize(x_i)) + b),
// with BatchNorm folded into the conv's kernel and bias.
//
// Replaces the TPU kernel diff_sal_tpu/ops/resize.py:388 resize_sum_conv_relu
// (body _resize_sum_conv_kernel :334), which builds the multi-scale
// resize-sum of a row tile with its one-row halo in VMEM, 128 channels at a
// time, and contracts it with the nine shifted 3x3 taps on the MXU into an
// f32 accumulator carried across the sequential channel grid. On the H100
// the head is bound by operations: 9 * C * O multiply-adds per output pixel
// (2.85e10 flops per 112x192 map at C = 768, O = 96) against ~30 MB of
// inputs and output at B = 2. So it is an implicit GEMM on the tensor cores
// in which the (H, W, C) resize-sum never reaches device memory:
//   * a CTA owns an 8 x 16 pixel tile and all O output channels, eight warps
//     each owning one tile row (16 pixels = one WMMA M tile) and O / 16
//     f32 accumulator fragments;
//   * it walks C in chunks of 16 channels. For each chunk it gathers the
//     resize-sum of the (8 + 2) x (16 + 2) halo tile (2x2 half-pixel taps of
//     every input, f32 weights and sums, zero outside the map: the conv's
//     'same' padding) into shared memory, rounded to bf16 as the TPU kernel
//     rounds it for the MXU, and copies the chunk's (3, 3, 16, O) slice of
//     the folded kernel next to it;
//   * each warp then runs 9 x O/16 bf16 WMMA products (one per tap and
//     output tile): the A operand of tap (dy, dx) is the halo tile shifted
//     by (dy, dx), sixteen consecutive halo pixels 32 bytes apart;
//   * after the last chunk, bias, ReLU and the bf16 cast, one write.
// Layouts: x_i (B, h_i, w_i, C) bf16, kernel (3, 3, C, O) bf16, bias (O) f32,
// out (B, H, W, O) bf16, all contiguous; C % 16 == 0, O % 16 == 0, O <= 128.
// Tap tables as K4's (csrc/resize.cu): idx (n, 2, H + W) int32 [lo | hi],
// wts (n, 2, H + W) f32 [w_lo | w_hi], rows first, then columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int TH = 8;    // tile rows (one per warp)
constexpr int TW = 16;   // tile columns (one WMMA M tile)
constexpr int KC = 16;   // channels per chunk (one WMMA K step)
constexpr int HALO = (TH + 2) * (TW + 2);
constexpr int THREADS = 32 * TH;
constexpr int MAX_NT = 8;  // O <= 128

struct Inputs {
  const __nv_bfloat16* x[4];
  int h[4];
  int w[4];
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__global__ void __launch_bounds__(THREADS)
resize_conv_kernel(Inputs in, const int* __restrict__ idx, const float* __restrict__ wts,
                   const __nv_bfloat16* __restrict__ kern, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int n, int H, int W, int C, int O) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);           // [HALO][KC]
  __nv_bfloat16* ks = halo + HALO * KC;                                     // [9][KC][O]
  float* scratch = reinterpret_cast<float*>(ks + 9 * KC * O);               // [TH][16*16]

  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int NT = O / 16;
  const int L = H + W;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_NT];
#pragma unroll
  for (int t = 0; t < MAX_NT; ++t) wmma::fill_fragment(acc[t], 0.f);

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the previous chunk's products have read the buffers
    // the chunk's resize-sum over the halo tile, 8 channels per job
    for (int job = threadIdx.x; job < HALO * (KC / 8); job += THREADS) {
      const int pos = job / (KC / 8), part = job % (KC / 8);
      const int y = y0 - 1 + pos / (TW + 2), x = x0 - 1 + pos % (TW + 2);
      float s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = 0.f;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        for (int k = 0; k < n; ++k) {
          const int* ik = idx + k * 2 * L;
          const float* wk = wts + k * 2 * L;
          const int ylo = ik[y], yhi = ik[L + y], xlo = ik[H + x], xhi = ik[L + H + x];
          const float wyl = wk[y], wyh = wk[L + y], wxl = wk[H + x], wxh = wk[L + H + x];
          const int w = in.w[k];
          const __nv_bfloat16* base =
              in.x[k] + (long long)b * in.h[k] * w * C + c0 + part * 8;
          float t[8];
          load8(base + ((long long)ylo * w + xlo) * C, t);
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i] += wyl * wxl * t[i];
          load8(base + ((long long)ylo * w + xhi) * C, t);
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i] += wyl * wxh * t[i];
          load8(base + ((long long)yhi * w + xlo) * C, t);
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i] += wyh * wxl * t[i];
          load8(base + ((long long)yhi * w + xhi) * C, t);
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i] += wyh * wxh * t[i];
        }
      }
      uint4 raw;
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
      *reinterpret_cast<uint4*>(halo + pos * KC + part * 8) = raw;
    }
    // the chunk's folded kernel slice: rows (tap, channel), O columns
    for (int job = threadIdx.x; job < 9 * KC * (O / 8); job += THREADS) {
      const int row = job / (O / 8), col = (job % (O / 8)) * 8;
      const int tap = row / KC, kc = row % KC;
      *reinterpret_cast<uint4*>(ks + row * O + col) = *reinterpret_cast<const uint4*>(
          kern + ((long long)tap * C + c0 + kc) * O + col);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, halo + ((warp + dy) * (TW + 2) + dx) * KC, KC);
#pragma unroll
      for (int t = 0; t < MAX_NT; ++t) {
        if (t < NT) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, ks + tap * KC * O + t * 16, O);
          wmma::mma_sync(acc[t], a, bf, acc[t]);
        }
      }
    }
  }

  // epilogue: bias, ReLU, bf16, one write per output element
  float* sc = scratch + warp * 256;
  const int y = y0 + warp;
#pragma unroll
  for (int t = 0; t < MAX_NT; ++t) {
    if (t < NT) {
      wmma::store_matrix_sync(sc, acc[t], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int i = e / 16, o = t * 16 + e % 16;
        const int x = x0 + i;
        if (y < H && x < W) {
          const float v = fmaxf(sc[e] + bias[o], 0.f);
          out[(((long long)b * H + y) * W + x) * O + o] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int dsal_resize_conv_relu(const void* x0, const void* x1, const void* x2,
                                     const void* x3, const int* idx, const float* wts,
                                     const void* kern, const float* bias, void* out, int h0,
                                     int h1, int h2, int h3, int w0, int w1, int w2, int w3,
                                     int n, int B, int H, int W, int C, int O, void* stream) {
  if (n < 1 || n > 4 || C % KC != 0 || O % 16 != 0 || O < 16 || O > 16 * MAX_NT)
    return (int)cudaErrorInvalidValue;
  Inputs in;
  const void* xs[4] = {x0, x1, x2, x3};
  const int hs[4] = {h0, h1, h2, h3}, ws[4] = {w0, w1, w2, w3};
  for (int i = 0; i < 4; ++i) {
    in.x[i] = static_cast<const __nv_bfloat16*>(xs[i]);
    in.h[i] = hs[i];
    in.w[i] = ws[i];
  }
  const size_t smem = (size_t)HALO * KC * 2 + (size_t)9 * KC * O * 2 + (size_t)TH * 256 * 4;
  cudaError_t e = cudaFuncSetAttribute(resize_conv_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  resize_conv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      in, idx, wts, static_cast<const __nv_bfloat16*>(kern), bias,
      static_cast<__nv_bfloat16*>(out), n, H, W, C, O);
  return (int)cudaGetLastError();
}
