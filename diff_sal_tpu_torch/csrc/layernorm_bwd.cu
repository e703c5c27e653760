// K6: backward of K2 (row LayerNorm over the last axis, f32 statistics).
//
// Replaces the TPU kernel diff_sal_tpu/ops/layernorm.py:283 _ln_bwd (body
// _ln_bwd_kernel :233). Per row, with the statistics recomputed in f32 and
// mask = channel < c_real:
//   u = x - mean, r = rsqrt(var + eps), y = u * r * mask, dy = g * w * mask,
//   dvar = -0.5 r^3 sum(dy * u), dmean = -r sum(dy) - 2 mean dvar,
//   dx = dy r + (2 / c_real) x dvar + dmean / c_real   (written in x's dtype)
// and, over all rows, d_weight = sum g * y and d_bias = sum g in f32.
//
// Bound by bytes on the H100 (read x and g, write dx; ~20 flops per
// element). K2's shape: one warp per row, each lane keeps its channels of x
// and g in registers (C <= 1024), the row sums reduce with warp shuffles, dx
// is written once. Each warp walks rows with a grid stride and keeps running
// per-channel sums of g * y and g in registers; at the end a CTA adds its
// eight warps' sums in shared memory and writes one f32 partial row per sum,
// and a second kernel adds the partial rows in CTA order. No atomics: the
// parameter gradients are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;  // one warp each
constexpr int kThreads = 32 * kRowsPerBlock;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// N = channels per lane (C <= 32 N)
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) layernorm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ w,
    T* __restrict__ dx, float* __restrict__ partial, long long R, int C, int c_real, float eps) {
  extern __shared__ float red[];  // kRowsPerBlock x C
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float dws[N], dbs[N], wv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = lane + 32 * i;
    dws[i] = 0.f;
    dbs[i] = 0.f;
    wv[i] = c < C && c < c_real ? w[c] : 0.f;  // w * mask
  }
  const float inv_c = 1.f / c_real;
  for (long long row = (long long)blockIdx.x * kRowsPerBlock + warp; row < R;
       row += (long long)gridDim.x * kRowsPerBlock) {
    const T* xr = x + row * C;
    const T* gr = g + row * C;
    float xv[N], gv[N];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      xv[i] = c < C ? to_f(xr[c]) : 0.f;
      gv[i] = c < C ? to_f(gr[c]) : 0.f;
      s += xv[i];
      ss += xv[i] * xv[i];
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / c_real;
    const float var = fmaxf(ss / c_real - mean * mean, 0.f);
    const float r = rsqrtf(var + eps);
    float sdy = 0.f, sdyu = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float dy = gv[i] * wv[i];
      sdy += dy;
      sdyu += dy * (xv[i] - mean);
    }
    sdy = warp_sum(sdy);
    sdyu = warp_sum(sdyu);
    const float dvar = -0.5f * (r * r * r) * sdyu;
    const float dmean = -r * sdy - 2.f * mean * dvar;
    T* dr = dx + row * C;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      if (c >= C) continue;
      const float dy = gv[i] * wv[i];
      dr[c] = from_f<T>(dy * r + (2.f * inv_c) * xv[i] * dvar + dmean * inv_c);
      const float y = c < c_real ? (xv[i] - mean) * r : 0.f;
      dws[i] += gv[i] * y;
      dbs[i] += gv[i];
    }
  }
  // this CTA's sums: warps -> shared memory -> one partial row per sum
  for (int part = 0; part < 2; ++part) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      if (c < C) red[warp * C + c] = part == 0 ? dws[i] : dbs[i];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kRowsPerBlock; ++k) acc += red[k * C + c];
      partial[((size_t)part * gridDim.x + blockIdx.x) * C + c] = acc;
    }
  }
}

// d_weight, d_bias = sums of the partial rows over CTAs, in CTA order
__global__ void layernorm_bwd_reduce_kernel(const float* __restrict__ partial,
                                            float* __restrict__ dw, float* __restrict__ db,
                                            int ctas, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sw = 0.f, sb = 0.f;
  for (int k = 0; k < ctas; ++k) {
    sw += partial[(size_t)k * C + c];
    sb += partial[((size_t)ctas + k) * C + c];
  }
  dw[c] = sw;
  db[c] = sb;
}

template <typename T, int N>
int launch(const void* x, const void* g, const float* w, void* dx, float* partial, float* dw,
           float* db, int R, int C, int c_real, int ctas, float eps, cudaStream_t s) {
  const size_t smem = (size_t)kRowsPerBlock * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(layernorm_bwd_kernel<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  layernorm_bwd_kernel<T, N><<<ctas, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), w, static_cast<T*>(dx), partial, R, C,
      c_real, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  layernorm_bwd_reduce_kernel<<<(C + 255) / 256, 256, 0, s>>>(partial, dw, db, ctas, C);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* g, const float* w, void* dx, float* partial, float* dw,
             float* db, int R, int C, int c_real, int ctas, float eps, cudaStream_t s) {
  const int n = (C + 31) / 32;
  if (n <= 4) return launch<T, 4>(x, g, w, dx, partial, dw, db, R, C, c_real, ctas, eps, s);
  if (n <= 8) return launch<T, 8>(x, g, w, dx, partial, dw, db, R, C, c_real, ctas, eps, s);
  if (n <= 16) return launch<T, 16>(x, g, w, dx, partial, dw, db, R, C, c_real, ctas, eps, s);
  if (n <= 24) return launch<T, 24>(x, g, w, dx, partial, dw, db, R, C, c_real, ctas, eps, s);
  if (n <= 32) return launch<T, 32>(x, g, w, dx, partial, dw, db, R, C, c_real, ctas, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dsal_layernorm_bwd(const void* x, const void* g, const float* w, void* dx,
                                  float* partial, float* dw, float* db, int R, int C, int c_real,
                                  int ctas, float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(x, g, w, dx, partial, dw, db, R, C, c_real, ctas, eps, s);
  return dispatch<float>(x, g, w, dx, partial, dw, db, R, C, c_real, ctas, eps, s);
}
