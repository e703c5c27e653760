// K2: row LayerNorm over the last axis, f32 statistics.
//
// Replaces the TPU kernel diff_sal_tpu/ops/layernorm.py:134 fused_layernorm
// (body _ln_kernel :39). Bound by bytes on the H100 (one read and one write
// of each row, ~8 flops per element), so each row is read once: one warp
// per row, each lane holds channels lane, lane+32, ... (C <= 1024) in
// registers, sum and sum of squares reduce with warp shuffles, and the
// normalized row is written once. Lanes past the row end are masked, so
// C = 96 needs no padding. var = E[x^2] - mean^2 is clamped at 0 as in the
// TPU kernel; channels at or past c_real (a zero-padded axis) are written 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPerLane = 32;  // C <= 1024
constexpr int kRowsPerBlock = 8;  // one warp each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void layernorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                 const float* __restrict__ b, T* __restrict__ out,
                                 long long R, int C, int c_real, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* xr = x + row * C;
  T* orow = out + row * C;

  float v[kMaxPerLane];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? to_f(xr[c]) : 0.f;
    s += v[i];
    ss += v[i] * v[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float mean = s / c_real;
  const float var = fmaxf(ss / c_real - mean * mean, 0.f);
  const float r = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < C) orow[c] = from_f<T>(c < c_real ? (v[i] - mean) * r * w[c] + b[c] : 0.f);
  }
}

}  // namespace

extern "C" int dsal_layernorm(const void* x, const float* w, const float* b, void* out,
                              int R, int C, int c_real, float eps, int is_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((R + kRowsPerBlock - 1) / kRowsPerBlock);
  const int threads = 32 * kRowsPerBlock;
  if (is_bf16)
    layernorm_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, b, static_cast<__nv_bfloat16*>(out), R,
        C, c_real, eps);
  else
    layernorm_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), w, b, static_cast<float*>(out), R, C, c_real, eps);
  return (int)cudaGetLastError();
}
