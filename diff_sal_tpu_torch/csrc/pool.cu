// K11: depthwise 3x3x3 attention pool on the channel-last layout.
//
// Replaces the TPU kernel diff_sal_tpu/ops/pool.py:217 depthwise_pool3d
// (body _pool_kernel :75, pallas_call :175), which walks T sequentially with
// a ring of two VMEM accumulators and reads strided taps through phase views
// so that x is read at most once. On the H100 the pool is bound by bytes: 27
// multiply-adds per output element against one read of x and one write of
// out. Blocks run in no order here, so there is no ring: each thread owns
// one output position and VEC consecutive channels (16 bytes), gathers its
// 27 taps (t-1..t+1, strided rows and columns, zero outside) with 16-byte
// loads (neighbouring taps of neighbouring threads hit L1/L2, so x crosses
// HBM about once), multiplies by the f32 per-channel weights, accumulates in
// f32 in the TPU kernel's order (kt, kh, kw) and rounds once to x's dtype.
//
// x is read in place: its pixels lie `ps` elements apart (ps >= C), so the
// q or kv columns of the qkv projection's output are pooled without a copy.
// Layouts: x (B, T, H, W, [ps]) with C channels used, w (3, 3, 3, C) f32,
// out (B, T, Ho, Wo, C) contiguous; temporal stride 1, padding 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* f) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* f) {
    float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <typename T>
__global__ void pool_kernel(const T* __restrict__ x, const float* __restrict__ w,
                            T* __restrict__ out, int B, int Tn, int H, int W, int C,
                            long long ps, int Ho, int Wo, int sh, int sw) {
  constexpr int V = Vec<T>::N;
  const int groups = C / V;
  const long long total = (long long)B * Tn * Ho * Wo * groups;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= total) return;
  const int g = (int)(tid % groups);
  long long r = tid / groups;
  const int wo = (int)(r % Wo);
  r /= Wo;
  const int ho = (int)(r % Ho);
  r /= Ho;
  const int t = (int)(r % Tn);
  const int b = (int)(r / Tn);
  const int c0 = g * V;

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  // all 27 taps unrolled, out-of-range ones predicated off, so that their
  // loads can be in flight together
#pragma unroll
  for (int kt = 0; kt < 3; ++kt) {
    const int ti = t + kt - 1;
    const bool in_t = ti >= 0 && ti < Tn;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int hi = ho * sh + kh - 1;
      const bool in_th = in_t && hi >= 0 && hi < H;
      const T* row = x + (((long long)b * Tn + ti) * H + hi) * (long long)W * ps + c0;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int wi = wo * sw + kw - 1;
        if (in_th && wi >= 0 && wi < W) {
          float v[V];
          Vec<T>::load(row + (long long)wi * ps, v);
          // the tap's weights as 16-byte loads (C and c0 are multiples of 4)
          const float4* wk =
              reinterpret_cast<const float4*>(w + ((kt * 3 + kh) * 3 + kw) * C + c0);
#pragma unroll
          for (int i = 0; i < V / 4; ++i) {
            const float4 wv = __ldg(wk + i);
            acc[4 * i] += v[4 * i] * wv.x;
            acc[4 * i + 1] += v[4 * i + 1] * wv.y;
            acc[4 * i + 2] += v[4 * i + 2] * wv.z;
            acc[4 * i + 3] += v[4 * i + 3] * wv.w;
          }
        }
      }
    }
  }
  Vec<T>::store(out + ((((long long)b * Tn + t) * Ho + ho) * Wo + wo) * C + c0, acc);
}

template <typename T>
void launch(const void* x, const float* w, void* out, int B, int Tn, int H, int W, int C,
            long long ps, int Ho, int Wo, int sh, int sw, cudaStream_t stream) {
  const long long total = (long long)B * Tn * Ho * Wo * (C / Vec<T>::N);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  pool_kernel<T><<<blocks, threads, 0, stream>>>(static_cast<const T*>(x), w,
                                                 static_cast<T*>(out), B, Tn, H, W, C, ps,
                                                 Ho, Wo, sh, sw);
}

}  // namespace

extern "C" int dsal_depthwise_pool3d(const void* x, const float* w, void* out, int B, int T,
                                     int H, int W, int C, int ps, int Ho, int Wo, int sh,
                                     int sw, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, w, out, B, T, H, W, C, ps, Ho, Wo, sh, sw, s);
  else
    launch<float>(x, w, out, B, T, H, W, C, ps, Ho, Wo, sh, sw, s);
  return (int)cudaGetLastError();
}
