// K4: multi-scale bilinear resize-and-sum, as two separable passes through
// shared memory.
//
// Replaces the TPU kernel diff_sal_tpu/ops/resize.py:235 bilinear_resize_sum
// (body _resize_sum_kernel :206), which contracts each input with the dense
// row matrix into an f32 intermediate `t1`, then with the column matrix, on
// the MXU, and rounds once. On the H100 the function is bound by the bytes
// of its output: (B, H, W, C) written once against ~16 multiply-adds per
// element. The kernel is `separable.cuh` with one shift (NS = 1): per CTA
// (b, a band of output rows, a chunk of C), a row pass writes each input's
// row-interpolated f32 rows R_i[y, input column, chunk] (the JAX body's
// `t1`) into shared memory, each input row read once per band with 16-byte
// loads, and a column pass adds the two column taps of every R_i from shared
// memory in f32 registers and writes the output once with 16-byte stores,
// rounded once to x's dtype. (The first kernel, one thread per output pixel
// and 8 channels reading the 2x2 taps of every input, made 16 loads of 16
// bytes from L1/L2 per 16 bytes written.) The plan (`resize_plan` in
// ops/resize.py) gives the band, the channel chunk and the column tile.
//
// Tap tables (built on the host from the same half-pixel rule as the dense
// matrices): idx (n, 2, H + W) int32 = [lo | hi], wts (n, 2, H + W) f32 =
// [w_lo | w_hi]; entries [0, H) are rows and [H, H + W) are columns.
//
// K10: acc + bilinear_resize(x), a gather for one input. Replaces the
// TPU kernel diff_sal_tpu/ops/resize.py:142 bilinear_resize_add (body
// _resize_acc_kernel :125). Bound by bytes: acc read once and the output
// written once (x, the small map, stays in L2), ~8 flops per element. One
// thread per (output pixel, 8 channels); the resized value is summed in f32,
// rounded to acc's dtype and added to acc in acc's dtype, as the TPU body
// rounds (:139). acc and x may differ in dtype (bf16 or f32 each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "separable.cuh"

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

// eight consecutive channels of a bf16 or f32 row, as f32
__device__ inline void load8(const __nv_bfloat16* p, float* f) { Vec<__nv_bfloat16>::load(p, f); }
__device__ inline void load8(const float* p, float* f) {
  Vec<float>::load(p, f);
  Vec<float>::load(p + 4, f + 4);
}
__device__ inline void store8(__nv_bfloat16* p, const float* f) { Vec<__nv_bfloat16>::store(p, f); }
__device__ inline void store8(float* p, const float* f) {
  Vec<float>::store(p, f);
  Vec<float>::store(p + 4, f + 4);
}
__device__ inline float round_to(__nv_bfloat16*, float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ inline float round_to(float*, float x) { return x; }

template <typename TA, typename TX>
__global__ void resize_add_kernel(const TA* __restrict__ acc, const TX* __restrict__ x,
                                  const int* __restrict__ idx, const float* __restrict__ wts,
                                  TA* __restrict__ out, int B, int h, int w, int H, int W, int C) {
  const int groups = C / 8;
  const long long total = (long long)B * H * W * groups;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= total) return;
  const int g = (int)(tid % groups);
  long long pix = tid / groups;
  const int xo = (int)(pix % W);
  pix /= W;
  const int y = (int)(pix % H);
  const int b = (int)(pix / H);
  const int L = H + W;
  const int ylo = idx[y], yhi = idx[L + y], xlo = idx[H + xo], xhi = idx[L + H + xo];
  const float wyl = wts[y], wyh = wts[L + y], wxl = wts[H + xo], wxh = wts[L + H + xo];
  const TX* base = x + (long long)b * h * w * C + g * 8;
  float r[8], t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = 0.f;
  load8(base + ((long long)ylo * w + xlo) * C, t);
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] += wyl * wxl * t[i];
  load8(base + ((long long)ylo * w + xhi) * C, t);
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] += wyl * wxh * t[i];
  load8(base + ((long long)yhi * w + xlo) * C, t);
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] += wyh * wxl * t[i];
  load8(base + ((long long)yhi * w + xhi) * C, t);
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] += wyh * wxh * t[i];
  const long long o = (((long long)b * H + y) * W + xo) * C + g * 8;
  load8(acc + o, t);
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = t[i] + round_to(out, r[i]);
  store8(out + o, r);
}

template <typename TA, typename TX>
void launch_add(const void* acc, const void* x, const int* idx, const float* wts, void* out, int B,
                int h, int w, int H, int W, int C, cudaStream_t stream) {
  const long long total = (long long)B * H * W * (C / 8);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  resize_add_kernel<TA, TX><<<blocks, threads, 0, stream>>>(
      static_cast<const TA*>(acc), static_cast<const TX*>(x), idx, wts, static_cast<TA*>(out), B,
      h, w, H, W, C);
}

}  // namespace

// K4: out = sum_i resize(x_i); x_i (B, h_i, w_i, C) bf16 (C % 8 == 0) or f32
// (C % 4 == 0); (bh, cc, tw, cols, ctas) the plan's band, channel chunk,
// column tile, staged columns and persistent CTAs
extern "C" int dsal_resize_sum(const void* x0, const void* x1, const void* x2,
                               const void* x3, const int* idx, const float* wts,
                               void* out, int h0, int h1, int h2, int h3, int w0,
                               int w1, int w2, int w3, int n, int B, int H, int W,
                               int C, int bh, int cc, int tw, int cols, int ctas,
                               int is_bf16, void* stream) {
  sep::Args a;
  a.x[0] = x0; a.x[1] = x1; a.x[2] = x2; a.x[3] = x3;
  a.h[0] = h0; a.h[1] = h1; a.h[2] = h2; a.h[3] = h3;
  a.w[0] = w0; a.w[1] = w1; a.w[2] = w2; a.w[3] = w3;
  a.idx = idx;
  a.wts = wts;
  a.bias = nullptr;
  a.out = out;
  a.n = n; a.B = B; a.H = H; a.W = W; a.C = C;
  a.cc = cc; a.tw = tw; a.cols = cols;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return sep::launch<__nv_bfloat16, float, 1>(a, bh, ctas, s);
  return sep::launch<float, float, 1>(a, bh, ctas, s);
}

// K10: out = acc + resize(x); acc, out (B, H, W, C), x (B, h, w, C), C % 8 == 0;
// idx, wts the tap tables of x (n = 1)
extern "C" int dsal_resize_add(const void* acc, const void* x, const int* idx, const float* wts,
                               void* out, int B, int h, int w, int H, int W, int C, int acc_bf16,
                               int x_bf16, void* stream) {
  typedef __nv_bfloat16 bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (acc_bf16 && x_bf16)
    launch_add<bf16, bf16>(acc, x, idx, wts, out, B, h, w, H, W, C, s);
  else if (acc_bf16)
    launch_add<bf16, float>(acc, x, idx, wts, out, B, h, w, H, W, C, s);
  else if (x_bf16)
    launch_add<float, bf16>(acc, x, idx, wts, out, B, h, w, H, W, C, s);
  else
    launch_add<float, float>(acc, x, idx, wts, out, B, h, w, H, W, C, s);
  return (int)cudaGetLastError();
}
