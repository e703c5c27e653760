// K9: the decoder's head as conv-at-low-res, a gather over the nine phases.
//
// Replaces the TPU kernel diff_sal_tpu/ops/resize.py:567
// resize_sum_conv_relu_phase (body _phase_resize_head_kernel :526). conv3x3
// and bilinear resize are both linear, so
//   relu(conv3x3_same(sum_i resize(x_i)) + b)
//     = relu(sum_i sum_dx Aw_dx (sum_dy Ah_dy u_i[dy, dx]) + b),
// with u_i = x_i K' computed per task at its low resolution outside the
// kernel (a matmul, as in the JAX package), its 9 * O columns ordered (dy,
// dx, O). Row o of the dy-shifted row matrix Ah_dy is row o + dy - 1 of the
// bilinear matrix and zero past the borders, which reproduces the conv's
// zero padding exactly; the same holds for the columns and dx. Each bilinear
// row has at most two non-zeros, so the contraction is a gather: for every
// output pixel and 8 output channels a thread reads, per task, per dx, per
// column tap and per dy, the two row taps of u_i (at most 144 16-byte loads,
// served mostly from L1/L2: u_i totals ~25 MB at B = 2). On the H100 the
// kernel is bound by those cached reads, not by HBM (u once, out once) or
// by arithmetic.
// Rounding follows the TPU kernel: the interpolation weights are given
// rounded to u's dtype (they are the TPU kernel's bf16 matrices), the dy
// contraction accumulates in f32 and is rounded to u's dtype, the dx
// contraction and the sum over tasks accumulate in f32, then f32 bias, ReLU
// and one rounding of the output.
// Layouts: u_i (B, h_i, w_i, 9 * O), out (B, TH, TW, O), contiguous, one
// dtype (bf16 or f32); tap tables idx (n, 2, 3 * (TH + TW)) int32 [lo | hi]
// and wts (n, 2, 3 * (TH + TW)) f32 [w_lo | w_hi]: entry dy * TH + o is
// output row o under shift dy, entry 3 * TH + dx * TW + p output column p
// under shift dx (zero weights past the borders).

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
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16(v)); }
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
  __device__ static float round(float v) { return v; }
};

struct Inputs {
  const void* u[4];
  int h[4];
  int w[4];
};

template <typename T>
__global__ void phase_head_kernel(Inputs in, const int* __restrict__ idx,
                                  const float* __restrict__ wts,
                                  const float* __restrict__ bias, T* __restrict__ out, int n,
                                  int B, int TH, int TW, int O) {
  constexpr int V = Vec<T>::N;
  const int groups = O / V;
  const long long total = (long long)B * TH * TW * groups;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= total) return;
  const int g = (int)(tid % groups);
  long long pix = tid / groups;
  const int p = (int)(pix % TW);
  pix /= TW;
  const int o = (int)(pix % TH);
  const int b = (int)(pix / TH);
  const int L = 3 * (TH + TW);
  const int O9 = 9 * O;

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  for (int k = 0; k < n; ++k) {
    const int* ik = idx + k * 2 * L;
    const float* wk = wts + k * 2 * L;
    const int h = in.h[k], w = in.w[k];
    const T* ub = static_cast<const T*>(in.u[k]) + (long long)b * h * w * O9 + g * V;
    for (int dx = 0; dx < 3; ++dx) {
      const int ce = 3 * TH + dx * TW + p;
      for (int ct = 0; ct < 2; ++ct) {
        const float wx = wk[ct * L + ce];
        if (wx == 0.f) continue;
        const int xw = ik[ct * L + ce];
        // v = round(sum_dy sum_row-taps wy * u[h, xw, dy, dx, :])
        float v[V];
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = 0.f;
        for (int dy = 0; dy < 3; ++dy) {
          const int re = dy * TH + o;
          const T* col = ub + (long long)xw * O9 + (dy * 3 + dx) * O;
          for (int rt = 0; rt < 2; ++rt) {
            const float wy = wk[rt * L + re];
            if (wy == 0.f) continue;
            float t[V];
            Vec<T>::load(col + (long long)ik[rt * L + re] * w * O9, t);
#pragma unroll
            for (int i = 0; i < V; ++i) v[i] += wy * t[i];
          }
        }
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += wx * Vec<T>::round(v[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = fmaxf(acc[i] + bias[g * V + i], 0.f);
  Vec<T>::store(out + (((long long)b * TH + o) * TW + p) * O + g * V, acc);
}

template <typename T>
void launch(Inputs in, const int* idx, const float* wts, const float* bias, void* out, int n,
            int B, int TH, int TW, int O, cudaStream_t stream) {
  const long long total = (long long)B * TH * TW * (O / Vec<T>::N);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  phase_head_kernel<T><<<blocks, threads, 0, stream>>>(in, idx, wts, bias,
                                                       static_cast<T*>(out), n, B, TH, TW, O);
}

}  // namespace

extern "C" int dsal_resize_phase_head(const void* u0, const void* u1, const void* u2,
                                      const void* u3, const int* idx, const float* wts,
                                      const float* bias, void* out, int h0, int h1, int h2,
                                      int h3, int w0, int w1, int w2, int w3, int n, int B,
                                      int TH, int TW, int O, int is_bf16, void* stream) {
  Inputs in;
  in.u[0] = u0; in.u[1] = u1; in.u[2] = u2; in.u[3] = u3;
  in.h[0] = h0; in.h[1] = h1; in.h[2] = h2; in.h[3] = h3;
  in.w[0] = w0; in.w[1] = w1; in.w[2] = w2; in.w[3] = w3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(in, idx, wts, bias, out, n, B, TH, TW, O, s);
  else
    launch<float>(in, idx, wts, bias, out, n, B, TH, TW, O, s);
  return (int)cudaGetLastError();
}
