// K5 and K12's backward in f32: the instances an f32 model (both packages'
// default compute dtype) runs on the card when it takes a gradient. The f32
// forward (K1 and K12 in f32) is csrc/attention_f32_fwd.cu; these kernels
// read the logsumexp it saves.
//
// The same functions as csrc/attention_bwd.cu (the TPU kernels
// diff_sal_tpu/ops/attention.py:761 _fba2_bwd and :280 _fba_bwd, which take
// f32 as they take bf16), with every product in f32 by FFMA on the CUDA
// cores. In f32 nothing is rounded between the steps (p_lo = p, ds_lo = ds),
// as the plain versions compute at f32. They are bound by operations (five
// (Lq, Lk, D) products per head); FFMA peaks at ~67 TFLOP/s, and split TF32
// on the tensor cores (as the forward runs) would reach 165: a redesign
// that has not been made, so these kernels lose to the library call
// (PERF.md).
//
// Layouts: q, k, v, g (B, L, H*D) with the (t, h, w) bias terms read
// through RelIn (K5: one (B, Lq, H, kt + kh + kw) tensor; K12: B*heads
// batches of one head, three (B*heads, Lq, kt | kh | kw) tensors). A warp
// owns 8 rows (query rows, or keys in the k-major backward) and its lanes
// take one column each of a 32-wide tile of the other axis, so every dot
// product is a lane's own loop over D, reductions over a tile are warp
// shuffles, and products with the tile run over the lanes' D columns.
//  - q-major (dq, drel, delta): two passes over the key tiles (delta =
//    rowsum(dp * p), then ds); drel sums ds over the keys of each t, h and
//    w bin in key order, lane c owning bins c, c + 32, ...;
//  - k-major (dk, dv), one CTA per 32 keys and query split, the splits'
//    f32 partial sums reduced in a fixed order.
// No atomics: two runs give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bias.cuh"

namespace {

constexpr int T = 32;         // rows per warp-tile column set: keys or query rows per tile
constexpr int WR = 8;         // rows per warp
constexpr int NW = 4;         // warps per CTA
constexpr int NT = NW * 32;
constexpr int ROWS = NW * WR;  // rows per CTA
constexpr int MAX_K = 128;    // kt + kh + kw

struct Params {
  const float *q, *k, *v, *g, *lse;
  float *dq, *delta, *work;
  RelIn<float> rel;
  RelOut<float> drel;
  int B, Lq, Lk, H, kt, kh, kw, res_from, splits;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// `n` rows [row0, row0 + n) of head h of a (B, L, H*D) tensor into shared
// memory with row stride ld, times `mul`; rows past L are zero
template <int D>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* dst, int ld, int n,
                                          int b, int L, int row0, int H, int h, float mul) {
  for (int i = threadIdx.x; i < n * D; i += NT) {
    const int r = i / D, c = i - r * D, row = row0 + r;
    dst[r * ld + c] = row < L ? src[((size_t)b * L + row) * H * D + h * D + c] * mul : 0.f;
  }
}

// raw rel rows [row0, row0 + n) of head h: [K terms | 0 | -inf], zero past Lq
__device__ __forceinline__ void load_rel(const RelIn<float>& rel, float* dst, int ld, int n,
                                         int b, int Lq, int row0, int h, int kt, int kh, int K) {
  for (int i = threadIdx.x; i < n * K; i += NT) {
    const int r = i / K, c = i - r * K, row = row0 + r;
    int cc;
    const int part = rel_part(c, kt, kh, cc);
    dst[r * ld + c] =
        row < Lq ? rel.p[part][((size_t)b * Lq + row) * rel.ld[part] + h * rel.hs + cc] : 0.f;
  }
  for (int r = threadIdx.x; r < n; r += NT) {
    dst[r * ld + K] = 0.f;
    dst[r * ld + K + 1] = -INFINITY;
  }
}

// ------------------------------------------- backward: dq, drel, delta ---

template <int D>
__global__ void __launch_bounds__(NT) f32_bwd_q_kernel(const Params p) {
  extern __shared__ float sm[];
  const int K = p.kt + p.kh + p.kw, LR = K + 2;
  float* Qs = sm;                    // ROWS x D, scaled
  float* Gs = Qs + ROWS * D;         // ROWS x D
  float* Ks = Gs + ROWS * D;         // T x (D + 1)
  float* Vs = Ks + T * (D + 1);      // T x (D + 1)
  float* Rs = Vs + T * (D + 1);      // ROWS x LR
  int* Et = reinterpret_cast<int*>(Rs + ROWS * LR);  // T key indices
  const int qtiles = (p.Lq + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / qtiles, q0 = (blockIdx.x - bh * qtiles) * ROWS;
  const int b = bh / p.H, h = bh - b * p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int C = D / 32;
  constexpr int NB = MAX_K / 32;  // bins per lane: lane + 32 c

  load_rows<D>(p.q, Qs, D, ROWS, b, p.Lq, q0, p.H, h, p.scale);
  load_rows<D>(p.g, Gs, D, ROWS, b, p.Lq, q0, p.H, h, 1.f);
  load_rel(p.rel, Rs, LR, ROWS, b, p.Lq, q0, h, p.kt, p.kh, K);
  float lse[WR], dsum[WR], dq[WR][C], dr[WR][NB];
#pragma unroll
  for (int i = 0; i < WR; ++i) {
    const int row = q0 + warp * WR + i;
    lse[i] = row < p.Lq ? p.lse[(size_t)bh * p.Lq + row] : 0.f;
    dsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) dq[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NB; ++c) dr[i][c] = 0.f;
  }
  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = 0; j0 < p.Lk; j0 += T) {
      __syncthreads();
      load_rows<D>(p.k, Ks, D + 1, T, b, p.Lk, j0, p.H, h, 1.f);
      load_rows<D>(p.v, Vs, D + 1, T, b, p.Lk, j0, p.H, h, 1.f);
      if (threadIdx.x < T) Et[threadIdx.x] = key_index(j0 + threadIdx.x, p.Lk, p.kt, p.kh, p.kw);
      __syncthreads();
      const int e = Et[lane];
#pragma unroll
      for (int i = 0; i < WR; ++i) {
        const int r = warp * WR + i;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(Qs[r * D + d], Ks[lane * (D + 1) + d], s);
          dp = fmaf(Gs[r * D + d], Vs[lane * (D + 1) + d], dp);
        }
        const float pr = expf(s + bias_at(Rs + r * LR, e) - lse[i]);
        if (pass == 0) {
          dsum[i] = fmaf(pr, dp, dsum[i]);
          continue;
        }
        const float ds = pr * (dp - dsum[i]);
        for (int jj = 0; jj < T; ++jj) {
          const float dj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
          for (int c = 0; c < C; ++c)
            dq[i][c] = fmaf(dj, Ks[jj * (D + 1) + lane + 32 * c], dq[i][c]);
          const int ej = Et[jj], et = ej & 1023, eh = (ej >> 10) & 1023, ew = ej >> 20;
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            const int bin = lane + 32 * c;
            if (bin < K && (bin == et || bin == eh || bin == ew)) dr[i][c] += dj;
          }
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < WR; ++i) dsum[i] = warp_sum(dsum[i]);  // delta
    }
  }
#pragma unroll
  for (int i = 0; i < WR; ++i) {
    const int row = q0 + warp * WR + i;
    if (row >= p.Lq) continue;
    const size_t base = ((size_t)b * p.Lq + row) * p.H * D + h * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float x = dq[i][c] * p.scale;
      if (row >= p.res_from) x += p.g[base + lane + 32 * c];
      p.dq[base + lane + 32 * c] = x;
    }
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const int bin = lane + 32 * c;
      if (bin >= K) continue;
      int cc;
      const int part = rel_part(bin, p.kt, p.kh, cc);
      p.drel.p[part][((size_t)b * p.Lq + row) * p.drel.ld[part] + h * p.drel.hs + cc] = dr[i][c];
    }
    if (lane == 0) p.delta[(size_t)bh * p.Lq + row] = dsum[i];
  }
}

// ------------------------------------------ backward: dk, dv partials ---

template <int D>
__global__ void __launch_bounds__(NT) f32_bwd_kv_kernel(const Params p) {
  extern __shared__ float sm[];
  const int K = p.kt + p.kh + p.kw, LR = K + 2;
  float* Ks = sm;                     // ROWS x D (this CTA's keys)
  float* Vs = Ks + ROWS * D;          // ROWS x D
  float* Qs = Vs + ROWS * D;          // T x (D + 1), scaled
  float* Qr = Qs + T * (D + 1);       // T x (D + 1), unscaled
  float* Gs = Qr + T * (D + 1);       // T x (D + 1)
  float* Rs = Gs + T * (D + 1);       // T x LR
  float* Ls = Rs + T * LR;            // T lse
  float* Ds = Ls + T;                 // T delta
  const int ktiles = (p.Lk + ROWS - 1) / ROWS, per_bh = p.splits * ktiles;
  const int bh = blockIdx.x / per_bh, rem = blockIdx.x - bh * per_bh;
  const int split = rem / ktiles, k0 = (rem - split * ktiles) * ROWS;
  const int b = bh / p.H, h = bh - b * p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int C = D / 32;
  const int n_qt = (p.Lq + T - 1) / T, per = (n_qt + p.splits - 1) / p.splits;
  const int qt1 = min(n_qt, (split + 1) * per);

  load_rows<D>(p.k, Ks, D, ROWS, b, p.Lk, k0, p.H, h, 1.f);
  load_rows<D>(p.v, Vs, D, ROWS, b, p.Lk, k0, p.H, h, 1.f);
  int e[WR];
  float dk[WR][C], dv[WR][C];
#pragma unroll
  for (int i = 0; i < WR; ++i) {
    e[i] = key_index(k0 + warp * WR + i, p.Lk, p.kt, p.kh, p.kw);
#pragma unroll
    for (int c = 0; c < C; ++c) dk[i][c] = dv[i][c] = 0.f;
  }
  for (int qt = split * per; qt < qt1; ++qt) {
    const int q0 = qt * T;
    __syncthreads();
    load_rows<D>(p.q, Qs, D + 1, T, b, p.Lq, q0, p.H, h, p.scale);
    load_rows<D>(p.q, Qr, D + 1, T, b, p.Lq, q0, p.H, h, 1.f);
    load_rows<D>(p.g, Gs, D + 1, T, b, p.Lq, q0, p.H, h, 1.f);
    load_rel(p.rel, Rs, LR, T, b, p.Lq, q0, h, p.kt, p.kh, K);
    if (threadIdx.x < T) {
      const int row = q0 + threadIdx.x;
      // padded rows: p = 0
      Ls[threadIdx.x] = row < p.Lq ? p.lse[(size_t)bh * p.Lq + row] : INFINITY;
      Ds[threadIdx.x] = row < p.Lq ? p.delta[(size_t)bh * p.Lq + row] : 0.f;
    }
    __syncthreads();
    const float lse = Ls[lane], dlt = Ds[lane];
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      const int r = warp * WR + i;  // key row of the CTA
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(Ks[r * D + d], Qs[lane * (D + 1) + d], s);
        dp = fmaf(Vs[r * D + d], Gs[lane * (D + 1) + d], dp);
      }
      const float pr = expf(s + bias_at(Rs + lane * LR, e[i]) - lse);
      const float ds = pr * (dp - dlt);
      for (int ll = 0; ll < T; ++ll) {
        const float pl = __shfl_sync(0xffffffffu, pr, ll);
        const float dl = __shfl_sync(0xffffffffu, ds, ll);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dv[i][c] = fmaf(pl, Gs[ll * (D + 1) + lane + 32 * c], dv[i][c]);
          dk[i][c] = fmaf(dl, Qr[ll * (D + 1) + lane + 32 * c], dk[i][c]);
        }
      }
    }
  }
  const int HD = p.H * D;
  const size_t plane = (size_t)p.splits * p.B * p.Lk * HD;
#pragma unroll
  for (int i = 0; i < WR; ++i) {
    const int key = k0 + warp * WR + i;
    if (key >= p.Lk) continue;
    float* dst = p.work + ((size_t)split * p.B + b) * p.Lk * HD + (size_t)key * HD + h * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dst[lane + 32 * c] = dk[i][c] * p.scale;
      dst[plane + lane + 32 * c] = dv[i][c];
    }
  }
}

__global__ void f32_reduce_kernel(const float* __restrict__ work, float* __restrict__ dk,
                                  float* __restrict__ dv, long long n, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < splits; ++s) {
      sk += work[(size_t)s * n + i];
      sv += work[((size_t)splits + s) * n + i];
    }
    dk[i] = sk;
    dv[i] = sv;
  }
}

// --------------------------------------------------------------- host ---

template <typename KernelT>
int launch(KernelT kernel, int grid, size_t smem, cudaStream_t s, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int bwd(const Params& p, float* dk, float* dv, cudaStream_t s) {
  const int LR = p.kt + p.kh + p.kw + 2;
  const size_t sq = (size_t)(2 * ROWS * D + 2 * T * (D + 1) + ROWS * LR + T) * 4;
  int rc = launch(f32_bwd_q_kernel<D>, p.B * p.H * ((p.Lq + ROWS - 1) / ROWS), sq, s, p);
  if (rc != 0) return rc;
  const size_t sk = (size_t)(2 * ROWS * D + 3 * T * (D + 1) + T * LR + 2 * T) * 4;
  rc = launch(f32_bwd_kv_kernel<D>, p.B * p.H * p.splits * ((p.Lk + ROWS - 1) / ROWS), sk, s, p);
  if (rc != 0) return rc;
  const long long n = (long long)p.B * p.Lk * p.H * D;
  const long long blocks = (n + 255) / 256;
  f32_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(p.work, dk, dv, n,
                                                                            p.splits);
  return (int)cudaGetLastError();
}

bool valid(const Params& p, int D) {
  const int K = p.kt + p.kh + p.kw;
  return (D == 64 || D == 96 || D == 128) && p.Lq >= 1 && p.Lk >= 1 && K >= 1 && K <= MAX_K;
}

int run_bwd(const Params& p, int D, void* dk, void* dv, void* stream) {
  if (!valid(p, D) || p.splits < 1 || p.lse == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* k = static_cast<float*>(dk);
  float* v = static_cast<float*>(dv);
  return D == 64 ? bwd<64>(p, k, v, s) : (D == 96 ? bwd<96>(p, k, v, s) : bwd<128>(p, k, v, s));
}

RelIn<float> packed_rel(const void* rel, int H, int kt, int kh, int kw) {
  const float* r = static_cast<const float*>(rel);
  const int K = kt + kh + kw;
  return {{r, r + kt, r + kt + kh}, {H * K, H * K, H * K}, K};
}

}  // namespace

// K5 in f32: as dsal_bias_attention_f32 plus g, lse (B, H, Lq) from the
// forward, outputs dq, dk, dv, drel, workspaces delta (B, H, Lq) and work
// (2, splits, B, Lk, H*D)
extern "C" int dsal_bias_attention_bwd_f32(const void* q, const void* k, const void* v,
                                           const void* rel, const void* g, const void* lse,
                                           void* dq, void* dk, void* dv, void* drel, void* delta,
                                           void* work, int B, int Lq, int Lk, int H, int D,
                                           int kt, int kh, int kw, int splits, float scale,
                                           int residual, void* stream) {
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.g = static_cast<const float*>(g);
  p.lse = static_cast<const float*>(lse);
  p.dq = static_cast<float*>(dq);
  p.delta = static_cast<float*>(delta);
  p.work = static_cast<float*>(work);
  p.rel = packed_rel(rel, H, kt, kh, kw);
  float* dr = static_cast<float*>(drel);
  const int K = kt + kh + kw;
  p.drel = {{dr, dr + kt, dr + kt + kh}, {H * K, H * K, H * K}, K};
  p.B = B; p.Lq = Lq; p.Lk = Lk; p.H = H; p.kt = kt; p.kh = kh; p.kw = kw;
  p.res_from = residual ? 0 : Lq;
  p.splits = splits;
  p.scale = scale;
  return run_bwd(p, D, dk, dv, stream);
}

// K12's backward in f32: (BH, L, D) layouts, three rel and drel tensors
extern "C" int dsal_cls_attention_bwd_f32(const void* q, const void* k, const void* v,
                                          const void* rel_t, const void* rel_h, const void* rel_w,
                                          const void* g, const void* lse, void* dq, void* dk,
                                          void* dv, void* drel_t, void* drel_h, void* drel_w,
                                          void* delta, void* work, int BH, int Lq, int Lk, int D,
                                          int kt, int kh, int kw, int splits, float scale,
                                          int residual, void* stream) {
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.g = static_cast<const float*>(g);
  p.lse = static_cast<const float*>(lse);
  p.dq = static_cast<float*>(dq);
  p.delta = static_cast<float*>(delta);
  p.work = static_cast<float*>(work);
  p.rel = {{static_cast<const float*>(rel_t), static_cast<const float*>(rel_h),
            static_cast<const float*>(rel_w)}, {kt, kh, kw}, 0};
  p.drel = {{static_cast<float*>(drel_t), static_cast<float*>(drel_h),
             static_cast<float*>(drel_w)}, {kt, kh, kw}, 0};
  p.B = BH; p.Lq = Lq; p.Lk = Lk; p.H = 1; p.kt = kt; p.kh = kh; p.kw = kw;
  p.res_from = residual ? 1 : Lq;
  p.splits = splits;
  p.scale = scale;
  return run_bwd(p, D, dk, dv, stream);
}
