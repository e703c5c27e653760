// K11: depthwise 3x3x3 attention pool on the channel-last layout.
//
// Replaces the TPU kernel diff_sal_tpu/ops/pool.py:217 depthwise_pool3d
// (body _pool_kernel :75, pallas_call :175), which walks T sequentially with
// a ring of two VMEM accumulators and reads strided taps through phase views
// so that x is read at most once. On the H100 the pool is bound by bytes: 27
// multiply-adds per output element against one read of the input pixels
// some tap touches and one write of out.
//
// What held the first kernel back: one thread per output position gathered
// its 27 taps, so a stride-1 pool loaded every input element 27 times
// through L1 and every weight once per tap; the strided kv pools launched a
// CTA or less per SM, each thread 27 dependent-latency loads. The design:
// - A thread owns a strip of SW outputs along W (4 where neighbouring
//   outputs share column taps, sw <= 2, else 1) and V = 2 channels, and walks the temporal planes of its block of `tb` output
//   planes once, as the TPU kernel walks T with its ring: each input plane
//   ti is loaded once per strip and added to out[ti + 1] (kt = 0), out[ti]
//   (kt = 1) and out[ti - 1] (kt = 2) in three rolling f32 accumulators;
//   out[ti - 1] is complete after plane ti and is written, and the
//   accumulators shift.
// - Per input row, the columns the strip's taps touch are loaded once into
//   registers: SW + 2 columns at stride 1, 2 SW + 1 at stride 2 (adjacent
//   outputs share their column taps), three per output at larger strides.
//   A plane's three rows are loaded together, and the next plane's loads
//   are issued before this plane's products (its raw values wait in
//   registers), so the walk does not stop for memory at every plane.
// - The 27 f32 weights of the thread's two channels stay in registers (54),
//   loaded once. (Four channels a thread held 108 and ran at 160-236
//   registers: fewer warps per SM, each plane's loads exposed.)
// - Per output the sum keeps the order (kt, kh, kw), with f32 FMAs, as the
//   first kernel and the plain version's order, and is rounded once.
// - The launch plan (`pool_plan` in ops/pool.py) picks SW from the column
//   stride and `tb` from the call's size: a thread walks all T unless the
//   grid would leave SMs without a CTA, and then the planes split over the
//   grid until it does not. (On the H100 80GB HBM3 at 700 W, at the model's
//   11 pool shapes, more threads with shorter walks lost to the longest
//   walk that still gives every SM a CTA, but at two shapes by 10-15%;
//   halving the walk until two CTAs sit on every SM was slower per run:
//   tests/k8_k11_probe.py, PERF.md §6, PR 11.)
// What bounds it is not bytes: at the model's small calls a warp walks
// ~10 planes of ~350 dependent instructions at 8-16 warps per SM, which
// takes 3-6x the bytes bound. Two other designs were slower on the card:
// the next two planes' loads in flight (the registers spill), and a CTA
// staging the planes' rows in a cp.async ring for its threads.
//
// x is read in place: its pixels lie `ps` elements apart (ps >= C), so the
// q or kv columns of the qkv projection's output are pooled without a copy.
// Layouts: x (B, T, H, W, [ps]) with C channels used, w (3, 3, 3, C) f32,
// out (B, T, Ho, Wo, C) contiguous; temporal stride 1, padding 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // per CTA; mirrored by POOL_THREADS in ops/pool.py
constexpr int V = 2;          // channels per thread

template <typename T>
struct Vec;

// Raw: V channels as loaded (kept so until the plane's products begin)
template <>
struct Vec<__nv_bfloat16> {
  using Raw = uint32_t;
  __device__ static Raw load(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }
  __device__ static Raw zero() { return 0u; }
  __device__ static void unpack(Raw raw, float* f) {
    f[0] = __uint_as_float(raw << 16);
    f[1] = __uint_as_float(raw & 0xffff0000u);
  }
  __device__ static void store(__nv_bfloat16* p, const float* f) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(f[0], f[1]);
  }
};

template <>
struct Vec<float> {
  using Raw = float2;
  __device__ static Raw load(const float* p) { return *reinterpret_cast<const float2*>(p); }
  __device__ static Raw zero() { return make_float2(0.f, 0.f); }
  __device__ static void unpack(Raw raw, float* f) {
    f[0] = raw.x;
    f[1] = raw.y;
  }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  }
};

// Columns a strip of SW outputs loads from one input row, by stride class
// SC (1, 2, or 0 for any larger stride), and the column that tap kw of
// output j reads among them.
template <int SW, int SC>
struct Cols {
  static constexpr int N = SC == 1 ? SW + 2 : SC == 2 ? 2 * SW + 1 : 3 * SW;
  __device__ static int col(int j, int kw) { return SC == 1 ? j + kw : SC == 2 ? 2 * j + kw : 3 * j + kw; }
  // input column of loaded column k, for the strip starting at output wo0
  __device__ static int input(int k, int wo0, int sw) {
    return SC == 0 ? (wo0 + k / 3) * sw + k % 3 - 1 : wo0 * SC - 1 + k;
  }
};

// acc[j] += v[col(j, kw)] * w[tap kw] over the strip, kw in order
template <int SW, int SC>
__device__ __forceinline__ void fma_row(float (&acc)[SW][V], const float (&v)[Cols<SW, SC>::N][V],
                                        const float (&w)[27][V], int tap0) {
#pragma unroll
  for (int j = 0; j < SW; ++j)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int c = 0; c < V; ++c) acc[j][c] += v[Cols<SW, SC>::col(j, kw)][c] * w[tap0 + kw][c];
}

template <typename T, int SW, int SC>
__global__ void __launch_bounds__(THREADS)
    pool_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out, int B,
                int Tn, int H, int W, int C, long long ps, int Ho, int Wo, int sh, int sw,
                int tb, int strips) {
  using CL = Cols<SW, SC>;
  using Raw = typename Vec<T>::Raw;
  const int groups = C / V, tblocks = (Tn + tb - 1) / tb;
  const int total = B * tblocks * Ho * strips * groups;  // < 2^31 (the entry checks)
  const int tid = blockIdx.x * THREADS + threadIdx.x;
  if (tid >= total) return;
  const int g = tid % groups;
  int r = tid / groups;
  const int s = r % strips;
  r /= strips;
  const int ho = r % Ho;
  r /= Ho;
  const int tk = r % tblocks;
  const int b = r / tblocks;
  const int c0 = g * V, wo0 = s * SW, t_lo = tk * tb, t_hi = min(Tn, t_lo + tb);

  // where the strip's taps lie within a plane, and which exist: the same
  // for every plane, so a plane's loads add only the plane's offset
  int roff[3], coff[CL::N];
  bool rok[3], cok[CL::N];
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int hi = ho * sh + kh - 1;
    rok[kh] = hi >= 0 && hi < H;
    roff[kh] = (rok[kh] ? hi : 0) * W * (int)ps;
  }
#pragma unroll
  for (int k = 0; k < CL::N; ++k) {
    const int wi = CL::input(k, wo0, sw);
    cok[k] = wi >= 0 && wi < W;
    coff[k] = (cok[k] ? wi : 0) * (int)ps;
  }
  // plane ti's three rows as the strip's taps read them (zero outside)
  auto load_plane = [&](Raw (&raw)[3][CL::N], int ti) {
    const bool t_ok = ti >= 0 && ti < Tn;
    const T* plane = x + ((long long)b * Tn + (t_ok ? ti : 0)) * H * W * ps + c0;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int k = 0; k < CL::N; ++k)
        raw[kh][k] = t_ok && rok[kh] && cok[k] ? Vec<T>::load(plane + roff[kh] + coff[k])
                                                 : Vec<T>::zero();
  };
  Raw nxt[3][CL::N];
  load_plane(nxt, t_lo - 1);

  float wt[27][V];
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(w + (long long)k * C + c0));
    wt[k][0] = v.x; wt[k][1] = v.y;
  }
  // acc[0], acc[1], acc[2]: out[ti - 1], out[ti], out[ti + 1] while plane ti
  // is added
  float acc[3][SW][V];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int j = 0; j < SW; ++j)
#pragma unroll
      for (int c = 0; c < V; ++c) acc[a][j][c] = 0.f;

  for (int ti = t_lo - 1; ti <= t_hi; ++ti) {
    // plane ti unpacked, and plane ti + 1's loads in flight while its
    // products run
    float v[3][CL::N][V];
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int k = 0; k < CL::N; ++k) Vec<T>::unpack(nxt[kh][k], v[kh][k]);
    if (ti < t_hi) load_plane(nxt, ti + 1);
    if (ti >= 0 && ti < Tn) {
      // which of the three outputs this plane feeds are the thread's
      const bool o0 = ti - 1 >= t_lo, o1 = ti >= t_lo && ti < t_hi, o2 = ti + 1 < t_hi;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        if (!rok[kh]) continue;
        // kt = 0 into out[ti + 1], kt = 1 into out[ti], kt = 2 into out[ti - 1]
        if (o2) fma_row<SW, SC>(acc[2], v[kh], wt, (0 * 3 + kh) * 3);
        if (o1) fma_row<SW, SC>(acc[1], v[kh], wt, (1 * 3 + kh) * 3);
        if (o0) fma_row<SW, SC>(acc[0], v[kh], wt, (2 * 3 + kh) * 3);
      }
    }
    const int t = ti - 1;  // complete: every plane that feeds it was added
    if (t >= t_lo && t < t_hi) {
      T* o = out + (((long long)b * Tn + t) * Ho + ho) * (long long)Wo * C + c0;
#pragma unroll
      for (int j = 0; j < SW; ++j)
        if (wo0 + j < Wo) Vec<T>::store(o + (long long)(wo0 + j) * C, acc[0][j]);
    }
#pragma unroll
    for (int j = 0; j < SW; ++j)
#pragma unroll
      for (int c = 0; c < V; ++c) {
        acc[0][j][c] = acc[1][j][c];
        acc[1][j][c] = acc[2][j][c];
        acc[2][j][c] = 0.f;
      }
  }
}

template <typename T, int SW, int SC>
int launch(const void* x, const float* w, void* out, int B, int Tn, int H, int W, int C,
           long long ps, int Ho, int Wo, int sh, int sw, int tb, cudaStream_t stream) {
  const int strips = (Wo + SW - 1) / SW, tblocks = (Tn + tb - 1) / tb;
  const long long total = (long long)B * tblocks * Ho * strips * (C / V);
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  pool_kernel<T, SW, SC><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), B, Tn, H, W, C, ps, Ho, Wo, sh, sw, tb,
      strips);
  return (int)cudaGetLastError();
}

template <typename T, int SW>
int launch_sc(const void* x, const float* w, void* out, int B, int Tn, int H, int W, int C,
              long long ps, int Ho, int Wo, int sh, int sw, int tb, cudaStream_t s) {
  if (sw == 1) return launch<T, SW, 1>(x, w, out, B, Tn, H, W, C, ps, Ho, Wo, sh, sw, tb, s);
  if (sw == 2) return launch<T, SW, 2>(x, w, out, B, Tn, H, W, C, ps, Ho, Wo, sh, sw, tb, s);
  return launch<T, SW, 0>(x, w, out, B, Tn, H, W, C, ps, Ho, Wo, sh, sw, tb, s);
}

template <typename T>
int launch_sw(const void* x, const float* w, void* out, int B, int Tn, int H, int W, int C,
              long long ps, int Ho, int Wo, int sh, int sw, int strip, int tb, cudaStream_t s) {
  if (strip == 4) return launch_sc<T, 4>(x, w, out, B, Tn, H, W, C, ps, Ho, Wo, sh, sw, tb, s);
  return launch_sc<T, 1>(x, w, out, B, Tn, H, W, C, ps, Ho, Wo, sh, sw, tb, s);
}

}  // namespace

// strip (SW) and tb (output planes per thread) come from `pool_plan`
extern "C" int dsal_depthwise_pool3d(const void* x, const float* w, void* out, int B, int T,
                                     int H, int W, int C, int ps, int Ho, int Wo, int sh,
                                     int sw, int strip, int tb, int is_bf16, void* stream) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || C < V || C % V != 0 || ps < C || ps % V != 0 ||
      sh < 1 || sw < 1 || Ho != (H - 1) / sh + 1 || Wo != (W - 1) / sw + 1 ||
      (strip != 1 && strip != 4) || tb < 1 || tb > T ||
      (long long)B * ((T + tb - 1) / tb) * Ho * ((Wo + strip - 1) / strip) * (C / V) >= (1LL << 31) ||
      (long long)H * W * ps >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_sw<__nv_bfloat16>(x, w, out, B, T, H, W, C, ps, Ho, Wo, sh, sw, strip, tb, s);
  return launch_sw<float>(x, w, out, B, T, H, W, C, ps, Ho, Wo, sh, sw, strip, tb, s);
}
