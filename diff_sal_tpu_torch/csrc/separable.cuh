// The separable two-pass resize that K4 (csrc/resize.cu) and K9
// (csrc/resize_phase.cu) share: for every input i (n <= 4) of shape
// (B, h_i, w_i, ...) and every output (b, y, x, channels)
//
//   mid_i[y, c, sx, :] = to_M(sum_sy sum_row-taps wy * x_i[row, c, sy, sx, :])
//   out[y, x, :]       = sum_i sum_sx sum_col-taps wx * mid_i[y, col, sx, :]
//
// with NS shifts per axis: NS = 1 for K4 (the bilinear resize-sum; M = f32,
// the TPU body's f32 `t1`), NS = 3 for K9 (the conv-at-low-res head: x_i is
// u_i = x_i K' with its (dy, dx, O) columns, the shifts are the 3x3 taps, M
// is u's dtype because the TPU kernel rounds the dy contraction there, and
// the output gets the f32 bias and ReLU).
//
// What held the gather kernels back: one thread per (output pixel, 16 bytes
// of channels) recomputed the row contraction for every output column, 16
// (K4) or up to 144 (K9) loads of 16 bytes from L1/L2 per 16 bytes written.
// The row contraction depends on (output row, input column), not on the
// output column, and there are 2-16x fewer input columns than output ones.
// The design:
// - A work unit is (b, a band of BH output rows, a column tile of `tw`
//   output columns, a chunk of `cc` channels) of all n inputs. The CTAs are
//   persistent, two per SM, and walk the units, so a tile's column taps
//   are staged once per CTA, not once per unit.
// - The band's row taps are staged in shared memory per unit as {lo, hi,
//   w_lo, w_hi} (a tap whose weight is 0 is marked -1 and never read: K9's
//   shifted tables carry dead taps past the borders); a tile's column taps
//   once per tile and CTA, with the input columns their live taps
//   reach, [cmin_i, cmax_i] (warp min / max reductions and shared-memory
//   atomics: order-free, so deterministic), each pair rewritten as its
//   first column in the intermediate and its weights on that column and
//   the next.
// - Row pass: a thread owns (input, input column, sx, V channels). Per
//   (input, sy) the band's live row taps of an input no larger than the
//   output reach at most BH + 1 consecutive rows: the CTA stages their
//   first row and a dense (BH, BH + 1) block of the weights, and the thread
//   issues the loads of every sy's window rows at once, two items' where
//   NS = 1 (16-byte loads, neighbouring threads on neighbouring channels,
//   coalesced; each input row read once per band), then sums in f32 and
//   writes mid_i to shared memory once, converted to M. Windows wider than
//   BH + 1 rows (inputs larger than the output) take the taps one by one
//   with a two-row register cache. The inputs are not staged: at the head's
//   width a band's rows of u_i would take 2-3x the shared memory of mid_i.
// - Column pass: a thread owns (RB output rows, a strip of STRIP output
//   columns, V channels; RB = 2 in f32, where each staged tap pair then
//   serves two rows, 1 in bf16), sums every input's and shift's two column
//   taps from shared memory in f32 registers, adds the bias and ReLU where
//   NS = 3, rounds once and makes 16-byte stores. A tap pair is (lo, lo + 1), and lo moves
//   by 0 or 1 between neighbouring outputs of a map no larger than the
//   output, so a window of two columns slides along the strip (one load
//   where it moves, none where it stays) and the pair's weights go straight
//   onto its two columns: two FMAs per channel and tap pair, no selects.
// - mid_i of every input stays resident for the unit (the host plan sizes
//   BH, tw and cc so that it fits two CTAs per SM), so the outputs are
//   written once and no sum crosses units: the order of every sum is fixed,
//   the same bits every launch.
// What bounds it on the H100 80GB HBM3 (tests/k4_k9_probe.py, PERF.md §6):
// the passes run one after the other within a CTA, and each is about as
// fast with 16 warps per SM as with more. K4 at the decoder's shape takes
// ~83 us a call: the setup (staging, launch) ~9.5 us, the row pass ~27 us
// (~93 MB of row loads through L2), the column pass ~40 us (without its
// stores ~10 us less). Measured and not kept: loading the row taps one at
// a time behind a row cache (~3x slower), a select-based column cache,
// warp-specialised CTAs running the row pass of the next unit beside the
// column pass of this one from a double buffer (8 warps per pass: 1.2x
// slower), three CTAs per SM, 512 threads, strips of two, the column pass
// unrolled over the inputs (each 0-12% slower), the row pass's per-input
// tables kept in registers (no gain), two rows per column-pass thread in
// bf16 (registers spilled: 1.3x slower; in f32 it is kept, 1.1x faster).
// Layouts: x_i (B, h_i, w_i, NS * NS * C) with (sy, sx, C) columns, out
// (B, H, W, C), contiguous, one dtype T (bf16 or f32); tap tables idx (n, 2,
// L) int32 [lo | hi] and wts (n, 2, L) f32 [w_lo | w_hi], L = NS (H + W):
// entry sy * H + y is output row y under shift sy, entry NS H + sx W + x
// output column x under shift sx. The launch geometry (BH, cc, tw, cols,
// CTAs) is the host plan's (`ops/resize.py:_sep_plan`), checked by the entry.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sep {

constexpr int THREADS = 256;     // per CTA; mirrored by SEP_THREADS in ops/resize.py
constexpr int STRIP = 4;         // output columns per thread in the column pass (SEP_STRIP)
constexpr int MAX_INPUTS = 4;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory one CTA may use on the H100
constexpr int INTS = 48;          // per input cmin, span, offset; the row pass's first items;
                                  // the row windows' first row and count per (input, sy)

// V consecutive channels of T in device memory, as f32: 16 bytes
template <typename T>
struct Gv;

template <>
struct Gv<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& raw, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
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
struct Gv<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& raw, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&raw);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static void load(const float* p, float* f) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
  }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// V channels of M in a shared-memory row of G groups. f32 rows hold V / 4
// parts of 16 bytes, part h of group g at byte (h G + g) 16, so the threads
// of a quarter warp (neighbouring groups) touch 128 consecutive bytes per
// part; a bf16 group is one part of 16 bytes.
template <typename M, int V>
struct Sv;

template <int V>
struct Sv<float, V> {
  __device__ static void store(unsigned char* row, int g, int G, const float* f) {
#pragma unroll
    for (int h = 0; h < V / 4; ++h)
      *reinterpret_cast<float4*>(row + (h * G + g) * 16) =
          make_float4(f[4 * h], f[4 * h + 1], f[4 * h + 2], f[4 * h + 3]);
  }
  __device__ static void load(const unsigned char* row, int g, int G, float* f) {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      float4 v = *reinterpret_cast<const float4*>(row + (h * G + g) * 16);
      f[4 * h] = v.x; f[4 * h + 1] = v.y; f[4 * h + 2] = v.z; f[4 * h + 3] = v.w;
    }
  }
};

template <>
struct Sv<__nv_bfloat16, 8> {
  // the store rounds to bf16: K9's rounding of the dy contraction
  __device__ static void store(unsigned char* row, int g, int, const float* f) {
    Gv<__nv_bfloat16>::store(reinterpret_cast<__nv_bfloat16*>(row + g * 16), f);
  }
  __device__ static void load(const unsigned char* row, int g, int, float* f) {
    uint4 raw = *reinterpret_cast<const uint4*>(row + g * 16);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
};

// a staged tap pair: lo / hi are -1 where the weight is 0
struct Tap {
  int lo, hi;
  float wl, wh;
};

struct Args {
  const void* x[MAX_INPUTS];
  int h[MAX_INPUTS], w[MAX_INPUTS];
  const int* idx;
  const float* wts;
  const float* bias;  // (C,) f32 where NS == 3
  void* out;
  int n, B, H, W, C;
  int cc, tw, cols;  // channels per chunk, output columns per tile, staged columns per row
  int units;         // (band, chunk, b, column tile) work units, set by `launch`
};

// shared-memory bytes of a CTA: the tile's column taps, the band's row taps,
// the small ints, mid (BH, cols, NS, cc) of M, and the row windows' dense
// weights (n, NS, BH, BH + 1) f32; mirrored by sep_smem in ops/resize.py
inline long long smem_bytes(int n, int ns, int bh, int tw, int cols, int cc, int mid_bytes) {
  return (long long)(n * ns * tw + n * ns * bh) * (long long)sizeof(Tap) + INTS * 4 +
         (long long)bh * cols * ns * cc * mid_bytes + (long long)n * ns * bh * (bh + 1) * 4;
}

// input i's pointer and shape, without indexing the parameters by a
// runtime value (that copies them to local memory)
template <typename T>
__device__ inline void input(const Args& a, int i, const T*& x, int& h, int& w) {
  x = static_cast<const T*>(a.x[0]);
  h = a.h[0];
  w = a.w[0];
#pragma unroll
  for (int j = 1; j < MAX_INPUTS; ++j)
    if (i == j) {
      x = static_cast<const T*>(a.x[j]);
      h = a.h[j];
      w = a.w[j];
    }
}

// the column taps of output columns [x0, x0 + nw) (a tile), the input
// columns their live taps reach, then each pair as its first column in mid
// and its weights on that column and the next (hi is lo + 1, or lies on lo
// where lo is dead); every thread of the CTA takes part, and the last
// barrier publishes the tables
template <int NS>
__device__ void stage_tile(const Args& a, int x0, int nw, Tap* ctab, int* cmin, int* span,
                           int* off) {
  const int n = a.n, H = a.H, W = a.W, tw = a.tw, tid = threadIdx.x;
  const int L = NS * (H + W);
  if (tid < MAX_INPUTS) {
    cmin[tid] = 0x7fffffff;
    span[tid] = -1;
  }
  __syncthreads();
  int lo_i[MAX_INPUTS], hi_i[MAX_INPUTS];
#pragma unroll
  for (int j = 0; j < MAX_INPUTS; ++j) {
    lo_i[j] = 0x7fffffff;
    hi_i[j] = -1;
  }
#pragma unroll 4
  for (int e = tid; e < n * NS * tw; e += THREADS) {
    const int i = e / (NS * tw), r = e % (NS * tw), s = r / tw, x = r % tw;
    Tap tp = {-1, -1, 0.f, 0.f};
    if (x < nw) {
      const int k = i * 2 * L + NS * H + s * W + x0 + x;
      tp.wl = __ldg(a.wts + k);
      tp.wh = __ldg(a.wts + k + L);
      const int lo = __ldg(a.idx + k), hi = __ldg(a.idx + k + L);
      if (tp.wl != 0.f) tp.lo = lo;
      if (tp.wh != 0.f) tp.hi = hi;
    }
    const int anchor = tp.lo >= 0 ? tp.lo : tp.hi;
    const bool next = tp.hi >= 0 && tp.hi == anchor + 1;
    ctab[e] = {anchor, -1,
               (tp.lo >= 0 ? tp.wl : 0.f) + (tp.hi >= 0 && !next ? tp.wh : 0.f),
               next ? tp.wh : 0.f};
#pragma unroll
    for (int j = 0; j < MAX_INPUTS; ++j)
      if (i == j && anchor >= 0) {
        lo_i[j] = min(lo_i[j], anchor);
        hi_i[j] = max(hi_i[j], next ? anchor + 1 : anchor);
      }
  }
#pragma unroll
  for (int j = 0; j < MAX_INPUTS; ++j) {
    lo_i[j] = __reduce_min_sync(0xffffffffu, lo_i[j]);
    hi_i[j] = __reduce_max_sync(0xffffffffu, hi_i[j]);
  }
  if ((tid & 31) == 0)
    for (int j = 0; j < n; ++j) {
      atomicMin(&cmin[j], lo_i[j]);
      atomicMax(&span[j], hi_i[j]);
    }
  __syncthreads();
  if (tid == 0) {
    int o = 0;
    for (int i = 0; i < n; ++i) {
      const int s = span[i] >= cmin[i] ? span[i] - cmin[i] + 1 : 0;
      span[i] = s;
      off[i] = o;
      o += s;
    }
    if (o > a.cols) __trap();  // the plan staged fewer columns than the taps reach
  }
  __syncthreads();
  for (int e = tid; e < n * NS * tw; e += THREADS) {
    const int i = e / (NS * tw);
    if (ctab[e].lo >= 0) ctab[e].lo += off[i] - cmin[i];
  }
  __syncthreads();
}

template <typename T, typename M, int NS, int BH>
__global__ void __launch_bounds__(THREADS, 2) separable_kernel(Args a) {
  constexpr int V = Gv<T>::V;
  constexpr int R = BH + 1;             // rows of a dense row window
  constexpr int IPT = NS == 1 ? 2 : 1;  // row-pass items in flight per thread
  // band rows per column-pass thread: two where the channel vector is 4 wide
  // (f32); at 8 (bf16) two rows' accumulators and windows spill registers
  constexpr int RB = (V == 4 && BH >= 2) ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, H = a.H, W = a.W, C = a.C, tw = a.tw, cc = a.cc;
  const int L = NS * (H + W);
  const int bands = (H + BH - 1) / BH, chunks = (C + cc - 1) / cc;
  const int G = cc / V;                  // groups of the layout
  const int rowb = cc * (int)sizeof(M);  // bytes of one (row, column, sx) of mid
  const long long step = (long long)NS * rowb;  // bytes between columns of mid
  const int xs = NS * NS * C;            // elements between input columns

  Tap* ctab = reinterpret_cast<Tap*>(smem);  // (n, NS, tw): {mid column, -, w0, w1}
  Tap* rtab = ctab + n * NS * tw;            // (n, NS, BH): the band's row taps
  int* cmin = reinterpret_cast<int*>(rtab + n * NS * BH);
  int* span = cmin + MAX_INPUTS;             // the columns the tile's taps reach per input
  int* off = span + MAX_INPUTS;
  int* first = off + MAX_INPUTS;             // the row pass's first item of input i, and the total
  int* rlo = first + 2 * MAX_INPUTS;         // (n, NS): the window's first row, -1 for the tap loop
  int* rcnt = rlo + 3 * MAX_INPUTS;          // (n, NS): rows in the window
  unsigned char* mid = reinterpret_cast<unsigned char*>(cmin + INTS);
  float* wd = reinterpret_cast<float*>(mid + (long long)BH * a.cols * NS * rowb);  // (n, NS, BH, R)
  const int tid = threadIdx.x;

  int tile = -1;
  for (int unit = blockIdx.x; unit < a.units; unit += gridDim.x) {
    // a unit: (band, chunk, b, column tile), bands fastest
    int u = unit;
    const int band = u % bands;
    u /= bands;
    const int c0 = (u % chunks) * cc;
    u /= chunks;
    const int b = u % a.B, t = u / a.B;
    const int y0 = band * BH, x0 = t * tw;
    const int nh = min(BH, H - y0), nw = min(tw, W - x0);
    const int Gc = min(cc, C - c0) / V;  // groups this chunk holds

    if (t != tile) {
      tile = t;
      __syncthreads();  // the last unit's column pass has read the tile's taps
      stage_tile<NS>(a, x0, nw, ctab, cmin, span, off);
    }
    // the band's row taps per (input, sy), and their window where it is at
    // most R rows wide: its first row, its rows and the dense weights
    if (tid < n * NS) {
      const int i = tid / NS, sy = tid % NS;
      Tap ts[BH];
      int mn = 0x7fffffff, mx = -1;
#pragma unroll
      for (int yy = 0; yy < BH; ++yy) {
        Tap tp = {-1, -1, 0.f, 0.f};
        if (yy < nh) {
          const int k = i * 2 * L + sy * H + y0 + yy;
          tp.wl = __ldg(a.wts + k);
          tp.wh = __ldg(a.wts + k + L);
          const int lo = __ldg(a.idx + k), hi = __ldg(a.idx + k + L);
          if (tp.wl != 0.f) tp.lo = lo;
          if (tp.wh != 0.f) tp.hi = hi;
        }
        ts[yy] = tp;
        rtab[tid * BH + yy] = tp;
        if (tp.lo >= 0) mn = min(mn, tp.lo), mx = max(mx, tp.lo);
        if (tp.hi >= 0) mn = min(mn, tp.hi), mx = max(mx, tp.hi);
      }
      const int cnt = mx >= 0 ? mx - mn + 1 : 0;
      rlo[tid] = cnt <= R ? (cnt ? mn : 0) : -1;
      rcnt[tid] = cnt;
      float* wrow = wd + tid * BH * R;
#pragma unroll
      for (int yy = 0; yy < BH; ++yy) {
#pragma unroll
        for (int r = 0; r < R; ++r) wrow[yy * R + r] = 0.f;
        if (cnt && cnt <= R && yy < nh) {
          if (ts[yy].lo >= 0) wrow[yy * R + ts[yy].lo - mn] += ts[yy].wl;
          if (ts[yy].hi >= 0) wrow[yy * R + ts[yy].hi - mn] += ts[yy].wh;
        }
      }
    }
    if (tid == 0) {
      int it = 0;
      for (int i = 0; i < n; ++i) {
        first[i] = it;
        it += span[i] * NS * Gc;
      }
      first[n] = it;
    }
    __syncthreads();  // also: every thread is done with the last unit's mid

    // ---- row pass: mid_i[yy, col, sx, group g], IPT items at a time ------
    const int items = first[n];
    for (int it0 = tid; it0 < items; it0 += IPT * THREADS) {
      int ii[IPT], cx[IPT], sxs[IPT], gs[IPT];
      const T* bases[IPT];
      long long rows[IPT];
      uint4 raw[IPT][NS][R];
#pragma unroll
      for (int p = 0; p < IPT; ++p) {
        const int it = it0 + p * THREADS;
        int i = 0;
        if (it < items)
          while (it >= first[i + 1]) ++i;
        int r = it < items ? it - first[i] : 0;
        gs[p] = r % Gc;
        r /= Gc;
        sxs[p] = r % NS;
        cx[p] = r / NS;
        ii[p] = it < items ? i : -1;
        const T* x;
        int h, w;
        input<T>(a, i, x, h, w);
        bases[p] = x + ((long long)b * h * w + cmin[i] + cx[p]) * xs + sxs[p] * C + c0 + gs[p] * V;
        rows[p] = (long long)w * xs;
        // every sy's window rows, loaded at once
#pragma unroll
        for (int sy = 0; sy < NS; ++sy) {
          const int r0 = rlo[i * NS + sy], cnt = rcnt[i * NS + sy];
#pragma unroll
          for (int q = 0; q < R; ++q)
            raw[p][sy][q] = (ii[p] >= 0 && r0 >= 0 && q < cnt)
                                ? __ldg(reinterpret_cast<const uint4*>(
                                      bases[p] + sy * NS * C + (r0 + q) * rows[p]))
                                : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int p = 0; p < IPT; ++p) {
        const int i = ii[p];
        if (i < 0) continue;
        float acc[BH][V];
#pragma unroll
        for (int yy = 0; yy < BH; ++yy)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[yy][e] = 0.f;
#pragma unroll
        for (int sy = 0; sy < NS; ++sy) {
          if (rlo[i * NS + sy] >= 0) {
            const float* wrow = wd + (i * NS + sy) * BH * R;
#pragma unroll
            for (int q = 0; q < R; ++q) {
              float v[V];
              Gv<T>::unpack(raw[p][sy][q], v);
#pragma unroll
              for (int yy = 0; yy < BH; ++yy) {
                const float wy = wrow[yy * R + q];
#pragma unroll
                for (int e = 0; e < V; ++e) acc[yy][e] += wy * v[e];
              }
            }
            continue;
          }
          // a window wider than R rows: the taps one by one, a two-row cache
          const T* col = bases[p] + sy * NS * C;
          const Tap* ts = rtab + (i * NS + sy) * BH;
          int r0 = -1, r1 = -1;
          float v0[V], v1[V];
#pragma unroll
          for (int yy = 0; yy < BH; ++yy) {
            if (yy >= nh) break;
            const Tap tp = ts[yy];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int row = q ? tp.hi : tp.lo;
              const float wy = q ? tp.wh : tp.wl;
              if (row < 0) continue;
              if (row != r0 && row != r1) {
#pragma unroll
                for (int e = 0; e < V; ++e) v0[e] = v1[e];
                r0 = r1;
                r1 = row;
                Gv<T>::load(col + row * rows[p], v1);
              }
              const bool one = row == r1;
#pragma unroll
              for (int e = 0; e < V; ++e) acc[yy][e] += wy * (one ? v1[e] : v0[e]);
            }
          }
        }
#pragma unroll
        for (int yy = 0; yy < BH; ++yy)
          if (yy < nh)
            Sv<M, V>::store(mid + ((long long)(yy * a.cols + off[i] + cx[p]) * NS + sxs[p]) * rowb,
                            gs[p], G, acc[yy]);
      }
    }
    __syncthreads();

    // ---- column pass: out[y0 + yy .. + RB, x0 + xs0 .. + STRIP, c0 + g V ..]
    // A thread owns RB rows of the band, a strip and V channels, so each
    // staged tap pair is read once for its RB rows. Per input, shift and row
    // a window of two neighbouring columns of mid slides along the strip: a
    // tap pair reads the window's two columns, and the window moves by one
    // column (one load) or jumps (two loads) only where the pair's first
    // column moves
    const int strips = (nw + STRIP - 1) / STRIP, pairs = (nh + RB - 1) / RB;
    for (int it = tid; it < pairs * strips * Gc; it += THREADS) {
      const int g = it % Gc, r = it / Gc;
      const int xs0 = (r % strips) * STRIP, y1 = (r / strips) * RB;
      float acc[RB][STRIP][V];
#pragma unroll
      for (int yy = 0; yy < RB; ++yy)
#pragma unroll
        for (int j = 0; j < STRIP; ++j)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[yy][j][e] = 0.f;
      for (int i = 0; i < n; ++i) {
        const int end = off[i] + span[i];
#pragma unroll
        for (int sx = 0; sx < NS; ++sx) {
          const unsigned char* rows0 = mid + ((long long)y1 * a.cols * NS + sx) * rowb;
          const long long rowstep = (long long)a.cols * NS * rowb;  // bytes between rows of mid
          const Tap* tap = ctab + (i * NS + sx) * tw + xs0;
          int cw = -2;  // the window's first column in mid
          float v0[RB][V], v1[RB][V];
#pragma unroll
          for (int j = 0; j < STRIP; ++j) {
            if (xs0 + j >= nw) break;
            const Tap tp = tap[j];
            const int cs = tp.lo;
            if (cs < 0) continue;
            if (cs != cw) {
#pragma unroll
              for (int yy = 0; yy < RB; ++yy) {
                if (y1 + yy >= nh) break;
                const unsigned char* rw = rows0 + yy * rowstep;
                if (cs == cw + 1) {
#pragma unroll
                  for (int e = 0; e < V; ++e) v0[yy][e] = v1[yy][e];
                } else {
                  Sv<M, V>::load(rw + cs * step, g, G, v0[yy]);
                }
                if (cs + 1 < end) {
                  Sv<M, V>::load(rw + (cs + 1) * step, g, G, v1[yy]);
                } else {
#pragma unroll
                  for (int e = 0; e < V; ++e) v1[yy][e] = 0.f;
                }
              }
              cw = cs;
            }
#pragma unroll
            for (int yy = 0; yy < RB; ++yy)
#pragma unroll
              for (int e = 0; e < V; ++e)
                acc[yy][j][e] = fmaf(tp.wh, v1[yy][e], fmaf(tp.wl, v0[yy][e], acc[yy][j][e]));
          }
        }
      }
#pragma unroll
      for (int yy = 0; yy < RB; ++yy) {
        if (y1 + yy >= nh) break;
        T* o = static_cast<T*>(a.out) + (((long long)b * H + y0 + y1 + yy) * W + x0 + xs0) * C +
               c0 + g * V;
#pragma unroll
        for (int j = 0; j < STRIP; ++j) {
          if (xs0 + j >= nw) break;
          if (NS == 3) {
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[yy][j][e] = fmaxf(acc[yy][j][e] + __ldg(a.bias + c0 + g * V + e), 0.f);
          }
          Gv<T>::store(o + (long long)j * C, acc[yy][j]);
        }
      }
    }
  }
}

template <typename T, typename M, int NS, int BH>
int launch_bh(const Args& a, int ctas, int smem, cudaStream_t stream) {
  auto kernel = separable_kernel<T, M, NS, BH>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(min(ctas, a.units));
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// checks the plan and launches; returns a CUDA error code
template <typename T, typename M, int NS>
int launch(Args a, int bh, int ctas, cudaStream_t stream) {
  constexpr int V = Gv<T>::V;
  if (a.n < 1 || a.n > MAX_INPUTS || a.B < 1 || a.H < 1 || a.W < 1 || a.C < V || a.C % V ||
      a.cc < V || a.cc % V || a.tw < 1 || a.cols < 1 || ctas < 1 || (bh != 1 && bh != 2 && bh != 4))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a.n; ++i)
    if (a.h[i] < 1 || a.w[i] < 1) return (int)cudaErrorInvalidValue;
  const long long units = (long long)((a.H + bh - 1) / bh) * ((a.C + a.cc - 1) / a.cc) * a.B *
                          ((a.W + a.tw - 1) / a.tw);
  const long long smem = smem_bytes(a.n, NS, bh, a.tw, a.cols, a.cc, (int)sizeof(M));
  if (units >= (1LL << 31) || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  a.units = (int)units;
  switch (bh) {
    case 1: return launch_bh<T, M, NS, 1>(a, ctas, (int)smem, stream);
    case 2: return launch_bh<T, M, NS, 2>(a, ctas, (int)smem, stream);
    default: return launch_bh<T, M, NS, 4>(a, ctas, (int)smem, stream);
  }
}

}  // namespace sep
