// K8: the decoder's fused head, relu(conv3x3_same(sum_i resize(x_i)) + b),
// with BatchNorm folded into the conv's kernel and bias; a bf16 instance and
// an f32 one (an f32 model's head).
//
// Replaces the TPU kernel diff_sal_tpu/ops/resize.py:388 resize_sum_conv_relu
// (body _resize_sum_conv_kernel :334), which builds the multi-scale
// resize-sum of a row tile with its one-row halo in VMEM, 128 channels at a
// time, and contracts it with the nine shifted 3x3 taps on the MXU into an
// f32 accumulator carried across the sequential channel grid. On the H100
// the head is bound by operations: 9 * C * O multiply-adds per output pixel
// (5.7e10 flops per call at B = 2, 112x192, C = 768, O = 96; 57 us at the
// bf16 tensor peak) against ~30 MB of inputs and output. The (H, W, C)
// resize-sum never reaches device memory.
//
// bf16 (`dsal_resize_conv_relu`): a warp-specialised implicit GEMM on wgmma.
// - A CTA owns a tile of TH x TW = 8 x 16 output pixels (M = 128) and all O
//   <= 128 output channels, and walks C in chunks of KC = 32 channels
//   through a ring of two shared-memory stages behind mbarrier full/empty
//   pairs.
// - Two producer warpgroups compute the resize-sum of the tile's 10 x 18
//   halo for the chunk (2x2 half-pixel taps of every input, f32 weights and
//   sums, zero outside the map: the conv's 'same' padding), round it to
//   bf16 as the TPU kernel rounds it for its MXU, and write it three times,
//   once per dx shift: copy dx holds halo rows 0..9 x tile columns 0..15
//   shifted by dx, K-major without swizzle (8-row core matrices). So the A
//   operand of tap (dy, dx) is copy dx from row 16 dy: a whole number of
//   8-row groups, a shared-memory descriptor. (The other way, A from
//   registers loaded by ldmatrix at any row offset, costs the consumer four
//   ldmatrix per product and a register dependence before every wgmma; the
//   copies cost the producers two more 16-byte stores per halo pixel. This
//   choice rests on that argument: the ldmatrix form was not built. What it
//   could save the producers was timed, by a copy of this kernel whose
//   producers store each halo pixel once: PERF.md §6, PR 11.)
//   Their f32 weights and tap rows and columns come from `_tap_tables`
//   (ops/resize.py), staged per tile in shared memory. The input pixels
//   the halo's taps reach (<= 105 over the four inputs at the decoder's
//   head) are staged per chunk by cp.async into one of two patch buffers,
//   a chunk ahead, so each crosses L2 once per tile and chunk, where the
//   taps read most of them two to four times.
// - One producer thread brings the chunk's (3, 3, 32, O) kernel slice in by
//   TMA: nine boxes of 32 channels x NP rows of the kernel transposed to
//   (9 O, C) by the wrapper, 64-byte swizzle (NP: O rounded up to a wgmma
//   width; the extra rows are never written out).
// - One consumer warpgroup runs the 9 taps x 2 k-steps x 2 halves of the
//   tile as wgmma m64nNPk16 products (A and B from shared memory) into f32
//   accumulators in registers, then releases the stage.
// - Epilogue: bias, ReLU, bf16, one write per output.
// What bounds it: the gather. Per chunk the producers read 180 x 4 x 4 x 4
// 16-byte taps (pixels x 8-channel groups x inputs x taps) and do their f32
// sums, more time than the chunk's products on one SM (on the H100 80GB
// HBM3 at 700 W, at the head's shape: producers alone 0.60 ms per two
// calls, the products and copies alone 0.31, both 0.64;
// tests/k8_k11_probe.py). Reading the taps straight from
// device memory, with L1 squeezed by this much shared memory, was slower.
//
// f32 (`dsal_resize_conv_relu_f32`, fault F5: the TPU kernel computes in the
// input's dtype): the resize-sum stays f32 and the products run at f32's
// accuracy in split TF32 on mma.sync m16n8k8 (csrc/tf32.cuh, as the f32
// instances of K3 and K7), f32 sums flushed every FLUSH k-steps. The same
// 8 x 16 tile; eight warps each own one tile row (16 pixels) and all NP
// output columns. Per chunk of 16 channels every thread gathers halo jobs
// into a double-buffered f32 halo, and the chunk's kernel slice arrives by
// cp.async one chunk ahead into a double buffer: one __syncthreads a chunk.
//
// Layouts: x_i (B, h_i, w_i, C), bias (O) f32, out (B, H, W, O), contiguous;
// bf16: the kernel as (9 O, C) bf16, tap-major; f32: (3, 3, C, O) f32.
// C % 16 == 0, O % 16 == 0, O <= 128. Tap tables as K4's (csrc/resize.cu):
// idx (n, 2, H + W) int32 [lo | hi], wts (n, 2, H + W) f32 [w_lo | w_hi],
// rows first, then columns. `conv_plan` (ops/resize.py) mirrors the tile,
// NP and the shared memory; the entries refuse an NP that does not match.

#include "tf32.cuh"

namespace {

constexpr int TH = 8;                 // tile rows
constexpr int TW = 16;                // tile columns
constexpr int HR = TH + 2;            // halo rows
constexpr int HC = TW + 2;            // halo columns
constexpr int HALO = HR * HC;         // halo pixels (180)
constexpr int MAX_IN = 4;
constexpr int TABLE_BYTES = MAX_IN * (HR + HC) * 16;  // per input and halo row / column: lo, hi, w_lo, w_hi
constexpr int SMEM_MAX = 232448;

// bf16
constexpr int KC = 32;                // channels per chunk
constexpr int AKB = HR * TW * 32;     // one 16-channel k-block of a dx copy (160 rows x 32 bytes)
constexpr int ABUF = 2 * AKB;         // one dx copy
constexpr int A_BYTES = 3 * ABUF;     // the three dx copies
constexpr int STAGES = 2;
constexpr int PRODUCERS = 256;        // two producer warpgroups
constexpr int THREADS = 128 + PRODUCERS;

// f32
constexpr int FKC = 16;               // channels per chunk (two k8 steps: one FLUSH)
constexpr int FHS = FKC + 4;          // halo pixel stride in floats (no bank conflicts)
constexpr int FTHREADS = 32 * TH;     // one warp per tile row

// Mirrored by `conv_smem` in ops/resize.py (the bf16 instance's below).
constexpr int conv_stage_bytes(int np) { return A_BYTES + 9 * np * 64; }
constexpr int conv_f32_smem(int np) {
  return 2 * HALO * FHS * 4 + 2 * 9 * FKC * (np + 8) * 4 + TABLE_BYTES;
}

template <typename T>
struct ConvArgs {
  const T* x[MAX_IN];
  int h[MAX_IN], w[MAX_IN];
  const int* idx;
  const float* wts;
  const float* bias;
  T* out;
  int n, H, W, C, O;
};

// The tile's halo rows and columns per input: the input row (column) of the
// lo and hi taps and their weights; -1 outside the map, where the sum is 0.
struct Tables {
  int rlo[MAX_IN][HR], rhi[MAX_IN][HR], clo[MAX_IN][HC], chi[MAX_IN][HC];
  float rwl[MAX_IN][HR], rwh[MAX_IN][HR], cwl[MAX_IN][HC], cwh[MAX_IN][HC];
};
static_assert(sizeof(Tables) == TABLE_BYTES, "table layout");

template <typename T>
__device__ void fill_tables(Tables& tb, const ConvArgs<T>& a, int y0, int x0, int t, int nt) {
  const int L = a.H + a.W;
  for (int e = t; e < MAX_IN * (HR + HC); e += nt) {
    const int i = e / (HR + HC), j = e % (HR + HC);
    int lo = -1, hi = -1;
    float wl = 0.f, wh = 0.f;
    const bool row = j < HR;
    const int pos = row ? y0 - 1 + j : x0 - 1 + (j - HR);
    if (i < a.n && pos >= 0 && pos < (row ? a.H : a.W)) {
      const int at = row ? pos : a.H + pos;
      lo = a.idx[i * 2 * L + at];
      hi = a.idx[i * 2 * L + L + at];
      wl = a.wts[i * 2 * L + at];
      wh = a.wts[i * 2 * L + L + at];
    }
    if (row) {
      tb.rlo[i][j] = lo; tb.rhi[i][j] = hi; tb.rwl[i][j] = wl; tb.rwh[i][j] = wh;
    } else {
      tb.clo[i][j - HR] = lo; tb.chi[i][j - HR] = hi; tb.cwl[i][j - HR] = wl; tb.cwh[i][j - HR] = wh;
    }
  }
}

__device__ __forceinline__ void load_vec(const bf16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

// s += the 2x2 taps of input i at halo pixel (hy, hx): t00 t01 t10 t11 are
// the taps (lo row lo column, lo hi, hi lo, hi hi) in f32
template <int N>
__device__ __forceinline__ void add_taps(const Tables& tb, int i, int hy, int hx, float (&s)[N],
                                         const float (&t00)[N], const float (&t01)[N],
                                         const float (&t10)[N], const float (&t11)[N]) {
  const float wyl = tb.rwl[i][hy], wyh = tb.rwh[i][hy], wxl = tb.cwl[i][hx], wxh = tb.cwh[i][hx];
  const float w0 = wyl * wxl, w1 = wyl * wxh, w2 = wyh * wxl, w3 = wyh * wxh;
#pragma unroll
  for (int e = 0; e < N; ++e) s[e] += w0 * t00[e];
#pragma unroll
  for (int e = 0; e < N; ++e) s[e] += w1 * t01[e];
#pragma unroll
  for (int e = 0; e < N; ++e) s[e] += w2 * t10[e];
#pragma unroll
  for (int e = 0; e < N; ++e) s[e] += w3 * t11[e];
}

// s += input i's 2x2 taps at halo pixel (hy, hx), channels ch .. ch + N - 1
// of batch item b, loaded from device memory; nothing outside the map
template <typename T, int N>
__device__ __forceinline__ void add_input(const Tables& tb, const ConvArgs<T>& a, int i, int b,
                                          int ch, int hy, int hx, float (&s)[N]) {
  const int rl = tb.rlo[i][hy], rh = tb.rhi[i][hy], cl = tb.clo[i][hx], chh = tb.chi[i][hx];
  if (rl < 0 || cl < 0) return;
  const int w = a.w[i];
  const T* base = a.x[i] + (size_t)b * a.h[i] * w * a.C + ch;
  float t0[N], t1[N], t2[N], t3[N];
  load_vec(base + ((size_t)rl * w + cl) * a.C, t0);
  load_vec(base + ((size_t)rl * w + chh) * a.C, t1);
  load_vec(base + ((size_t)rh * w + cl) * a.C, t2);
  load_vec(base + ((size_t)rh * w + chh) * a.C, t3);
  add_taps(tb, i, hy, hx, s, t0, t1, t2, t3);
}

// The resize-sum of halo pixel (hy, hx) at channels ch .. ch + N - 1 of
// batch item b, in f32, input by input.
template <typename T, int N>
__device__ __forceinline__ void halo_sum(const Tables& tb, const ConvArgs<T>& a, int b, int ch,
                                         int hy, int hx, float (&s)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) s[e] = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_IN; ++i)
    if (i < a.n) add_input<T, N>(tb, a, i, b, ch, hy, hx, s);
}

// bf16: the input pixels an input's taps reach from the tile's halo, for one
// chunk, staged in shared memory (rows r0 .. r0 + nr - 1, columns c0 ..
// c0 + nc - 1, PIX bytes a pixel, from pixel `start` of the patch buffer);
// nr = 0 where they do not fit (an input larger than the tile's share of
// it, or the buffer full), which then reads device memory
struct Patch {
  int r0, nr, c0, nc, start, pad[3];
};
constexpr int PR = HR + 1, PC = HC + 1;  // the largest patch: an input at the output's size
constexpr int PIX = KC * 2 + 16;         // 64 bytes of channels, 16 of padding (no bank conflicts)
constexpr int PATCH_PIX = 128;           // pixels a patch buffer holds (the head needs <= 105)
constexpr int PATCH_BYTES = PATCH_PIX * PIX;

// ------------------------------------------------------------------ bf16 --

// the ring, its mbarriers, the tables, the patches' bounds and the two
// patch buffers
constexpr int conv_smem(int np) {
  return 1024 + STAGES * conv_stage_bytes(np) + 16 * STAGES + TABLE_BYTES + MAX_IN * 32 +
         2 * PATCH_BYTES;
}
static_assert(conv_smem(128) <= SMEM_MAX && conv_f32_smem(128) <= SMEM_MAX,
              "a CTA at the widest O fits in shared memory");

// threads 0..127: the consumer warpgroup; 128..383: the producers
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
    resize_conv_kernel(const __grid_constant__ CUtensorMap tk, const ConvArgs<bf16> a) {
  constexpr int STAGE = A_BYTES + 9 * NP * 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem), bars = base + STAGES * STAGE;
  Tables& tb = *reinterpret_cast<Tables*>(smem + STAGES * STAGE + 16 * STAGES);
  Patch* pinfo = reinterpret_cast<Patch*>(&tb + 1);
  unsigned char* patch = reinterpret_cast<unsigned char*>(pinfo + MAX_IN);
  const int tid = threadIdx.x, lane = tid & 31;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  const int chunks = (a.C + KC - 1) / KC;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), PRODUCERS / 32 + 1);  // each producer warp, and the TMA's expect_tx
      mbar_init(empty(s), 4);                  // each consumer warp
    }
    fence_mbar_init();
  }
  if (tid >= 128) fill_tables(tb, a, y0, x0, tid - 128, PRODUCERS);
  __syncthreads();

  if (tid >= 128) {
    // producers: lane & 7 picks a pixel of an 8-pixel block, lane >> 3 one of
    // the chunk's four 8-channel groups, so that a store phase of eight lanes
    // writes eight rows of one core matrix
    constexpr int PW = PRODUCERS / 32, PER = ((HALO + 7) / 8 + PW - 1) / PW;
    const int pt = tid - 128, pw = pt >> 5, pl = lane & 7, grp = lane >> 3;
    // each input's patch: the bounds of the taps of the tile's halo, placed
    // one after another in the patch buffer while they fit
    if (pt == 0) {
      int used = 0;
      for (int i = 0; i < a.n; ++i) {
        int r0 = 1 << 30, r1 = -1, c0 = 1 << 30, c1 = -1;
        for (int j = 0; j < HR; ++j)
          if (tb.rlo[i][j] >= 0) {
            r0 = min(r0, tb.rlo[i][j]);
            r1 = max(r1, tb.rhi[i][j]);
          }
        for (int j = 0; j < HC; ++j)
          if (tb.clo[i][j] >= 0) {
            c0 = min(c0, tb.clo[i][j]);
            c1 = max(c1, tb.chi[i][j]);
          }
        const int nr = r1 - r0 + 1, nc = c1 - c0 + 1;
        const bool fits = r1 >= r0 && c1 >= c0 && nr <= PR && nc <= PC && used + nr * nc <= PATCH_PIX;
        pinfo[i] = Patch{r0, fits ? nr : 0, c0, nc, used, {0, 0, 0}};
        if (fits) used += nr * nc;
      }
    }
    named_sync(1, PRODUCERS);
    const int npix = a.n > 0 ? pinfo[a.n - 1].start + pinfo[a.n - 1].nr * pinfo[a.n - 1].nc : 0;
    // chunk c's patches into buffer c & 1 by cp.async (zeros past C): each
    // input pixel read once, where the taps read most of them two to four
    // times (and L1 is small beside this much shared memory)
    auto stage_patches = [&](int c) {
      unsigned char* buf = patch + (c & 1) * PATCH_BYTES;
      for (int j = pt; j < npix * 4; j += PRODUCERS) {
        const int g4 = j & 3, q = j >> 2, chj = c * KC + g4 * 8;
        int i = 0;
        while (i + 1 < a.n && pinfo[i + 1].start <= q) ++i;
        const Patch pi = pinfo[i];
        const int px = q - pi.start;
        if (pi.nr == 0 || px >= pi.nr * pi.nc) continue;
        const bf16* xb = a.x[i] + (size_t)b * a.h[i] * a.w[i] * a.C;
        const bool ok = chj < a.C;
        const bf16* src = xb + ((size_t)(pi.r0 + px / pi.nc) * a.w[i] + pi.c0 + px % pi.nc) * a.C + chj;
        cp16(smem_u32(buf + q * PIX + g4 * 16), ok ? src : xb, ok);
      }
      cp_commit();
    };
    stage_patches(0);
    for (int c = 0; c < chunks; ++c) {
      const int s = c % STAGES;
      mbar_wait(empty(s), ((c / STAGES) & 1) ^ 1);
      const uint32_t st = base + s * STAGE;
      if (pt == 0) {
        mbar_expect_tx(full(s), 9 * NP * 64);
        for (int t = 0; t < 9; ++t) tma_load(st + A_BYTES + t * NP * 64, &tk, full(s), c * KC, t * a.O, 0);
      }
      // chunk c's patches have landed everywhere, and chunk c - 1's taps are
      // read: its buffer takes chunk c + 1's patches while these are read
      cp_wait<0>();
      named_sync(1, PRODUCERS);
      if (c + 1 < chunks) stage_patches(c + 1);
      const unsigned char* buf = patch + (c & 1) * PATCH_BYTES;
      const int ch = c * KC + grp * 8;
      float sv[PER][8];
#pragma unroll
      for (int k = 0; k < PER; ++k)
#pragma unroll
        for (int e = 0; e < 8; ++e) sv[k][e] = 0.f;
      for (int i = 0; i < a.n; ++i) {
        const Patch pi = pinfo[i];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int p = (pw + PW * k) * 8 + pl;
          if (p >= HALO || ch >= a.C) continue;
          const int hy = p / HC, hx = p % HC;
          if (pi.nr == 0) {
            add_input<bf16, 8>(tb, a, i, b, ch, hy, hx, sv[k]);
            continue;
          }
          const int rl = tb.rlo[i][hy], cl = tb.clo[i][hx];
          if (rl < 0 || cl < 0) continue;
          const int rh = tb.rhi[i][hy], chh = tb.chi[i][hx];
          const unsigned char* q = buf + pi.start * PIX + grp * 16;
          float t0[8], t1[8], t2[8], t3[8];
          load_vec(reinterpret_cast<const bf16*>(q + ((rl - pi.r0) * pi.nc + cl - pi.c0) * PIX), t0);
          load_vec(reinterpret_cast<const bf16*>(q + ((rl - pi.r0) * pi.nc + chh - pi.c0) * PIX), t1);
          load_vec(reinterpret_cast<const bf16*>(q + ((rh - pi.r0) * pi.nc + cl - pi.c0) * PIX), t2);
          load_vec(reinterpret_cast<const bf16*>(q + ((rh - pi.r0) * pi.nc + chh - pi.c0) * PIX), t3);
          add_taps(tb, i, hy, hx, sv[k], t0, t1, t2, t3);
        }
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int p = (pw + PW * k) * 8 + pl;
        if (p >= HALO) continue;
        const int hy = p / HC, hx = p % HC;
        const uint4 v = make_uint4(pack_bf16(sv[k][0], sv[k][1]), pack_bf16(sv[k][2], sv[k][3]),
                                   pack_bf16(sv[k][4], sv[k][5]), pack_bf16(sv[k][6], sv[k][7]));
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int col = hx - dx;
          if (col >= 0 && col < TW) {
            const int m = hy * TW + col;
            *reinterpret_cast<uint4*>(smem + s * STAGE + dx * ABUF + (grp >> 1) * AKB +
                                      (m >> 3) * 256 + (grp & 1) * 128 + (m & 7) * 16) = v;
          }
        }
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(full(s));
    }
    return;
  }

  // the consumer warpgroup: half h of the tile is pixels 64 h .. 64 h + 63
  float acc[2][NP / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[h][i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % STAGES;
    mbar_wait(full(s), (c / STAGES) & 1);
    const uint32_t st = base + s * STAGE;
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    wg_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t db = sw64_desc(st + A_BYTES + tap * NP * 64 + kk * 32, 16, 512);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_ss<NP>(acc[h], plain_desc(st + dx * ABUF + kk * AKB + (2 * dy + 8 * h) * 256, 128, 256),
                       db, 1);
      }
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // epilogue: bias, ReLU, bf16
  const int r0 = (tid >> 5) * 16 + (lane >> 2), cb = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = 64 * h + r0 + 8 * hf, y = y0 + m / TW, x = x0 + m % TW, o = 8 * j + cb;
        if (y < a.H && x < a.W && o < a.O) {
          const float v0 = fmaxf(acc[h][4 * j + 2 * hf] + a.bias[o], 0.f);
          const float v1 = fmaxf(acc[h][4 * j + 2 * hf + 1] + a.bias[o + 1], 0.f);
          *reinterpret_cast<uint32_t*>(a.out + (((size_t)b * a.H + y) * a.W + x) * a.O + o) =
              pack_bf16(v0, v1);
        }
      }
}

// ------------------------------------------------------------------- f32 --

// warp w owns tile row w: pixels x0 .. x0 + 15 of row y0 + w
template <int NP>
__global__ void __launch_bounds__(FTHREADS, 1)
    resize_conv_f32_kernel(const float* __restrict__ kern, const ConvArgs<float> a) {
  constexpr int NT = NP / 8, BS = NP + 8, BBUF = 9 * FKC * BS;  // n-tiles, B row stride
  constexpr int NB = NT % 4 == 0 ? 4 : 2;  // n-tiles per split-TF32 pass
  extern __shared__ __align__(16) unsigned char smem_f[];
  float* halo = reinterpret_cast<float*>(smem_f);   // [2][HALO][FHS]
  float* bt = halo + 2 * HALO * FHS;                // [2][9][FKC][BS]
  Tables& tb = *reinterpret_cast<Tables*>(bt + 2 * BBUF);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  const int chunks = (a.C + FKC - 1) / FKC;

  // the chunk's kernel slice (tap, channel, output) by cp.async, zero past
  // C and O
  auto load_b = [&](int c) {
    float* dst = bt + (c & 1) * BBUF;
    for (int j = tid; j < 9 * FKC * (NP / 4); j += FTHREADS) {
      const int row = j / (NP / 4), o = (j % (NP / 4)) * 4;
      const int tap = row / FKC, k = c * FKC + row % FKC;
      const bool ok = k < a.C && o < a.O;
      cp16(smem_u32(dst + row * BS + o), ok ? kern + ((size_t)tap * a.C + k) * a.O + o : kern, ok);
    }
    cp_commit();
  };

  fill_tables(tb, a, y0, x0, tid, FTHREADS);
  load_b(0);
  __syncthreads();

  float d[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[n][i] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    // the chunk's halo resize-sum, 4 channels a job, into halo[c & 1]
    float* hb = halo + (c & 1) * HALO * FHS;
    for (int j = tid; j < HALO * (FKC / 4); j += FTHREADS) {
      const int p = j % HALO, grp = j / HALO, ch = c * FKC + grp * 4;
      float sv[4];
      if (ch < a.C) {
        halo_sum<float, 4>(tb, a, b, ch, p / HC, p % HC, sv);
      } else {
        sv[0] = sv[1] = sv[2] = sv[3] = 0.f;
      }
      *reinterpret_cast<float4*>(hb + p * FHS + grp * 4) = make_float4(sv[0], sv[1], sv[2], sv[3]);
    }
    cp_wait<0>();
    __syncthreads();
    if (c + 1 < chunks) load_b(c + 1);
    const float* bb = bt + (c & 1) * BBUF;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* ar = hb + ((warp + dy) * HC + dx + g) * FHS + t4;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        split(ar[8 * ks], ah[ks][0], al[ks][0]);
        split(ar[8 * FHS + 8 * ks], ah[ks][1], al[ks][1]);
        split(ar[8 * ks + 4], ah[ks][2], al[ks][2]);
        split(ar[8 * FHS + 8 * ks + 4], ah[ks][3], al[ks][3]);
      }
      const float* br = bb + tap * FKC * BS + t4 * BS + g;
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += NB) {
        float tt[NB][4];
        float bv[NB][2];
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          bv[n][0] = br[8 * (n0 + n)];
          bv[n][1] = br[4 * BS + 8 * (n0 + n)];
        }
        mma3<NB, true>(tt, ah[0], al[0], bv);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          bv[n][0] = br[8 * BS + 8 * (n0 + n)];
          bv[n][1] = br[12 * BS + 8 * (n0 + n)];
        }
        mma3<NB, false>(tt, ah[1], al[1], bv);
        flush<NB>(d + n0, tt);
      }
    }
  }

  const int y = y0 + warp;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int x = x0 + g + 8 * hf, o = 8 * n + 2 * t4;
      if (y < a.H && x < a.W && o < a.O) {
        const float2 v = make_float2(fmaxf(d[n][2 * hf] + a.bias[o], 0.f),
                                     fmaxf(d[n][2 * hf + 1] + a.bias[o + 1], 0.f));
        *reinterpret_cast<float2*>(a.out + (((size_t)b * a.H + y) * a.W + x) * a.O + o) = v;
      }
    }
}

// the wgmma width for O: O rounded up to the widths the kernels take
int pad_o(int O) {
  const int widths[5] = {32, 48, 64, 96, 128};
  for (int w : widths)
    if (O <= w) return w;
  return 0;
}

template <typename T>
bool fill_args(ConvArgs<T>& a, const void* const* xs, const int* hs, const int* ws, const int* idx,
               const float* wts, const float* bias, void* out, int n, int H, int W, int C, int O,
               int np) {
  if (n < 1 || n > MAX_IN || H < 1 || W < 1 || C < 16 || C % 16 != 0 || O < 16 || O % 16 != 0 ||
      O > 128 || np != pad_o(O))
    return false;
  for (int i = 0; i < MAX_IN; ++i) {
    a.x[i] = static_cast<const T*>(xs[i]);
    a.h[i] = hs[i];
    a.w[i] = ws[i];
  }
  a.idx = idx;
  a.wts = wts;
  a.bias = bias;
  a.out = static_cast<T*>(out);
  a.n = n;
  a.H = H;
  a.W = W;
  a.C = C;
  a.O = O;
  return true;
}

template <int NP>
int launch_bf16(const CUtensorMap& tk, const ConvArgs<bf16>& a, int B, cudaStream_t s) {
  const int smem = conv_smem(NP);
  cudaError_t e = cudaFuncSetAttribute(resize_conv_kernel<NP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, B);
  resize_conv_kernel<NP><<<grid, THREADS, smem, s>>>(tk, a);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_f32(const float* kern, const ConvArgs<float>& a, int B, cudaStream_t s) {
  const int smem = conv_f32_smem(NP);
  cudaError_t e = cudaFuncSetAttribute(resize_conv_f32_kernel<NP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.W + TW - 1) / TW, (a.H + TH - 1) / TH, B);
  resize_conv_f32_kernel<NP><<<grid, FTHREADS, smem, s>>>(kern, a);
  return (int)cudaGetLastError();
}

}  // namespace

// kern: the folded kernel transposed to (9 O, C) bf16 (tap-major rows of
// output channels); np: O rounded up to a wgmma width (`conv_plan`)
extern "C" int dsal_resize_conv_relu(const void* x0, const void* x1, const void* x2,
                                     const void* x3, const int* idx, const float* wts,
                                     const void* kern, const float* bias, void* out, int h0,
                                     int h1, int h2, int h3, int w0, int w1, int w2, int w3,
                                     int n, int B, int H, int W, int C, int O, int np,
                                     void* stream) {
  const void* xs[MAX_IN] = {x0, x1, x2, x3};
  const int hs[MAX_IN] = {h0, h1, h2, h3}, ws[MAX_IN] = {w0, w1, w2, w3};
  ConvArgs<bf16> a;
  if (B < 1 || !fill_args(a, xs, hs, ws, idx, wts, bias, out, n, H, W, C, O, np))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk;
  if (!make_map(&tk, kern, 1, 9 * O, C, np)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (np) {
    case 32: return launch_bf16<32>(tk, a, B, s);
    case 48: return launch_bf16<48>(tk, a, B, s);
    case 64: return launch_bf16<64>(tk, a, B, s);
    case 96: return launch_bf16<96>(tk, a, B, s);
    default: return launch_bf16<128>(tk, a, B, s);
  }
}

// kern: the folded kernel (3, 3, C, O) f32
extern "C" int dsal_resize_conv_relu_f32(const void* x0, const void* x1, const void* x2,
                                         const void* x3, const int* idx, const float* wts,
                                         const void* kern, const float* bias, void* out, int h0,
                                         int h1, int h2, int h3, int w0, int w1, int w2, int w3,
                                         int n, int B, int H, int W, int C, int O, int np,
                                         void* stream) {
  const void* xs[MAX_IN] = {x0, x1, x2, x3};
  const int hs[MAX_IN] = {h0, h1, h2, h3}, ws[MAX_IN] = {w0, w1, w2, w3};
  ConvArgs<float> a;
  if (B < 1 || !fill_args(a, xs, hs, ws, idx, wts, bias, out, n, H, W, C, O, np))
    return (int)cudaErrorInvalidValue;
  const float* k = static_cast<const float*>(kern);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (np) {
    case 32: return launch_f32<32>(k, a, B, s);
    case 48: return launch_f32<48>(k, a, B, s);
    case 64: return launch_f32<64>(k, a, B, s);
    case 96: return launch_f32<96>(k, a, B, s);
    default: return launch_f32<128>(k, a, B, s);
  }
}
