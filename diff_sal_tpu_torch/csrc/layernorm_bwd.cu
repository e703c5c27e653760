// K6: backward of K2 (row LayerNorm over the last axis, f32 statistics),
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel diff_sal_tpu/ops/layernorm.py:283 _ln_bwd (body
// _ln_bwd_kernel :233). Per row, with the statistics recomputed in f32 and
// mask = channel < c_real:
//   u = x - mean, r = rsqrt(var + eps), y = u * r * mask, dy = g * w * mask,
//   dvar = -0.5 r^3 sum(dy * u), dmean = -r sum(dy) - 2 mean dvar,
//   dx = dy r + (2 / c_real) x dvar + dmean / c_real   (written in x's dtype)
// and, over all rows, d_weight = sum g * y and d_bias = sum g in f32.
//
// Bound by bytes on the H100: read x and g, write dx, against ~20 flops per
// element. K2's design (csrc/layernorm.cu), extended to two inputs:
// - Persistent CTAs (at most two per SM) walk tiles of `tile_rows`
//   consecutive rows. Thread 0 bulk-copies (cp.async.bulk) each tile of x
//   and of g, two contiguous byte ranges, into one slot of a 1-4 deep ring;
//   one mbarrier per slot counts both copies' bytes.
// - A row's 16-byte vectors go to a power-of-two group of lanes, VPL
//   vectors per lane (a template parameter). Three passes over the tile in
//   shared memory: the row sums of x, then sum(dy) and sum(dy u) with the
//   mean known (the plain version's rounding points), then dx, written as
//   16-byte stores straight from registers. Each lane keeps the same
//   channels for every row it visits, so w and its running sums of g y and
//   g stay in its registers for the whole CTA.
// - The parameter gradients without atomics, in a fixed order: the groups'
//   sums meet by xor-shuffles inside each warp, then the eight warps' rows
//   in shared memory, into one (2C,) partial row per CTA [d_weight |
//   d_bias]. `layernorm_bwd_reduce_kernel` then adds the CTAs' rows: a CTA
//   per 32 columns, its eight warps each summing a fixed eighth of the rows
//   (every load issued before the first add: one trip to L2), the eight
//   sums added in warp order. Two runs give the same bits. (An in-launch
//   reduction, the last CTA to take an integer ticket adding the rows in
//   two levels, cost ~10-15 us of fences and dependent L2 trips per call on
//   the H100; a second launch costs ~2.)
// - A call of 1-2 rows (MViT's cls rows) is one tile on one CTA, which
//   writes d_weight and d_bias itself.
// The plan (tile rows, stages, grid) comes from `ln_bwd_plan` in
// ops/layernorm.py, which mirrors the checks below.
//
// Rows whose byte length is not a multiple of 16, or an x, g or dx that is
// not 16-byte aligned, cannot be bulk-copied or vector-accessed: they take
// `layernorm_bwd_rows_kernel` (one warp per row, lane-strided loads, the same
// partial rows and reduction) from the same entry, still one K6 launch. The
// plan then carries tile_rows = 0.

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_VALUES = 32;  // values per lane: C <= 32 * 32 = 1024
constexpr int MAX_C = 1024;
constexpr int MAX_STAGES = 4;
constexpr int MAX_GRID = 132 * 2;
constexpr int RED_ROWS = (MAX_GRID + WARPS - 1) / WARPS;  // partial rows per warp of the reduction
constexpr int SMEM_MAX = 232448;
constexpr int ROWS_PER_CTA = 8;  // row kernel: one warp per row

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// 16 bytes as N floats and back
template <typename T> struct V16;
template <> struct V16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct V16<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                      pack_bf16(f[6], f[7]));
  }
};

// lanes per row for a row of nvec 16-byte vectors: the smallest power of two
// that leaves each lane at most MAX_VALUES values. Mirrored by `ln_bwd_plan`.
__host__ __device__ inline int ln_group(int nvec, int per_vec) {
  const int per_lane = MAX_VALUES / per_vec;
  int g = 1;
  while (g * per_lane < nvec) g *= 2;
  return g;
}

// The warps' sums (WARPS x 2C floats). Mirrored by `ln_bwd_plan`.
__host__ __device__ inline long long red_bytes(int C) { return 4LL * WARPS * 2 * C; }

// Shared memory of one CTA: the ring (x and g tiles per stage) or the
// warps' sums, whichever is larger, then one mbarrier per stage. Mirrored
// by `ln_bwd_plan`.
__host__ __device__ inline long long bwd_smem(int tile_rows, int row_bytes, int stages, int C) {
  const long long ring = 2LL * stages * tile_rows * row_bytes;
  return (ring > red_bytes(C) ? ring : red_bytes(C)) + 8LL * stages;
}

struct Args {
  const unsigned char* x;
  const unsigned char* g;
  const float* w;
  unsigned char* dx;
  float* part;  // (grid, 2C) f32: the CTAs' partial rows
  float* dwb;   // (2C,) f32: d_weight, then d_bias
  long long R;
  int C, c_real, tile_rows, stages, group;
  float eps;
};

// The CTA's sums (warp w's in red[w * 2C ...], written by the caller) into
// its partial row, or straight into d_weight and d_bias for a grid of one
__device__ __forceinline__ void cta_row(const Args& a, const float* red) {
  const int cols = 2 * a.C;
  __syncthreads();
  float* row = gridDim.x == 1 ? a.dwb : a.part + (size_t)blockIdx.x * cols;
  for (int col = threadIdx.x; col < cols; col += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * cols + col];
    row[col] = s;
  }
}

// dwb[col] = sum over the `rows` partial rows, in a fixed order: CTA
// blockIdx.x takes 32 columns; warp w sums rows [RED_ROWS w, + RED_ROWS),
// all loads issued first, in row order; the eight warps' sums are added in
// warp order
__global__ void __launch_bounds__(THREADS) layernorm_bwd_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ dwb, int rows, int cols) {
  __shared__ float sums[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * 32 + lane, r0 = warp * RED_ROWS;
  float v[RED_ROWS];
#pragma unroll
  for (int k = 0; k < RED_ROWS; ++k)
    v[k] = col < cols && r0 + k < rows ? part[(size_t)(r0 + k) * cols + col] : 0.f;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < RED_ROWS; ++k) s += v[k];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += sums[w][lane];
    dwb[col] = t;
  }
}

template <typename T, int VPL>
__global__ void __launch_bounds__(THREADS, 2) layernorm_bwd_kernel(const Args a) {
  using V = V16<T>;
  constexpr int N = V::N;
  extern __shared__ __align__(128) unsigned char smem[];
  const int row_bytes = a.C * (int)sizeof(T), nvec = row_bytes / 16;
  const int tile_bytes = a.tile_rows * row_bytes;
  const long long ring_bytes = 2LL * a.stages * tile_bytes, red = red_bytes(a.C);
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = ring + (uint32_t)(ring_bytes > red ? ring_bytes : red);
  const long long ntiles = (a.R + a.tile_rows - 1) / a.tile_rows;
  const int tid = threadIdx.x, G = a.group, lig = tid & (G - 1), grp = tid / G;
  const int groups = THREADS / G;  // rows of a tile in flight at once
  const float inv_c = 1.f / a.c_real;

  // tile `tile` of x and of g into ring slot `slot` (x, then g)
  auto issue = [&](long long tile, int slot) {
    const long long row0 = tile * a.tile_rows;
    const uint32_t bytes =
        (uint32_t)(a.R - row0 < a.tile_rows ? a.R - row0 : a.tile_rows) * row_bytes;
    const uint32_t dst = ring + slot * 2 * tile_bytes;
    mbar_expect_tx(bars + 8 * slot, 2 * bytes);
    bulk_load(dst, a.x + row0 * row_bytes, bytes, bars + 8 * slot);
    bulk_load(dst + tile_bytes, a.g + row0 * row_bytes, bytes, bars + 8 * slot);
  };
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(bars + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < a.stages; ++s) {
      const long long tile = blockIdx.x + (long long)s * gridDim.x;
      if (tile < ntiles) issue(tile, s);
    }

  // this lane's channels: vectors lig + G i, i < VPL; w * mask, and the
  // running sums of g y and g
  float w[VPL * N], dws[VPL * N], dbs[VPL * N];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = lig + G * i;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int c = j * N + e;
      w[i * N + e] = j < nvec && c < a.c_real ? a.w[c] : 0.f;
      dws[i * N + e] = 0.f;
      dbs[i * N + e] = 0.f;
    }
  }

  int k = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++k) {
    const int slot = k % a.stages;
    const long long row0 = tile * a.tile_rows;
    const int rows = (int)(a.R - row0 < a.tile_rows ? a.R - row0 : a.tile_rows);
    mbar_wait(bars + 8 * slot, (k / a.stages) & 1);
    const unsigned char* xs = smem + slot * 2 * tile_bytes;
    const unsigned char* gsm = xs + tile_bytes;
    // tile_rows is a multiple of `groups`: every lane of a warp runs the
    // same iterations, so the shuffles see full warps
    for (int r = grp; r < a.tile_rows; r += groups) {
      const bool live = r < rows;
      const unsigned char* xr = xs + r * row_bytes;
      const unsigned char* gr = gsm + r * row_bytes;
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int j = lig + G * i;
        if (live && j < nvec) {
          float v[N];
          V::unpack(*reinterpret_cast<const uint4*>(xr + j * 16), v);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            s += v[e];
            ss += v[e] * v[e];
          }
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      const float mean = s * inv_c;
      const float rs = rsqrtf(fmaxf(ss * inv_c - mean * mean, 0.f) + a.eps);
      float sdy = 0.f, sdyu = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int j = lig + G * i;
        if (live && j < nvec) {
          float v[N], gv[N];
          V::unpack(*reinterpret_cast<const uint4*>(xr + j * 16), v);
          V::unpack(*reinterpret_cast<const uint4*>(gr + j * 16), gv);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float dy = gv[e] * w[i * N + e];
            sdy += dy;
            sdyu += dy * (v[e] - mean);
          }
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
        sdy += __shfl_xor_sync(0xffffffffu, sdy, off);
        sdyu += __shfl_xor_sync(0xffffffffu, sdyu, off);
      }
      if (!live) continue;
      const float dvar = -0.5f * (rs * rs * rs) * sdyu;
      const float dmean = -rs * sdy - 2.f * mean * dvar;
      unsigned char* dst = a.dx + (row0 + r) * row_bytes;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int j = lig + G * i;
        if (j < nvec) {
          float v[N], gv[N], d[N];
          V::unpack(*reinterpret_cast<const uint4*>(xr + j * 16), v);
          V::unpack(*reinterpret_cast<const uint4*>(gr + j * 16), gv);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            d[e] = gv[e] * w[i * N + e] * rs + (2.f * inv_c) * v[e] * dvar + dmean * inv_c;
            const float y = j * N + e < a.c_real ? (v[e] - mean) * rs : 0.f;
            dws[i * N + e] += gv[e] * y;
            dbs[i * N + e] += gv[e];
          }
          *reinterpret_cast<uint4*>(dst + j * 16) = V::pack(d);
        }
      }
    }
    __syncthreads();  // every thread is done with this slot
    if (tid == 0) {
      const long long next = tile + (long long)a.stages * gridDim.x;
      if (next < ntiles) {
        fence_async_smem();
        issue(next, slot);
      }
    }
  }

  // the groups of a warp hold the same channels: add them by xor-shuffles
  // (a fixed tree), then lanes lig < G hold the warp's sums. The channels
  // are the inner loop: each level's 2 VPL N shuffles are independent and
  // overlap (with the levels inner, their dependent chains ran one after
  // another: ~2 us per call on the H100)
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < VPL * N; ++i) {
      dws[i] += __shfl_xor_sync(0xffffffffu, dws[i], off);
      dbs[i] += __shfl_xor_sync(0xffffffffu, dbs[i], off);
    }
  // every slot is consumed (the last tile's barrier above): the ring's
  // memory takes the warps' sums
  float* sums = reinterpret_cast<float*>(smem);
  const int warp = tid >> 5, lane = tid & 31, cols = 2 * a.C;
  if (lane < G) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int j = lig + G * i;
      if (j < nvec)
#pragma unroll
        for (int e = 0; e < N; ++e) {
          sums[warp * cols + j * N + e] = dws[i * N + e];
          sums[warp * cols + a.C + j * N + e] = dbs[i * N + e];
        }
    }
  }
  cta_row(a, sums);
}

// rows the bulk path cannot take: one warp per row (grid-stride), lane-
// strided scalar loads, the row's x and g in registers (N values per lane,
// C <= 32 N); the same per-lane sums and partial rows
template <typename T, int N>
__global__ void __launch_bounds__(32 * ROWS_PER_CTA) layernorm_bwd_rows_kernel(const Args a) {
  extern __shared__ float red[];  // red_bytes(C)
  const T* x = reinterpret_cast<const T*>(a.x);
  const T* g = reinterpret_cast<const T*>(a.g);
  T* dx = reinterpret_cast<T*>(a.dx);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, C = a.C;
  const float inv_c = 1.f / a.c_real;
  float wv[N], dws[N], dbs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = lane + 32 * i;
    wv[i] = c < C && c < a.c_real ? a.w[c] : 0.f;
    dws[i] = 0.f;
    dbs[i] = 0.f;
  }
  for (long long row = (long long)blockIdx.x * ROWS_PER_CTA + warp; row < a.R;
       row += (long long)gridDim.x * ROWS_PER_CTA) {
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
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float mean = s * inv_c;
    const float rs = rsqrtf(fmaxf(ss * inv_c - mean * mean, 0.f) + a.eps);
    float sdy = 0.f, sdyu = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float dy = gv[i] * wv[i];
      sdy += dy;
      sdyu += dy * (xv[i] - mean);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sdy += __shfl_xor_sync(0xffffffffu, sdy, off);
      sdyu += __shfl_xor_sync(0xffffffffu, sdyu, off);
    }
    const float dvar = -0.5f * (rs * rs * rs) * sdyu;
    const float dmean = -rs * sdy - 2.f * mean * dvar;
    T* dr = dx + row * C;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = lane + 32 * i;
      if (c >= C) continue;
      dr[c] = from_f<T>(gv[i] * wv[i] * rs + (2.f * inv_c) * xv[i] * dvar + dmean * inv_c);
      const float y = c < a.c_real ? (xv[i] - mean) * rs : 0.f;
      dws[i] += gv[i] * y;
      dbs[i] += gv[i];
    }
  }
  const int cols = 2 * C;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      red[warp * cols + c] = dws[i];
      red[warp * cols + C + c] = dbs[i];
    }
  }
  cta_row(a, red);
}

template <typename T, int N>
int launch_rows(const Args& a, int grid, cudaStream_t s) {
  const int smem = (int)red_bytes(a.C);
  cudaError_t err = cudaFuncSetAttribute(layernorm_bwd_rows_kernel<T, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  layernorm_bwd_rows_kernel<T, N><<<grid, 32 * ROWS_PER_CTA, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rows(const Args& a, int grid, cudaStream_t s) {
  const int n = (a.C + 31) / 32;
  if (n <= 4) return launch_rows<T, 4>(a, grid, s);
  if (n <= 8) return launch_rows<T, 8>(a, grid, s);
  if (n <= 16) return launch_rows<T, 16>(a, grid, s);
  if (n <= 24) return launch_rows<T, 24>(a, grid, s);
  return launch_rows<T, 32>(a, grid, s);
}

template <typename T, int VPL>
int launch(const Args& a, int grid, int smem, cudaStream_t s) {
  static int smem_set = 0;  // the attribute only grows; set it once per size
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(layernorm_bwd_kernel<T, VPL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  layernorm_bwd_kernel<T, VPL><<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vpl(int vpl, const Args& a, int grid, int smem, cudaStream_t s) {
  switch (vpl) {
    case 1: return launch<T, 1>(a, grid, smem, s);
    case 2: return launch<T, 2>(a, grid, smem, s);
    case 3: return launch<T, 3>(a, grid, smem, s);
    case 4: return launch<T, 4>(a, grid, smem, s);
  }
  if constexpr (sizeof(T) == 4) {  // f32: up to 8 vectors of 4 per lane
    switch (vpl) {
      case 5: return launch<T, 5>(a, grid, smem, s);
      case 6: return launch<T, 6>(a, grid, smem, s);
      case 7: return launch<T, 7>(a, grid, smem, s);
      case 8: return launch<T, 8>(a, grid, smem, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, g, dx (R, C) bf16 or f32 (is_bf16); w (C,) f32; dwb (2C,) f32 gets
// d_weight then d_bias; part (grid, 2C) f32 scratch, or null with grid 1.
// tile_rows, stages and grid from `ln_bwd_plan`: tile_rows = 0 for the row
// kernel, which the entry takes exactly when the bulk path cannot; any
// other plan that does not match this input is refused.
extern "C" int dsal_layernorm_bwd(const void* x, const void* g, const float* w, void* dx,
                                  float* part, float* dwb, int R, int C, int c_real, float eps,
                                  int is_bf16, int tile_rows, int stages, int grid,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int size = is_bf16 ? 2 : 4, row_bytes = C * size;
  if (R < 1 || C < 1 || C > MAX_C || c_real < 1 || c_real > C || grid < 1 || grid > MAX_GRID ||
      (grid > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool bulk = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  Args a;
  a.x = static_cast<const unsigned char*>(x);
  a.g = static_cast<const unsigned char*>(g);
  a.w = w;
  a.dx = static_cast<unsigned char*>(dx);
  a.part = part;
  a.dwb = dwb;
  a.R = R;
  a.C = C;
  a.c_real = c_real;
  a.tile_rows = tile_rows;
  a.stages = stages;
  a.eps = eps;
  int err;
  if (!bulk) {
    const long long blocks = ((long long)R + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
    if (tile_rows != 0 || grid > blocks) return (int)cudaErrorInvalidValue;
    a.group = 32;
    err = is_bf16 ? dispatch_rows<bf16>(a, grid, s) : dispatch_rows<float>(a, grid, s);
  } else {
    const int nvec = row_bytes / 16, per_vec = 16 / size;
    const int group = ln_group(nvec, per_vec), vpl = (nvec + group - 1) / group;
    const long long smem = bwd_smem(tile_rows, row_bytes, stages, C);
    const long long tiles = ((long long)R + tile_rows - 1) / (tile_rows > 0 ? tile_rows : 1);
    if (tile_rows <= 0 || tile_rows % (THREADS / group) != 0 || stages < 1 ||
        stages > MAX_STAGES || smem > SMEM_MAX || grid > tiles)
      return (int)cudaErrorInvalidValue;
    a.group = group;
    err = is_bf16 ? launch_vpl<bf16>(vpl, a, grid, (int)smem, s)
                  : launch_vpl<float>(vpl, a, grid, (int)smem, s);
  }
  if (err != 0 || grid == 1) return err;
  layernorm_bwd_reduce_kernel<<<(2 * C + 31) / 32, THREADS, 0, s>>>(part, dwb, grid, 2 * C);
  return (int)cudaGetLastError();
}
