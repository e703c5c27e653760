// K2: row LayerNorm over the last axis, f32 statistics, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel diff_sal_tpu/ops/layernorm.py:134 fused_layernorm
// (body _ln_kernel :39): mean and E[x^2] in f32, var = E[x^2] - mean^2
// clamped at 0, rsqrt(var + eps), then scale and bias, output in x's dtype
// (bf16 or f32); channels at or past c_real (a zero-padded axis) are
// written 0 and the statistics divide by c_real.
//
// Bound by bytes on the H100: one read and one write of every row against
// ~8 flops per element. What holds a row pass back on this card is too few
// bytes in flight per SM and too few bytes per instruction, so:
// - Persistent CTAs. The grid is min(row tiles, two CTAs per SM); CTA c
//   walks tiles c, c + grid, ... A tile is `tile_rows` consecutive rows, one
//   contiguous byte range.
// - Bulk loads. Thread 0 copies a whole tile with one cp.async.bulk into a
//   ring of `stages` (1-4) shared-memory buffers, each behind an mbarrier
//   that counts the tile's bytes, up to `stages` tiles ahead: tens of KB in
//   flight per SM against HBM's latency. A CTA barrier after each tile tells
//   thread 0 that its buffer may be refilled.
// - Compute from shared memory in 16-byte vectors (8 bf16 or 4 f32). A row's
//   C * size / 16 vectors go to a group of `group` lanes (a power of two, at
//   most a warp; 4 lanes of 3 vectors at C = 96 bf16, 32 of 3 at C = 768),
//   VPL vectors per lane (a template parameter: no predicated slots beyond
//   the row). The two sums reduce by xor-shuffles inside the group. Each lane
//   keeps the same channels for every row, so w and b sit in its registers,
//   loaded once per CTA.
// - Writes: 16-byte stores straight from registers.
// - The tail of R is masked inside the kernel; a call of 1-2 rows (MViT's
//   cls rows) is one tile on one CTA.
// The plan (tile rows, stages, grid) comes from `ln_plan` in
// ops/layernorm.py, which mirrors the checks below.
//
// Rows whose byte length is not a multiple of 16, or an input or output not
// 16-byte aligned, cannot be bulk-copied or vector-accessed: they take
// `layernorm_rows_kernel` (one warp per row, lane-strided scalar loads) from
// the same entry, still one K2 launch. The plan then carries tile_rows = 0.

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_VALUES = 32;   // values per lane: C <= 32 * 32 = 1024
constexpr int MAX_C = 1024;
constexpr int MAX_STAGES = 4;
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
// that leaves each lane at most MAX_VALUES values. Mirrored by `ln_plan`.
__host__ __device__ inline int ln_group(int nvec, int per_vec) {
  const int per_lane = MAX_VALUES / per_vec;
  int g = 1;
  while (g * per_lane < nvec) g *= 2;
  return g;
}

struct Args {
  const unsigned char* x;
  const float* w;
  const float* b;
  unsigned char* out;
  long long R;
  int C, c_real, tile_rows, stages, group;
  float eps;
};

template <typename T, int VPL>
__global__ void __launch_bounds__(THREADS, 2) layernorm_kernel(const Args a) {
  using V = V16<T>;
  constexpr int N = V::N;
  extern __shared__ __align__(128) unsigned char smem[];
  const int row_bytes = a.C * (int)sizeof(T), nvec = row_bytes / 16;
  const int tile_bytes = a.tile_rows * row_bytes;
  const uint32_t ring = smem_u32(smem), bars = ring + a.stages * tile_bytes;
  const long long ntiles = (a.R + a.tile_rows - 1) / a.tile_rows;
  const int tid = threadIdx.x, G = a.group, lig = tid & (G - 1), grp = tid / G;
  const int groups = THREADS / G;  // rows of a tile in flight at once

  // tile `tile` into ring buffer `slot`: its rows are one byte range
  auto issue = [&](long long tile, int slot) {
    const long long row0 = tile * a.tile_rows;
    const uint32_t bytes =
        (uint32_t)(a.R - row0 < a.tile_rows ? a.R - row0 : a.tile_rows) * row_bytes;
    mbar_expect_tx(bars + 8 * slot, bytes);
    bulk_load(ring + slot * tile_bytes, a.x + row0 * row_bytes, bytes, bars + 8 * slot);
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

  // this lane's channels: vectors lig + G i, i < VPL
  float w[VPL * N], bb[VPL * N];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = lig + G * i;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int c = j * N + e;
      w[i * N + e] = j < nvec ? a.w[c] : 0.f;
      bb[i * N + e] = j < nvec ? a.b[c] : 0.f;
    }
  }

  int k = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++k) {
    const int slot = k % a.stages;
    const long long row0 = tile * a.tile_rows;
    const int rows = (int)(a.R - row0 < a.tile_rows ? a.R - row0 : a.tile_rows);
    mbar_wait(bars + 8 * slot, (k / a.stages) & 1);
    const unsigned char* src = smem + slot * tile_bytes;
    // tile_rows is a multiple of `groups`: every lane of a warp runs the
    // same iterations, so the shuffles see full warps
    for (int r = grp; r < a.tile_rows; r += groups) {
      const bool live = r < rows;
      float v[VPL * N];
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int j = lig + G * i;
        if (live && j < nvec) {
          V::unpack(*reinterpret_cast<const uint4*>(src + r * row_bytes + j * 16), v + i * N);
        } else {
#pragma unroll
          for (int e = 0; e < N; ++e) v[i * N + e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < N; ++e) {
          s += v[i * N + e];
          ss += v[i * N + e] * v[i * N + e];
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      const float mean = s / a.c_real;
      const float rs = rsqrtf(fmaxf(ss / a.c_real - mean * mean, 0.f) + a.eps);
      if (!live) continue;
      unsigned char* dst = a.out + (row0 + r) * row_bytes;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int j = lig + G * i;
        if (j < nvec) {
          float y[N];
#pragma unroll
          for (int e = 0; e < N; ++e)
            y[e] = j * N + e < a.c_real ? (v[i * N + e] - mean) * rs * w[i * N + e] + bb[i * N + e]
                                        : 0.f;
          *reinterpret_cast<uint4*>(dst + j * 16) = V::pack(y);
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer
    if (tid == 0) {
      const long long next = tile + (long long)a.stages * gridDim.x;
      if (next < ntiles) {
        fence_async_smem();
        issue(next, slot);
      }
    }
  }
}

// rows the bulk path cannot take: one warp per row, lane-strided scalar
// loads, the row in registers
template <typename T>
__global__ void layernorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                      const float* __restrict__ b, T* __restrict__ out,
                                      long long R, int C, int c_real, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS_PER_CTA + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* xr = x + row * C;
  T* orow = out + row * C;
  float v[MAX_VALUES];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_VALUES; ++i) {
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
  const float r = rsqrtf(fmaxf(ss / c_real - mean * mean, 0.f) + eps);
#pragma unroll
  for (int i = 0; i < MAX_VALUES; ++i) {
    const int c = lane + 32 * i;
    if (c < C) orow[c] = from_f<T>(c < c_real ? (v[i] - mean) * r * w[c] + b[c] : 0.f);
  }
}

template <typename T, int VPL>
int launch(const Args& a, int grid, int smem, cudaStream_t s) {
  static int smem_set = 0;  // the attribute only grows; set it once per size
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(layernorm_kernel<T, VPL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  layernorm_kernel<T, VPL><<<grid, THREADS, smem, s>>>(a);
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

// x, out (R, C) bf16 or f32 (is_bf16); w, b (C,) f32. tile_rows, stages and
// grid from `ln_plan`: tile_rows = 0 for the row kernel, which the entry
// takes exactly when the bulk path cannot; any other plan that does not
// match this input is refused.
extern "C" int dsal_layernorm(const void* x, const float* w, const float* b, void* out, int R,
                              int C, int c_real, float eps, int is_bf16, int tile_rows,
                              int stages, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int size = is_bf16 ? 2 : 4, row_bytes = C * size;
  if (R < 1 || C < 1 || C > MAX_C || c_real < 1 || c_real > C) return (int)cudaErrorInvalidValue;
  const bool bulk = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!bulk) {
    if (tile_rows != 0) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((R + ROWS_PER_CTA - 1) / ROWS_PER_CTA);
    if (is_bf16)
      layernorm_rows_kernel<bf16><<<blocks, 32 * ROWS_PER_CTA, 0, s>>>(
          static_cast<const bf16*>(x), w, b, static_cast<bf16*>(out), R, C, c_real, eps);
    else
      layernorm_rows_kernel<float><<<blocks, 32 * ROWS_PER_CTA, 0, s>>>(
          static_cast<const float*>(x), w, b, static_cast<float*>(out), R, C, c_real, eps);
    return (int)cudaGetLastError();
  }
  const int nvec = row_bytes / 16, per_vec = 16 / size;
  const int group = ln_group(nvec, per_vec), vpl = (nvec + group - 1) / group;
  const long long smem = (long long)stages * tile_rows * row_bytes + 8 * stages;
  const long long tiles = ((long long)R + tile_rows - 1) / (tile_rows > 0 ? tile_rows : 1);
  if (tile_rows <= 0 || tile_rows % (THREADS / group) != 0 || stages < 1 ||
      stages > MAX_STAGES || smem > SMEM_MAX || grid < 1 || grid > tiles)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const unsigned char*>(x);
  a.w = w;
  a.b = b;
  a.out = static_cast<unsigned char*>(out);
  a.R = R;
  a.C = C;
  a.c_real = c_real;
  a.tile_rows = tile_rows;
  a.stages = stages;
  a.group = group;
  a.eps = eps;
  return is_bf16 ? launch_vpl<bf16>(vpl, a, grid, (int)smem, s)
                 : launch_vpl<float>(vpl, a, grid, (int)smem, s);
}
