// K3: fused transformer-block tail, written for Hopper (sm_90a),
//   y = skip + attn;  out = y + fc2(gelu(fc1(LayerNorm(y))))
//
// Replaces the TPU kernel diff_sal_tpu/ops/mlp.py:132 fused_block_tail (body
// _tail_kernel :47). Rounding as the TPU kernel: y and LN(y) in f32, LN(y)
// rounded to bf16 for fc1, h = LN(y) w1^T + b1 and GELU (tanh or exact) in
// f32, rounded to bf16 for fc2, f32 accumulation, out = bf16(y + (h w2^T +
// b2)). The (R, Hd) hidden activation never reaches device memory.
//
// Bound by operations at the decoder's widths (8 R C^2 flops with Hd = 2C
// against three (R, C) row passes; the bytes bound only at C = 96). What
// held the old WMMA kernel back: weight fragments read from L2 by every warp
// for every 16x16 block, 32-row CTAs (about 42 of them at C = 768 for 132
// SMs) each walking all 24 hidden chunks. The design:
// - A CTA owns BM = 64 rows. Its threads compute y and LN(y) in f32 and
//   store LN(y) as bf16 in shared memory, K-major without swizzle (8x8 core
//   matrices): the A operand of the first product.
// - Every product is a wgmma (bf16 in, f32 accumulated in registers):
//   h = LN(y) w1[chunk]^T, m64n64k16 with A and B from shared memory, over
//   hidden chunks of 64; then h + b1 and GELU in registers, rounded to bf16
//   straight into the A fragments of out += GELU(h) w2[cols, chunk]^T
//   (m64n64k16, A from registers).
// - Weights by TMA. w1 and w2 are read as 64x64 tiles (two 32-column boxes,
//   64-byte swizzle, the layout the wgmma descriptors name) into a ring of
//   8 KB buffers behind mbarriers; thread 0 of each consumer warpgroup keeps
//   its part of the ring full (one or two hidden chunks ahead), so loads are
//   in flight while the tensor cores work. One product group stays in
//   flight while the next tile's group is issued.
// - The accumulator does not fit: 64 rows x 768 columns of f32 are 384
//   registers a thread. A CTA owns NT <= 4 output tiles of 64 columns (at
//   most 128 accumulator registers a thread); `col_splits` CTAs cover C and
//   each recomputes h for its rows (C = 768: three splits).
// - One warpgroup issuing one chain of m64n64k16 products reached about a
//   quarter of the tensor-core peak on the H100, and where the CTAs are about
//   one per SM that chain was the kernel's time. There NW = 2 consumer
//   warpgroups share the CTA's rows and LN(y) and split its hidden chunks,
//   each with its own half of the ring; their partial sums meet in shared
//   memory before the epilogue. Where CTAs are
//   many (C <= 192 at the decoder's rows), one warpgroup and a 4-buffer ring
//   let several CTAs share an SM instead.
// - Filling the card at small R: where the row tiles and column splits leave
//   more than half of the SMs idle (C = 768: R = 840-1344 gives 42-63 CTAs),
//   `k_splits` CTAs share the hidden axis. Each writes its f32 partial sum to
//   a workspace and a second kernel adds the splits in a fixed order with y
//   and b2: no atomics, so two runs give the same bits.
// - The epilogue stages the f32 sums in the shared memory of LN(y) and the
//   ring, then every thread reads y and writes the output as 16-byte
//   vectors along rows.
// `tail_plan` in ops/mlp.py chooses nt, the splits, the warpgroups and the
// stages and mirrors the shared memory (`tail_smem`); the entry refuses a
// plan that does not fit. C must be a multiple of 32 (a w1 tile of one or
// two boxes), Hd of 64. Rows past R are zero and are not written.
//
// The f32 instance (`dsal_block_tail_f32`, the tail of an f32 model, which
// the JAX K3 takes as well) keeps f32's accuracy with every product in split
// TF32 on the tensor cores (mma.sync m16n8k8, the helpers of csrc/tf32.cuh:
// each operand as a TF32 hi + lo pair, three TF32 products, f32 sums
// flushed every FLUSH k-steps), 2.5x FFMA's peak on the H100. The same
// flash-MLP: a CTA of eight warps owns FR = 32 rows and computes y and
// LN(y) in f32 into shared memory (row stride C + 8: the float2 fragment
// reads of a half-warp hit 16 different 8-byte banks); per hidden chunk of
// hc = 64 or 128 units, h = LN(y) w1[chunk]^T (each warp 16 rows x hc / 4
// hidden units), h + b1 and GELU in f32 into shared memory, then out +=
// GELU(h) w2[cols, chunk]^T (each warp 16 rows x 8 NT output columns, its
// f32 sums in registers across chunks). w1 and w2 arrive as tiles of 32
// input or 16 hidden columns by cp.async into a double buffer. A CTA owns
// at most F_MAX_NC = 384 output columns (C = 768: two column splits, each
// recomputing h); where row tiles and column splits leave more than half
// of the CTA slots idle, CTAs split the hidden axis into an f32 workspace
// that `tail_f32_reduce_kernel` adds in split order.
// `tail_f32_plan` in ops/mlp.py chooses nt, hc, the splits and mirrors the
// shared memory (`tail_f32_smem`, 190 KB at C = 768).

#include "tf32.cuh"

namespace {

constexpr int HC = 64;     // hidden units per chunk (both instances)
constexpr int MAXC = 768;

__device__ __forceinline__ float gelu(float h, int mode) {
  if (mode == 0) {
    const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * h * (1.f + tanhf(k0 * (h + 0.044715f * h * h * h)));
  }
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

// ------------------------------------------------------------ bf16 (K3) ---

constexpr int BM = 64;           // rows per CTA: one warpgroup, one wgmma M
constexpr int BOX = 64 * 64;     // one TMA box: 64 rows x 32 bf16 columns (bytes)
constexpr int TILE = 2 * BOX;    // one ring buffer: a 64 x 64 weight tile
constexpr int MAX_NT = 4;        // 64-column output tiles per CTA
constexpr int MAX_STAGES = 8;
constexpr int MAX_KSPLIT = 8;
constexpr int SMEM_MAX = 232448;

// LN(y) (BM x C bf16), the ring, its mbarriers and 1024 bytes to align the
// base. Mirrored by `tail_smem` in ops/mlp.py.
__host__ __device__ inline int tail_smem(int C, int stages) {
  return BM * C * 2 + stages * (TILE + 8) + 1024;
}

struct TailArgs {
  const bf16* skip;
  const bf16* attn;
  const float* ln_w;
  const float* ln_b;
  const float* b1;
  const float* b2;
  bf16* out;
  float* ws;  // (k_splits, R, C) f32 partial sums, or null with one split
  int R, C, chunks, stages;  // chunks: hidden chunks of one split
  float eps;
  int act;
};

// y = skip + attn at 8 channels from element `off`, in f32
__device__ __forceinline__ void load_y(const TailArgs& a, size_t off, float (&y)[8]) {
  const uint4 s = *reinterpret_cast<const uint4*>(a.skip + off);
  const uint4 t = *reinterpret_cast<const uint4*>(a.attn + off);
  const __nv_bfloat162* sp = reinterpret_cast<const __nv_bfloat162*>(&s);
  const __nv_bfloat162* tp = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(sp[i]), v = __bfloat1622float2(tp[i]);
    y[2 * i] = u.x + v.x;
    y[2 * i + 1] = u.y + v.y;
  }
}

// The CTA (blockIdx.x, y, z) owns rows 64 x, output columns [64 NT y, +64 NT)
// and hidden chunks [chunks z, +chunks), shared by its NW consumer
// warpgroups: warpgroup w takes the chunks [half w, half (w + 1)) and ring
// buffers [S w, S (w + 1)) (S = stages / NW), its thread 0 issues its
// loads. A warpgroup's tiles, in the order it consumes them, per hidden
// chunk: the C / (32 KB) w1 tiles (hidden x input columns), then the NT w2
// tiles (output columns x hidden). With two warpgroups the second adds its
// partial sums to the first's through shared memory before the epilogue.
template <int NT, int KB, int NW>
__global__ void __launch_bounds__(NW * 128, 1)
    block_tail_kernel(const __grid_constant__ CUtensorMap tw1,
                      const __grid_constant__ CUtensorMap tw2, const TailArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t xn = smem_u32(smem), ring0 = xn + BM * a.C * 2, bars0 = ring0 + a.stages * TILE;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * NT * 64, hbase = blockIdx.z * a.chunks * HC;
  const int kt1 = a.C / (32 * KB), per_chunk = kt1 + NT;
  const int half = (a.chunks + NW - 1) / NW, c0 = wg * half;
  const int nch = max(0, min(half, a.chunks - c0));  // this warpgroup's chunks
  const int S = a.stages / NW, total = nch * per_chunk;
  const uint32_t ring = ring0 + wg * S * TILE, bars = bars0 + 8 * wg * S;

  // tile q of this warpgroup into its ring buffer q % S
  auto issue = [&](int q) {
    const int slot = q % S, c = q / per_chunk, i = q - c * per_chunk;
    const uint32_t dst = ring + slot * TILE, bar = bars + 8 * slot;
    const int h0 = hbase + (c0 + c) * HC;
    if (i < kt1) {
      mbar_expect_tx(bar, KB * BOX);
      for (int x = 0; x < KB; ++x) tma_load(dst + x * BOX, &tw1, bar, (i * KB + x) * 32, h0, 0);
    } else {
      mbar_expect_tx(bar, TILE);
      for (int x = 0; x < 2; ++x) tma_load(dst + x * BOX, &tw2, bar, h0 + 32 * x, n0 + (i - kt1) * 64, 0);
    }
  };
  // the product reading tile q is complete in every thread of the
  // warpgroup: its thread 0 refills the buffer with tile q + S
  auto release = [&](int q) {
    named_sync(1 + wg, 128);
    if (t == 0 && q + S < total) issue(q + S);
  };
  auto wait_tile = [&](int q) { mbar_wait(bars + 8 * (q % S), (q / S) & 1); };

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(bars0 + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (t == 0)
    for (int q = 0; q < S && q < total; ++q) issue(q);

  // y and LN(y) of the CTA's rows (zeros past R) while the first tiles
  // load. A warp takes 8 rows at a time, four lanes per row, 8 channels a
  // lane per step: the sums in one pass, the normalised row in a second
  // (from L1). LN(y) element (r, k) lands at (k / 16) 2048 + (r / 8) 256 +
  // (k / 8 % 2) 128 + (r % 8) 16 + (k % 8) 2: the eight lanes of a store
  // phase write eight rows of one core matrix, no bank conflicts.
  const int nv = a.C / 8;
  for (int pass = 0; pass < 2 / NW; ++pass) {
    const int r = (tid >> 5) * (16 / NW) + pass * 8 + (lane & 7), row = row0 + r;
    const bool live = row < a.R;
    const size_t base = (size_t)(live ? row : 0) * a.C;
    float s = 0.f, ss = 0.f;
    if (live)
      for (int j = lane >> 3; j < nv; j += 4) {
        float y[8];
        load_y(a, base + 8 * j, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += y[e];
          ss += y[e] * y[e];
        }
      }
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    ss += __shfl_xor_sync(0xffffffffu, ss, 8);
    ss += __shfl_xor_sync(0xffffffffu, ss, 16);
    const float mean = s / a.C;
    const float rs = rsqrtf(fmaxf(ss / a.C - mean * mean, 0.f) + a.eps);
    for (int j = lane >> 3; j < nv; j += 4) {
      float y[8];
      if (live) {
        load_y(a, base + 8 * j, y);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          y[e] = (y[e] - mean) * rs * a.ln_w[8 * j + e] + a.ln_b[8 * j + e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = 0.f;
      }
      const int k = 8 * j;
      *reinterpret_cast<uint4*>(smem + (k >> 4) * 2048 + (r >> 3) * 256 + ((k >> 3) & 1) * 128 +
                                (r & 7) * 16) =
          make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                     pack_bf16(y[6], y[7]));
    }
  }
  fence_async_smem();
  __syncthreads();

  float acc[NT][32];
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
  const int r0 = warp * 16 + (lane >> 2), cb = 2 * (lane & 3);  // rows r0, r0 + 8
  float h[32];
  uint32_t pa[4][4];
  int q = 0;
  for (int c = 0; c < nch; ++c) {
    // h = LN(y) w1[chunk]^T: one group per w1 tile, the previous one waited
    // for (and its buffer released) once the next is issued
    auto issue_h = [&](int i) {
      const uint32_t wt = ring + (q % S) * TILE;
      reg_fence(h);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 2 * KB; ++kk) {
        const int k = i * 32 * KB + 16 * kk;
        wgmma_ss<64>(h, plain_desc(xn + (k >> 4) * 2048, 128, 256),
                     sw64_desc(wt + (kk >> 1) * BOX + (kk & 1) * 32, 16, 512), i > 0 || kk > 0);
      }
      wg_commit();
    };
    wait_tile(q);
    issue_h(0);
    for (int i = 1; i < kt1; ++i) {
      ++q;
      wait_tile(q);
      issue_h(i);
      wg_wait<1>();
      release(q - 1);
    }
    wg_wait<0>();
    reg_fence(h);
    release(q);
    ++q;

    // h + b1 and GELU in f32, rounded to bf16 as the A fragments of the
    // second product (k-step kk: hidden columns 16 kk .. 16 kk + 15)
    const int h0 = hbase + (c0 + c) * HC;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b0 = a.b1[h0 + 8 * j + cb], b1 = a.b1[h0 + 8 * j + cb + 1];
      pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(gelu(h[4 * j] + b0, a.act), gelu(h[4 * j + 1] + b1, a.act));
      pa[j >> 1][(j & 1) * 2 + 1] =
          pack_bf16(gelu(h[4 * j + 2] + b0, a.act), gelu(h[4 * j + 3] + b1, a.act));
    }

    // out[:, tile u] += GELU(h) w2[tile u, chunk]^T, w2 K-major
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      if (u > 0) ++q;
      wait_tile(q);
      const uint32_t wt = ring + (q % S) * TILE;
      reg_fence(acc[u]);
      reg_fence(pa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wg<64>::template rs<0>(acc[u], pa[kk], sw64_desc(wt + (kk >> 1) * BOX + (kk & 1) * 32, 16, 512));
      wg_commit();
      if (u > 0) {
        wg_wait<1>();
        release(q - 1);
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int u = 0; u < NT; ++u) reg_fence(acc[u]);
    release(q);
    ++q;
  }

  // epilogue: the sums (both warpgroups' partial sums added) staged as f32
  // [64 rows][64 NT columns] in the shared memory of LN(y) and the ring
  // (every load is consumed by now), each row's 8-column groups rotated by
  // its row (no bank conflicts), then every thread writes 16-byte vectors:
  // out = bf16(y + (sum + b2)), or the f32 partial sum of this hidden split
  float* red = reinterpret_cast<float*>(smem);
  auto stage = [&](bool add) {
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + 8 * hf, col = u * 64 + ((8 * j) ^ ((r & 7) << 3)) + cb;
          float2* d = reinterpret_cast<float2*>(red + r * NT * 64 + col);
          float2 v = make_float2(acc[u][4 * j + 2 * hf], acc[u][4 * j + 2 * hf + 1]);
          if (add) {
            v.x += d->x;
            v.y += d->y;
          }
          *d = v;
        }
  };
  __syncthreads();
  if (wg == NW - 1) stage(false);
  if constexpr (NW == 2) {
    __syncthreads();
    if (wg == 0) stage(true);
  }
  __syncthreads();
  const int groups = NT * 8;  // 8-column groups of a row
  for (int e = tid; e < BM * groups; e += NW * 128) {
    const int r = e / groups, gc = e - r * groups, row = row0 + r, col = n0 + 8 * gc;
    if (row >= a.R || col >= a.C) continue;
    const float* src = red + r * NT * 64 + (((gc & 7) ^ (r & 7)) | (gc & ~7)) * 8;
    const float4 lo = *reinterpret_cast<const float4*>(src);
    const float4 hi = *reinterpret_cast<const float4*>(src + 4);
    float o[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const size_t off = (size_t)row * a.C + col;
    if (a.ws != nullptr) {
      float4* w = reinterpret_cast<float4*>(a.ws + (size_t)blockIdx.z * a.R * a.C + off);
      w[0] = lo;
      w[1] = hi;
    } else {
      float y[8];
      load_y(a, off, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = y[i] + (o[i] + a.b2[col + i]);
      *reinterpret_cast<uint4*>(a.out + off) =
          make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]),
                     pack_bf16(o[6], o[7]));
    }
  }
}

// out = bf16(y + (sum of the splits' partial sums, in split order, + b2))
__global__ void tail_reduce_kernel(const TailArgs a, int splits) {
  const size_t n = (size_t)a.R * a.C / 2, plane = (size_t)a.R * a.C;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t off = 2 * i;
    const int col = (int)(off % a.C);
    float o0 = 0.f, o1 = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float2 p = *reinterpret_cast<const float2*>(a.ws + s * plane + off);
      o0 += p.x;
      o1 += p.y;
    }
    const float2 s = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.skip + off));
    const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.attn + off));
    *reinterpret_cast<uint32_t*>(a.out + off) =
        pack_bf16((s.x + u.x) + (o0 + a.b2[col]), (s.y + u.y) + (o1 + a.b2[col + 1]));
  }
}

template <int NT, int KB, int NW>
int launch_tail(const CUtensorMap& t1, const CUtensorMap& t2, const TailArgs& a, dim3 grid,
                int smem, cudaStream_t s) {
  static int smem_set = 0;  // the attribute only grows; set it once per size
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(block_tail_kernel<NT, KB, NW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  block_tail_kernel<NT, KB, NW><<<grid, NW * 128, smem, s>>>(t1, t2, a);
  return (int)cudaGetLastError();
}

template <int KB, int NW>
int launch_nt(int nt, const CUtensorMap& t1, const CUtensorMap& t2, const TailArgs& a, dim3 grid,
              int smem, cudaStream_t s) {
  switch (nt) {
    case 1: return launch_tail<1, KB, NW>(t1, t2, a, grid, smem, s);
    case 2: return launch_tail<2, KB, NW>(t1, t2, a, grid, smem, s);
    case 3: return launch_tail<3, KB, NW>(t1, t2, a, grid, smem, s);
    default: return launch_tail<4, KB, NW>(t1, t2, a, grid, smem, s);
  }
}

// ------------------------------------------------------------- f32 (K3) ---

constexpr int FR = 32;          // rows per CTA (two 16-row m-tiles)
constexpr int FW = 8;           // warps per CTA
constexpr int FTH = FW * 32;
constexpr int FK1 = 32;         // input columns of one w1 tile
constexpr int FK2 = 16;         // hidden columns of one w2 tile
constexpr int FLD1 = FK1 + 8;   // their row strides in floats (float2 fragment
constexpr int FLD2 = FK2 + 8;   // reads of a half-warp hit 16 different banks)
constexpr int F_MAX_NC = 384;   // output columns per CTA (4 column groups x 8 NT)
constexpr int F_MAX_NT = F_MAX_NC / 32;
constexpr int F_MAX_KSPLIT = 24;

// LN(y) (FR x (C + 8)), GELU(h) of one chunk (FR x (hc + 8)) and two weight
// tiles of max(hc x FLD1, nc x FLD2) floats. Mirrored by `tail_f32_smem` in
// ops/mlp.py.
__host__ __device__ inline int tail_f32_smem(int C, int nc, int hc) {
  const int tile = hc * FLD1 > nc * FLD2 ? hc * FLD1 : nc * FLD2;
  return 4 * (FR * (C + 8) + FR * (hc + 8) + 2 * tile);
}

struct TailF32Args {
  const float* skip;
  const float* attn;
  const float* ln_w;
  const float* ln_b;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* out;
  float* ws;  // (k_splits, R, C) f32 partial sums, or null with one split
  int R, C, Hd, chunks;  // chunks: hidden chunks of one split
  float eps;
  int act;
};

// n-tiles of the second product issued together: a divisor of NT, at most 4
__host__ __device__ constexpr int f32_group(int nt) {
  return nt % 4 == 0 ? 4 : nt % 3 == 0 ? 3 : nt % 2 == 0 ? 2 : 1;
}

// The CTA (blockIdx.x, y, z) owns rows 32 x, output columns [nc y, +nc)
// with nc = 32 NT, and hidden chunks of HCF units [chunks z, +chunks).
// Weight tiles arrive by cp.async into a double buffer, in the order the
// products consume them: per hidden chunk the C / FK1 tiles of w1[chunk]
// (FK1 input columns of its HCF rows), then the HCF / FK2 tiles of
// w2[cols, chunk] (FK2 hidden columns of its nc rows). Every product is
// split TF32 on mma.sync m16n8k8 (csrc/tf32.cuh), flushed into f32 sums
// every FLUSH k-steps.
template <int NT, int HCF>
__global__ void __launch_bounds__(FTH, 1) block_tail_f32_kernel(const TailF32Args a) {
  constexpr int NC = 32 * NT, NB = f32_group(NT), NH = HCF / 32;
  static_assert(FK2 / 8 == FLUSH, "a w2 tile is one flush of k-steps");
  extern __shared__ __align__(16) float fsm[];
  const int C = a.C, SX = C + 8, SH = HCF + 8;
  float* Xn = fsm;
  float* Hs = Xn + FR * SX;
  float* Wt = Hs + FR * SH;
  constexpr int stage = HCF * FLD1 > NC * FLD2 ? HCF * FLD1 : NC * FLD2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * FR, n0 = blockIdx.y * NC, hbase = blockIdx.z * a.chunks * HCF;
  const int kt1 = C / FK1, per_chunk = kt1 + HCF / FK2, total = a.chunks * per_chunk;

  // tile q into buffer q % 2, as one cp.async group
  auto issue = [&](int q) {
    const int c = q / per_chunk, i = q - c * per_chunk, h0 = hbase + c * HCF;
    const uint32_t dst = smem_u32(Wt + (q & 1) * stage);
    if (i < kt1) {
      const float* src = a.w1 + (size_t)h0 * C + i * FK1;
      for (int e = tid; e < HCF * (FK1 / 4); e += FTH) {
        const int r = e / (FK1 / 4), v = e - r * (FK1 / 4);
        cp16(dst + (r * FLD1 + 4 * v) * 4, src + (size_t)r * C + 4 * v, true);
      }
    } else {
      const float* src = a.w2 + (size_t)n0 * a.Hd + h0 + (i - kt1) * FK2;
      for (int e = tid; e < NC * (FK2 / 4); e += FTH) {
        const int r = e / (FK2 / 4), v = e - r * (FK2 / 4);
        cp16(dst + (r * FLD2 + 4 * v) * 4, src + (size_t)r * a.Hd + 4 * v, true);
      }
    }
    cp_commit();
  };
  issue(0);

  // y = skip + attn and LN(y) in f32 (zeros past R), four rows per warp:
  // the sums in one pass, the normalised row in a second (from L1)
  for (int rr = 0; rr < FR / FW; ++rr) {
    const int r = warp * (FR / FW) + rr, row = row0 + r;
    float* xr = Xn + r * SX;
    if (row >= a.R) {
      for (int c = 4 * lane; c < C; c += 128)
        *reinterpret_cast<float4*>(xr + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float4* sp = reinterpret_cast<const float4*>(a.skip + (size_t)row * C);
    const float4* ap = reinterpret_cast<const float4*>(a.attn + (size_t)row * C);
    float s = 0.f, ss = 0.f;
    for (int j = lane; j < C / 4; j += 32) {
      const float4 u = sp[j], v = ap[j];
      const float y0 = u.x + v.x, y1 = u.y + v.y, y2 = u.z + v.z, y3 = u.w + v.w;
      s += (y0 + y1) + (y2 + y3);
      ss += (y0 * y0 + y1 * y1) + (y2 * y2 + y3 * y3);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float mean = s / C;
    const float rs = rsqrtf(fmaxf(ss / C - mean * mean, 0.f) + a.eps);
    for (int j = lane; j < C / 4; j += 32) {
      const float4 u = sp[j], v = ap[j];
      const float4 w = reinterpret_cast<const float4*>(a.ln_w)[j];
      const float4 b = reinterpret_cast<const float4*>(a.ln_b)[j];
      *reinterpret_cast<float4*>(xr + 4 * j) =
          make_float4(((u.x + v.x) - mean) * rs * w.x + b.x, ((u.y + v.y) - mean) * rs * w.y + b.y,
                      ((u.z + v.z) - mean) * rs * w.z + b.z, ((u.w + v.w) - mean) * rs * w.w + b.w);
    }
  }

  // warp roles: m-tile wm (rows 16 wm + g, + 8); in the first product the
  // NH hidden n-tiles [NH wq, + NH) of the chunk, in the second the output
  // columns [8 NT wq, + 8 NT) of the CTA's
  const int wm = warp & 1, wq = warp >> 1;
  const float* xa = Xn + (16 * wm + g) * SX + 2 * t;
  const float* ha = Hs + (16 * wm + g) * SH + 2 * t;
  float od[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) od[n][0] = od[n][1] = od[n][2] = od[n][3] = 0.f;

  int q = 0;
  for (int c = 0; c < a.chunks; ++c) {
    // h = LN(y) w1[chunk]^T: k-step kk of tile i takes input columns
    // FK1 i + 8 kk + 2t, + 1 (the same order for A and B)
    float hd[NH][4], ht[NH][4];
#pragma unroll
    for (int n = 0; n < NH; ++n) hd[n][0] = hd[n][1] = hd[n][2] = hd[n][3] = 0.f;
    for (int i = 0; i < kt1; ++i, ++q) {
      if (q + 1 < total) issue(q + 1);
      else cp_commit();
      cp_wait<1>();  // tile q has landed (and, first, LN(y) is written)
      __syncthreads();
      const float* wt = Wt + (q & 1) * stage + (8 * NH * wq + g) * FLD1 + 2 * t;
#pragma unroll
      for (int kk = 0; kk < FK1 / 8; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(xa + FK1 * i + 8 * kk);
        const float2 x1 = *reinterpret_cast<const float2*>(xa + 8 * SX + FK1 * i + 8 * kk);
        uint32_t ah[4], al[4];
        split(x0.x, ah[0], al[0]);
        split(x1.x, ah[1], al[1]);
        split(x0.y, ah[2], al[2]);
        split(x1.y, ah[3], al[3]);
        float kb[NH][2];
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          const float2 y = *reinterpret_cast<const float2*>(wt + 8 * n * FLD1 + 8 * kk);
          kb[n][0] = y.x;
          kb[n][1] = y.y;
        }
        if (kk % FLUSH == 0)
          mma3<NH, true>(ht, ah, al, kb);
        else
          mma3<NH, false>(ht, ah, al, kb);
        if (kk % FLUSH == FLUSH - 1) flush<NH>(hd, ht);
      }
      __syncthreads();  // every warp is done with buffer q % 2
    }
    // h + b1 and GELU in f32, into Hs (the A operand of the second product)
    const int hc0 = hbase + c * HCF;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int col = 8 * (NH * wq + n) + 2 * t;
      const float b0 = a.b1[hc0 + col], b1 = a.b1[hc0 + col + 1];
      float* hr = Hs + (16 * wm + g) * SH + col;
      *reinterpret_cast<float2*>(hr) = make_float2(gelu(hd[n][0] + b0, a.act),
                                                   gelu(hd[n][1] + b1, a.act));
      *reinterpret_cast<float2*>(hr + 8 * SH) = make_float2(gelu(hd[n][2] + b0, a.act),
                                                            gelu(hd[n][3] + b1, a.act));
    }
    // out[:, cols] += GELU(h) w2[cols, chunk]^T: tile i2 holds hidden
    // columns FK2 i2 + [0, 16), one flush of two k-steps; k-step u takes
    // FK2 i2 + 8 u + 2t, + 1
    for (int i2 = 0; i2 < HCF / FK2; ++i2, ++q) {
      if (q + 1 < total) issue(q + 1);
      else cp_commit();
      cp_wait<1>();
      __syncthreads();  // tile q has landed and Hs is written
      const float* wt = Wt + (q & 1) * stage + (8 * NT * wq + g) * FLD2 + 2 * t;
      uint32_t ah[FLUSH][4], al[FLUSH][4];
#pragma unroll
      for (int u = 0; u < FLUSH; ++u) {
        const float2 x0 = *reinterpret_cast<const float2*>(ha + FK2 * i2 + 8 * u);
        const float2 x1 = *reinterpret_cast<const float2*>(ha + 8 * SH + FK2 * i2 + 8 * u);
        split(x0.x, ah[u][0], al[u][0]);
        split(x1.x, ah[u][1], al[u][1]);
        split(x0.y, ah[u][2], al[u][2]);
        split(x1.y, ah[u][3], al[u][3]);
      }
#pragma unroll
      for (int n0b = 0; n0b < NT; n0b += NB) {
        float ot[NB][4];
#pragma unroll
        for (int u = 0; u < FLUSH; ++u) {
          float kb[NB][2];
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            const float2 y = *reinterpret_cast<const float2*>(wt + 8 * (n0b + n) * FLD2 + 8 * u);
            kb[n][0] = y.x;
            kb[n][1] = y.y;
          }
          if (u == 0)
            mma3<NB, true>(ot, ah[u], al[u], kb);
          else
            mma3<NB, false>(ot, ah[u], al[u], kb);
        }
        flush<NB>(od + n0b, ot);
      }
      __syncthreads();  // every warp is done with buffer q % 2 (and, last, with Hs)
    }
  }

  // out = y + (sum + b2), or this hidden split's f32 partial sum; rows
  // 16 wm + g and + 8, columns n0 + 8 NT wq + 8 n + 2t, + 1
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + 16 * wm + g + 8 * hf;
    if (row >= a.R) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n0 + 8 * NT * wq + 8 * n + 2 * t;
      const size_t off = (size_t)row * C + col;
      float2 o = make_float2(od[n][2 * hf], od[n][2 * hf + 1]);
      if (a.ws != nullptr) {
        *reinterpret_cast<float2*>(a.ws + (size_t)blockIdx.z * a.R * C + off) = o;
      } else {
        const float2 u = *reinterpret_cast<const float2*>(a.skip + off);
        const float2 v = *reinterpret_cast<const float2*>(a.attn + off);
        o.x = (u.x + v.x) + (o.x + a.b2[col]);
        o.y = (u.y + v.y) + (o.y + a.b2[col + 1]);
        *reinterpret_cast<float2*>(a.out + off) = o;
      }
    }
  }
}

// out = y + (sum of the splits' partial sums, in split order, + b2)
__global__ void tail_f32_reduce_kernel(const TailF32Args a, int splits) {
  const size_t n = (size_t)a.R * a.C / 2, plane = (size_t)a.R * a.C;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t off = 2 * i;
    const int col = (int)(off % a.C);
    float o0 = 0.f, o1 = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float2 p = *reinterpret_cast<const float2*>(a.ws + s * plane + off);
      o0 += p.x;
      o1 += p.y;
    }
    const float2 u = *reinterpret_cast<const float2*>(a.skip + off);
    const float2 v = *reinterpret_cast<const float2*>(a.attn + off);
    *reinterpret_cast<float2*>(a.out + off) =
        make_float2((u.x + v.x) + (o0 + a.b2[col]), (u.y + v.y) + (o1 + a.b2[col + 1]));
  }
}

template <int NT, int HCF>
int launch_tail_f32(const TailF32Args& a, dim3 grid, int smem, cudaStream_t s) {
  static int smem_set = 0;  // the attribute only grows; set it once per size
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(block_tail_f32_kernel<NT, HCF>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  block_tail_f32_kernel<NT, HCF><<<grid, FTH, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// hidden chunks of 64 for every NT; of 128 for the decoder's wide tails
// (NT 6 and 12: C = 192, 384, 768). Mirrored by `tail_f32_plan`.
__host__ __device__ inline bool f32_wide_chunks(int nt) { return nt == 6 || nt == 12; }

int launch_tail_f32_nt(int nt, int hc, const TailF32Args& a, dim3 grid, int smem,
                       cudaStream_t s) {
  if (hc == 128) {
    switch (nt) {
      case 6: return launch_tail_f32<6, 128>(a, grid, smem, s);
      case 12: return launch_tail_f32<12, 128>(a, grid, smem, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (nt) {
    case 1: return launch_tail_f32<1, 64>(a, grid, smem, s);
    case 2: return launch_tail_f32<2, 64>(a, grid, smem, s);
    case 3: return launch_tail_f32<3, 64>(a, grid, smem, s);
    case 4: return launch_tail_f32<4, 64>(a, grid, smem, s);
    case 5: return launch_tail_f32<5, 64>(a, grid, smem, s);
    case 6: return launch_tail_f32<6, 64>(a, grid, smem, s);
    case 7: return launch_tail_f32<7, 64>(a, grid, smem, s);
    case 8: return launch_tail_f32<8, 64>(a, grid, smem, s);
    case 9: return launch_tail_f32<9, 64>(a, grid, smem, s);
    case 10: return launch_tail_f32<10, 64>(a, grid, smem, s);
    case 11: return launch_tail_f32<11, 64>(a, grid, smem, s);
    case 12: return launch_tail_f32<12, 64>(a, grid, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// skip, attn, out (R, C) bf16; w1 (Hd, C), w2 (C, Hd) bf16; ln_w, ln_b, b1,
// b2 f32; ws (k_splits, R, C) f32 when k_splits > 1, else null. nt,
// col_splits, k_splits and stages from `tail_plan`; a plan that does not
// cover C and Hd exactly or does not fit a CTA is refused.
extern "C" int dsal_block_tail(const void* skip, const void* attn, const float* ln_w,
                               const float* ln_b, const void* w1, const float* b1,
                               const void* w2, const float* b2, void* out, void* ws, int R,
                               int C, int Hd, float eps, int act, int nt, int col_splits,
                               int k_splits, int wgs, int stages, void* stream) {
  if (R < 1 || C < 32 || C % 32 != 0 || C > MAXC || Hd < HC || Hd % HC != 0)
    return (int)cudaErrorInvalidValue;
  const int nchunks = Hd / HC;
  if (nt < 1 || nt > MAX_NT || nt * col_splits != (C + 63) / 64 || k_splits < 1 ||
      k_splits > MAX_KSPLIT || nchunks % k_splits != 0 || (k_splits > 1) != (ws != nullptr) ||
      (wgs != 1 && wgs != 2) || stages < 2 * wgs || stages % wgs != 0 ||
      stages > MAX_STAGES || tail_smem(C, stages) > SMEM_MAX ||
      BM * nt * 64 * 4 > BM * C * 2 + stages * TILE)
    return (int)cudaErrorInvalidValue;
  CUtensorMap t1, t2;
  if (!make_map(&t1, w1, 1, Hd, C, 64) || !make_map(&t2, w2, 1, C, Hd, 64))
    return (int)cudaErrorInvalidValue;
  TailArgs a;
  a.skip = static_cast<const bf16*>(skip);
  a.attn = static_cast<const bf16*>(attn);
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.b1 = b1;
  a.b2 = b2;
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<float*>(ws);
  a.R = R;
  a.C = C;
  a.chunks = nchunks / k_splits;
  a.stages = stages;
  a.eps = eps;
  a.act = act;
  const dim3 grid((R + BM - 1) / BM, col_splits, k_splits);
  const int smem = tail_smem(C, stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (wgs == 2)
    err = C % 64 == 0 ? launch_nt<2, 2>(nt, t1, t2, a, grid, smem, s)
                      : launch_nt<1, 2>(nt, t1, t2, a, grid, smem, s);
  else
    err = C % 64 == 0 ? launch_nt<2, 1>(nt, t1, t2, a, grid, smem, s)
                      : launch_nt<1, 1>(nt, t1, t2, a, grid, smem, s);
  if (err != 0 || k_splits == 1) return err;
  const size_t pairs = (size_t)R * C / 2;
  const unsigned blocks = (unsigned)((pairs + 255) / 256 < 132 * 8 ? (pairs + 255) / 256 : 132 * 8);
  tail_reduce_kernel<<<blocks, 256, 0, s>>>(a, k_splits);
  return (int)cudaGetLastError();
}

// the f32 instance: skip, attn, out (R, C), w1 (Hd, C), w2 (C, Hd) and the
// vectors f32; ws (k_splits, R, C) f32 when k_splits > 1, else null. nt,
// col_splits, hc (hidden units per chunk) and k_splits from
// `tail_f32_plan`; a plan that does not cover C and Hd exactly or does not
// fit a CTA is refused.
extern "C" int dsal_block_tail_f32(const void* skip, const void* attn, const float* ln_w,
                                   const float* ln_b, const void* w1, const float* b1,
                                   const void* w2, const float* b2, void* out, void* ws, int R,
                                   int C, int Hd, float eps, int act, int nt, int col_splits,
                                   int hc, int k_splits, void* stream) {
  if (R < 1 || C < 32 || C % 32 != 0 || C > MAXC || (hc != 64 && hc != 128) || Hd < hc ||
      Hd % hc != 0 || (hc == 128 && !f32_wide_chunks(nt)))
    return (int)cudaErrorInvalidValue;
  const int nchunks = Hd / hc;
  if (nt < 1 || nt > F_MAX_NT || nt * 32 * col_splits != C || k_splits < 1 ||
      k_splits > F_MAX_KSPLIT || nchunks % k_splits != 0 || (k_splits > 1) != (ws != nullptr) ||
      tail_f32_smem(C, 32 * nt, hc) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  TailF32Args a;
  a.skip = static_cast<const float*>(skip);
  a.attn = static_cast<const float*>(attn);
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.w1 = static_cast<const float*>(w1);
  a.b1 = b1;
  a.w2 = static_cast<const float*>(w2);
  a.b2 = b2;
  a.out = static_cast<float*>(out);
  a.ws = static_cast<float*>(ws);
  a.R = R;
  a.C = C;
  a.Hd = Hd;
  a.chunks = nchunks / k_splits;
  a.eps = eps;
  a.act = act;
  const dim3 grid((R + FR - 1) / FR, col_splits, k_splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_tail_f32_nt(nt, hc, a, grid, tail_f32_smem(C, 32 * nt, hc), s);
  if (err != 0 || k_splits == 1) return err;
  const size_t pairs = (size_t)R * C / 2;
  const unsigned blocks = (unsigned)((pairs + 255) / 256 < 132 * 8 ? (pairs + 255) / 256 : 132 * 8);
  tail_f32_reduce_kernel<<<blocks, 256, 0, s>>>(a, k_splits);
  return (int)cudaGetLastError();
}
