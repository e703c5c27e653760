// K7: the decoder's CvT cross-attention, softmax(q k^T * scale) v per head,
// with few keys.
//
// Replaces the TPU kernel diff_sal_tpu/ops/attention.py:893
// cvt_cross_attention (body _cvt_attn_kernel :841), which keeps k/v (S <= 128
// keys, padded to 128 lanes and masked) resident in VMEM and streams q in
// tiles of whole rows (all heads, BlockSpec((1, tl, C))), so that the (L, S)
// scores never reach HBM. The decoder pools k/v to S = 18 tokens while q
// keeps the full grid (L up to 5376): the function does 4 S flops per q
// element and is bound by the bytes of q and out on the H100. What holds
// such a pass back is bytes in flight and a fixed cost per CTA, so the bf16
// kernel streams:
// - Persistent CTAs (two per SM where two fit, else one) walk a contiguous
//   range of 64-row tiles of whole rows, in (batch item, row tile) order:
//   four or eight consumer warps and one producer warp each. Where the whole
//   rows' k and v do not fit in shared memory beside a tile, or the tiles
//   are fewer than the SMs, the heads are split into groups (each a multiple
//   of 32 columns) and a tile is (batch item, head group, 64 rows).
// - q tiles come by TMA (32-column boxes, 64-byte swizzle, rows past L
//   zero-filled) into a ring of 1-4 buffers behind full/empty mbarriers,
//   issued by the producer up to `stages` tiles ahead. k and v of the
//   current batch item (padded to SP = 16, 32, 64 or 128 keys by TMA's zero
//   fill) stay resident and are reloaded only when the batch item (or head
//   group) changes.
// - Each consumer warp owns 16 rows of a tile and its share of the group's
//   heads (eight warps, two per 16 rows, where a group holds two heads or
//   more). Per head: the scores q k^T on the tensor cores (mma.sync
//   m16n8k16 bf16, f32 accumulation, fragments by ldmatrix from the
//   swizzled tiles), times the scale, padded keys masked; the softmax in
//   f32 in the accumulator registers (row max and sum over the 4 lanes of
//   a quad), p normalised and rounded to bf16 as the A operand of p v (V by
//   ldmatrix.trans), f32 accumulation, one rounding of each output, written
//   over the head's q columns of the same tile.
// - The producer stores each finished tile by TMA (columns and rows past
//   the tensor clipped) while the consumers compute the next, and refills
//   its buffer once the store has read it.
// Layouts: q, out (Bt, L, C), k and v (Bt, S, C), all bf16, contiguous and
// 16-byte aligned; C = heads * hd with hd % 16 == 0, 1 <= S <= 128. The
// plan (keys padded, head groups, stages, CTAs per SM) is chosen here and
// mirrored by `cvt_plan` in ops/attention.py.
//
// The f32 instance (`dsal_cvt_attention_f32`, for an f32 model) streams the
// same way, with its products in split TF32 on the tensor cores (below).

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int TR = 16 * WARPS;  // rows per tile of the bf16 kernel
constexpr int MAX_S = 128;
constexpr int MAX_STAGES = 4;
constexpr int NUM_SMS = 132;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a CTA may use
constexpr int SMEM_TWO = 115712;  // per CTA when two share an SM (228 KB less 1 KB each)

struct CvtPlan {
  int sp, groups, head_ways, chunks, stages, per_sm, smem;
};

// a tile buffer: chunks x TR rows x 64 bytes; k and v: chunks x sp x 64
// bytes each; the mbarriers (full and empty per buffer, k/v); 1024 bytes to
// align the base
__host__ __device__ inline int cvt_smem(int chunks, int sp, int stages) {
  return stages * chunks * TR * 64 + 2 * chunks * sp * 64 + (2 * stages + 1) * 8 + 1024;
}

// Keys padded to a power of two >= 16. Heads split into groups (a group
// short of all heads spans a multiple of 32 columns) where whole rows' k
// and v do not fit beside a tile, and further while the tiles do not give
// every SM one; two warps per 16 rows (each a share of the group's heads)
// where a group holds two heads or more. Two CTAs per SM with at least two
// buffers each where they fit, else one with as many buffers (up to four)
// as fit. Mirrored by `cvt_plan` in ops/attention.py. Returns false where
// nothing fits.
bool cvt_plan(int Bt, int L, int S, int C, int heads, CvtPlan* out) {
  const int hd = heads > 0 ? C / heads : 0;
  if (Bt < 1 || L < 1 || S < 1 || S > MAX_S || hd < 16 || hd % 16 != 0 || hd * heads != C)
    return false;
  int sp = 16;
  while (sp < S) sp *= 2;
  const int rtiles = (L + TR - 1) / TR;
  int groups = 0;
  for (int g = 1; g <= heads; ++g) {
    if (heads % g != 0 || (g > 1 && heads / g * hd % 32 != 0)) continue;
    if (cvt_smem((heads / g * hd + 31) / 32, sp, 1) > SMEM_MAX) continue;
    groups = g;
    if (Bt * g * rtiles >= NUM_SMS) break;
  }
  if (groups == 0) return false;
  const int hg = heads / groups, chunks = (hg * hd + 31) / 32;
  const int ways = hg >= 2 ? 2 : 1;
  for (int stages = MAX_STAGES; stages >= 2; --stages) {
    if (cvt_smem(chunks, sp, stages) <= SMEM_TWO) {
      *out = {sp, groups, ways, chunks, stages, 2, cvt_smem(chunks, sp, stages)};
      return true;
    }
  }
  for (int stages = MAX_STAGES; stages >= 1; --stages) {
    if (cvt_smem(chunks, sp, stages) <= SMEM_MAX) {
      *out = {sp, groups, ways, chunks, stages, 1, cvt_smem(chunks, sp, stages)};
      return true;
    }
  }
  return false;
}

struct CvtParams {
  int L, S, hd, hg, groups, chunks, rtiles, ntiles, stages;
  float scale;
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// register operands only: the compiler may interleave independent products
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of (row, col) in a [chunks][nrows][32] bf16 region that TMA
// wrote with the 64-byte swizzle (the 16-byte unit of a 64-byte row is
// XORed with bits 1-2 of the row); col % 8 == 0, the region 512-aligned
__device__ __forceinline__ uint32_t sw_off(int nrows, int row, int col) {
  return (col >> 5) * nrows * 64 + row * 64 + ((((col & 31) >> 3) ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// (batch item, head group, row tile) of tile index `tile`, row tiles fastest
// (the bf16 kernel's CvtParams and the f32 instance's CvtF32Params)
template <typename P>
__device__ __forceinline__ void tile_coords(const P& p, int tile, int& bt, int& grp, int& rt) {
  rt = tile % p.rtiles;
  const int bg = tile / p.rtiles;
  grp = bg % p.groups;
  bt = bg / p.groups;
}

// the q tile `tile` into buffer `dst`, completing on `bar`
__device__ __forceinline__ void load_q(const CUtensorMap* tq, const CvtParams& p, uint32_t dst,
                                       uint32_t bar, int tile) {
  int bt, grp, rt;
  tile_coords(p, tile, bt, grp, rt);
  mbar_expect_tx(bar, p.chunks * TR * 64);
  for (int c = 0; c < p.chunks; ++c)
    tma_load(dst + c * TR * 64, tq, bar, grp * p.hg * p.hd + 32 * c, rt * TR, bt);
}

// kv buffer id of a tile: k and v are reloaded where it changes
__device__ __forceinline__ int kv_id(const CvtParams& p, int tile) { return tile / p.rtiles; }

// Warps 0 .. 4 HW - 1 consume: warp w takes rows 16 (w % 4) .. + 15 of
// each tile and heads w / 4, w / 4 + HW, .. of its group. Warp 4 HW's first
// thread produces: it keeps q tiles `stages` ahead, reloads k and v where
// the batch item (or head group) changes, and stores each finished tile.
template <int SP, int HW>
__global__ void __launch_bounds__(32 * (4 * HW + 1))
    cvt_attn_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                    const CvtParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const int tile_bytes = p.chunks * TR * 64, kv_bytes = p.chunks * SP * 64;
  const uint32_t kb = sbase + p.stages * tile_bytes, vb = kb + kv_bytes;
  // mbarriers: full (tile landed) and empty (tile computed) per buffer, k/v landed
  const uint32_t full = vb + kv_bytes, empty = full + 8 * p.stages, kvbar = empty + 8 * p.stages;
  // this CTA's contiguous range of tiles
  const int t0 = (int)((long long)blockIdx.x * p.ntiles / gridDim.x);
  const int n = (int)((long long)(blockIdx.x + 1) * p.ntiles / gridDim.x) - t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * HW);
    }
    mbar_init(kvbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * HW) {  // the producer
    if (lane != 0) return;
    auto load_kv = [&](int tile) {
      int bt, grp, rt;
      tile_coords(p, tile, bt, grp, rt);
      mbar_expect_tx(kvbar, 2 * kv_bytes);
      for (int c = 0; c < p.chunks; ++c) {
        tma_load(kb + c * SP * 64, &tk, kvbar, grp * p.hg * p.hd + 32 * c, 0, bt);
        tma_load(vb + c * SP * 64, &tv, kvbar, grp * p.hg * p.hd + 32 * c, 0, bt);
      }
    };
    if (n > 0) load_kv(t0);
    for (int i = 0; i < n && i < p.stages; ++i)
      load_q(&tq, p, sbase + i * tile_bytes, full + 8 * i, t0 + i);
    for (int i = 0; i < n; ++i) {
      const int s = i % p.stages, tile = t0 + i;
      mbar_wait(empty + 8 * s, (i / p.stages) & 1);  // the consumers are done with tile i
      if (i + 1 < n && kv_id(p, tile + 1) != kv_id(p, tile)) load_kv(tile + 1);
      int bt, grp, rt;
      tile_coords(p, tile, bt, grp, rt);
      const uint32_t qb = sbase + s * tile_bytes;
      for (int c = 0; c < p.chunks; ++c)
        tma_store(&to, qb + c * TR * 64, grp * p.hg * p.hd + 32 * c, rt * TR, bt);
      bulk_commit();
      if (i + p.stages < n) {
        bulk_wait_read<0>();  // the buffer is free once the store has read it
        load_q(&tq, p, qb, full + 8 * s, tile + p.stages);
      }
    }
    bulk_wait_all();  // shared memory stays until the stores are done
    return;
  }

  const int r16 = (warp & 3) * 16;
  int cur_kv = -1, kv_parity = 0;
  for (int i = 0; i < n; ++i) {
    const int tile = t0 + i, s = i % p.stages;
    if (kv_id(p, tile) != cur_kv) {
      mbar_wait(kvbar, kv_parity);
      kv_parity ^= 1;
      cur_kv = kv_id(p, tile);
    }
    mbar_wait(full + 8 * s, (i / p.stages) & 1);
    const uint32_t qb = sbase + s * tile_bytes;
    unsigned char* qp = smem + s * tile_bytes;

    for (int hh = warp >> 2; hh < p.hg; hh += HW) {
      const int c0 = hh * p.hd;
      // scores of this warp's 16 rows against the SP keys
      float sc[SP / 8][4];
#pragma unroll
      for (int j = 0; j < SP / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      for (int kk = 0; kk < p.hd; kk += 16) {
        uint32_t a[4];
        ldsm_x4(qb + sw_off(TR, r16 + (lane & 15), c0 + kk + (lane >> 4) * 8), a);
#pragma unroll
        for (int j = 0; j < SP / 16; ++j) {
          uint32_t bb[4];  // keys 16 j .. 16 j + 15: (n-tile 2j: b0, b1), (2j + 1: b0, b1)
          ldsm_x4(kb + sw_off(SP, 16 * j + (lane & 7) + ((lane >> 4) << 3),
                              c0 + kk + ((lane >> 3) & 1) * 8), bb);
          mma16(sc[2 * j], a, bb[0], bb[1]);
          mma16(sc[2 * j + 1], a, bb[2], bb[3]);
        }
      }
      // softmax of rows g and g + 8 in f32; keys past S masked
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < SP / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * t + (e & 1);
          sc[j][e] = key < p.S ? sc[j][e] * p.scale : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < SP / 8; ++j) {
        sc[j][0] = __expf(sc[j][0] - mx0);
        sc[j][1] = __expf(sc[j][1] - mx0);
        sc[j][2] = __expf(sc[j][2] - mx1);
        sc[j][3] = __expf(sc[j][3] - mx1);
        s0 += sc[j][0] + sc[j][1];
        s1 += sc[j][2] + sc[j][3];
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      const float i0 = 1.f / s0, i1 = 1.f / s1;
      uint32_t pa[SP / 16][4];  // p in bf16, the A fragments of p v
#pragma unroll
      for (int j = 0; j < SP / 16; ++j) {
        pa[j][0] = pack_bf16(sc[2 * j][0] * i0, sc[2 * j][1] * i0);
        pa[j][1] = pack_bf16(sc[2 * j][2] * i1, sc[2 * j][3] * i1);
        pa[j][2] = pack_bf16(sc[2 * j + 1][0] * i0, sc[2 * j + 1][1] * i0);
        pa[j][3] = pack_bf16(sc[2 * j + 1][2] * i1, sc[2 * j + 1][3] * i1);
      }
      // p v, 16 output columns at a time, written over the head's q columns
      // (this warp's rows only: nothing else reads them)
      for (int n0 = 0; n0 < p.hd; n0 += 16) {
        float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int j = 0; j < SP / 16; ++j) {
          uint32_t bb[4];  // keys 16 j ..: (columns n0 .. n0 + 7: b0, b1), (n0 + 8 ..: b0, b1)
          ldsm_x4_t(vb + sw_off(SP, 16 * j + (lane & 7) + ((lane >> 3) & 1) * 8,
                                c0 + n0 + (lane >> 4) * 8), bb);
          mma16(o[0], pa[j], bb[0], bb[1]);
          mma16(o[1], pa[j], bb[2], bb[3]);
        }
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const int col = c0 + n0 + 8 * nn, ra = r16 + g;
          *reinterpret_cast<uint32_t*>(qp + sw_off(TR, ra, col) + 4 * t) =
              pack_bf16(o[nn][0], o[nn][1]);
          *reinterpret_cast<uint32_t*>(qp + sw_off(TR, ra + 8, col) + 4 * t) =
              pack_bf16(o[nn][2], o[nn][3]);
        }
      }
    }
    fence_async_smem();  // the out tile is read by the TMA store (async proxy)
    mbar_arrive(empty + 8 * s);
  }
}

template <int SP, int HW>
int cvt_launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
               const CUtensorMap& to, const CvtParams& p, int grid, int smem, cudaStream_t s) {
  static int smem_set = 0;  // the attribute only grows; set it once per size
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(cvt_attn_kernel<SP, HW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  cvt_attn_kernel<SP, HW><<<grid, 32 * (4 * HW + 1), smem, s>>>(tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

template <int HW>
int cvt_launch_sp(int sp, const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                  const CUtensorMap& to, const CvtParams& p, int grid, int smem, cudaStream_t s) {
  switch (sp) {
    case 16: return cvt_launch<16, HW>(tq, tk, tv, to, p, grid, smem, s);
    case 32: return cvt_launch<32, HW>(tq, tk, tv, to, p, grid, smem, s);
    case 64: return cvt_launch<64, HW>(tq, tk, tv, to, p, grid, smem, s);
    default: return cvt_launch<128, HW>(tq, tk, tv, to, p, grid, smem, s);
  }
}

// ------------------------------------------------------ the f32 instance ---
//
// The same streaming design in f32: the tiles are 32-column TMA boxes of
// f32 (128 bytes, 128-byte swizzle: the 16-byte unit of a row is XORed with
// bits 0-2 of the row), `tr` rows each (64; 32 or 16 where a 64-row tile
// does not fit beside one head's k and v), the consumers two per 16 rows
// where a group holds two heads. k and v stay resident as raw f32 rows
// (row stride 32 chunks + 4 floats, so that both fragment patterns below are
// free of bank conflicts), loaded by the consumers themselves where the
// batch item (or head group) changes, behind a consumer-only barrier.
//
// The products: one path for every S, split TF32 on the tensor cores
// (csrc/tf32.cuh: mma.sync m16n8k8, three TF32 products per product, f32
// sums every FLUSH k-steps), keys padded to SP = 8, 16, 32, 64 or 128. At
// the decoder's S = 18 the function does 4 S = 72 flops per 8 bytes of q
// and out (9 flop/B): FFMA at 67 TFLOP/s over 3.35 TB/s would keep pace up
// to 20 flop/B if every lane worked, but at S = 128 it is 64 flop/B, which
// only the tensor cores keep bytes-bound; split TF32 serves both, and
// padding S = 18 to 32 keys costs tensor-core time this pass has to spare.
// Per 16 rows and head: s = q k^T (A: q from the swizzled tile, split as it
// loads; B: k, split as it loads), times the scale, keys past S masked, the
// softmax in f32 registers over the 4 lanes of a quad (expf, p = e / sum,
// as the plain version), then p v (A: p from the accumulator, k-step j
// taking keys 8 j + 2t and 8 j + 2t + 1, the columns a thread holds; B: v),
// four head-dim n-tiles at a time, written over the head's q columns of the
// same tile for the TMA store. Mirrored by `cvt_f32_plan` in
// ops/attention.py.

constexpr int F32_MAX_THREADS = 32 * (4 * 2 + 1);  // 64-row tiles, two warps per 16 rows

struct CvtF32Plan {
  int sp, groups, head_ways, chunks, tr, stages, per_sm, smem;
};

// a tile buffer: chunks x tr rows x 128 bytes; k and v: sp rows x (32 chunks
// + 4) floats each; the mbarriers (full and empty per buffer); 1024 bytes
// to align the base
__host__ __device__ inline int cvt_f32_smem(int chunks, int sp, int tr, int stages) {
  return stages * chunks * tr * 128 + 2 * sp * (32 * chunks + 4) * 4 + 2 * stages * 8 + 1024;
}

// Keys padded to a power of two >= 8. 64-row tiles, else 32, else 16: the
// first that fits one head's k and v beside one tile. Heads split into
// groups as the bf16 plan splits them; two consumer warps per 16 rows where
// a group holds two heads or more; two CTAs per SM with at least two
// buffers each where they fit, else one with as many buffers (up to four)
// as fit. Returns false where nothing fits.
bool cvt_f32_plan(int Bt, int L, int S, int C, int heads, CvtF32Plan* out) {
  const int hd = heads > 0 ? C / heads : 0;
  if (Bt < 1 || L < 1 || S < 1 || S > MAX_S || hd < 8 || hd % 8 != 0 || hd * heads != C)
    return false;
  int sp = 8;
  while (sp < S) sp *= 2;
  for (int tr = 64; tr >= 16; tr /= 2) {
    const int rtiles = (L + tr - 1) / tr;
    int groups = 0;
    for (int g = 1; g <= heads; ++g) {
      if (heads % g != 0 || (g > 1 && heads / g * hd % 32 != 0)) continue;
      if (cvt_f32_smem((heads / g * hd + 31) / 32, sp, tr, 1) > SMEM_MAX) continue;
      groups = g;
      if (Bt * g * rtiles >= NUM_SMS) break;
    }
    if (groups == 0) continue;
    const int hg = heads / groups, chunks = (hg * hd + 31) / 32;
    const int ways = hg >= 2 ? 2 : 1;
    for (int stages = MAX_STAGES; stages >= 2; --stages) {
      if (cvt_f32_smem(chunks, sp, tr, stages) <= SMEM_TWO) {
        *out = {sp, groups, ways, chunks, tr, stages, 2, cvt_f32_smem(chunks, sp, tr, stages)};
        return true;
      }
    }
    for (int stages = MAX_STAGES; stages >= 1; --stages) {
      if (cvt_f32_smem(chunks, sp, tr, stages) <= SMEM_MAX) {
        *out = {sp, groups, ways, chunks, tr, stages, 1, cvt_f32_smem(chunks, sp, tr, stages)};
        return true;
      }
    }
  }
  return false;
}

struct CvtF32Params {
  const float *k, *v;
  int L, S, C, hd, hg, groups, chunks, tr, rtiles, ntiles, stages, ways;
  float scale;
};

// float offset of (row, col) in a [chunks][nrows][32] f32 region that TMA
// wrote with the 128-byte swizzle, the region 1024-aligned
__device__ __forceinline__ int sw_f32(int nrows, int row, int col) {
  return (col >> 5) * nrows * 32 + row * 32 + ((((col & 31) >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// o (+)= p v for NC head-dim n-tiles from n-tile n0 of the head at column
// c0: A the softmax's p of this thread's rows (accumulator layout), B the
// resident v rows; written over the head's q columns of rows ra, ra + 8
template <int SP, int NC>
__device__ __forceinline__ void pv_chunk(const float (&pr)[SP / 8][4], const float* vs, int ks,
                                         float* qt, int tr, int ra, int c0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* vb = vs + 2 * t * ks + c0 + 8 * n0 + g;
  float o[NC][4], part[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < SP / 8; ++j) {
    uint32_t ah[4], al[4];
    split(pr[j][0], ah[0], al[0]);
    split(pr[j][2], ah[1], al[1]);
    split(pr[j][1], ah[2], al[2]);
    split(pr[j][3], ah[3], al[3]);
    float bb[NC][2];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      bb[n][0] = vb[8 * j * ks + 8 * n];
      bb[n][1] = vb[(8 * j + 1) * ks + 8 * n];
    }
    if (j % FLUSH == 0)
      mma3<NC, true>(part, ah, al, bb);
    else
      mma3<NC, false>(part, ah, al, bb);
    if (j % FLUSH == FLUSH - 1 || j == SP / 8 - 1) flush<NC>(o, part);
  }
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    const int col = c0 + 8 * (n0 + n) + 2 * t;
    *reinterpret_cast<float2*>(qt + sw_f32(tr, ra, col)) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(qt + sw_f32(tr, ra + 8, col)) = make_float2(o[n][2], o[n][3]);
  }
}

// Warps 0 .. R W - 1 consume (R = tr / 16 warps per row tile, W head ways):
// warp w takes rows 16 (w % R) .. + 15 of each tile and heads w / R,
// w / R + W, .. of its group. Warp R W's first thread produces: it keeps q
// tiles `stages` ahead and stores each finished tile.
template <int SP>
__global__ void __launch_bounds__(F32_MAX_THREADS, SP <= 32 ? 2 : 1)
    cvt_attn_f32_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap to, const CvtF32Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const int tile_bytes = p.chunks * p.tr * 128, ks = 32 * p.chunks + 4;
  float* kf = reinterpret_cast<float*>(smem + p.stages * tile_bytes);
  float* vf = kf + SP * ks;
  const uint32_t full = smem_u32(vf + SP * ks), empty = full + 8 * p.stages;
  const int R = p.tr / 16, consumers = 32 * R * p.ways;
  // this CTA's contiguous range of tiles
  const int t0 = (int)((long long)blockIdx.x * p.ntiles / gridDim.x);
  const int n = (int)((long long)(blockIdx.x + 1) * p.ntiles / gridDim.x) - t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, consumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  auto load_q = [&](uint32_t dst, uint32_t bar, int tile) {
    int bt, grp, rt;
    tile_coords(p, tile, bt, grp, rt);
    mbar_expect_tx(bar, tile_bytes);
    for (int c = 0; c < p.chunks; ++c)
      tma_load(dst + c * p.tr * 128, &tq, bar, grp * p.hg * p.hd + 32 * c, rt * p.tr, bt);
  };

  if (warp == R * p.ways) {  // the producer
    if (lane != 0) return;
    for (int i = 0; i < n && i < p.stages; ++i) load_q(sbase + i * tile_bytes, full + 8 * i, t0 + i);
    for (int i = 0; i < n; ++i) {
      const int s = i % p.stages, tile = t0 + i;
      mbar_wait(empty + 8 * s, (i / p.stages) & 1);  // the consumers are done with tile i
      int bt, grp, rt;
      tile_coords(p, tile, bt, grp, rt);
      const uint32_t qb = sbase + s * tile_bytes;
      for (int c = 0; c < p.chunks; ++c)
        tma_store(&to, qb + c * p.tr * 128, grp * p.hg * p.hd + 32 * c, rt * p.tr, bt);
      bulk_commit();
      if (i + p.stages < n) {
        bulk_wait_read<0>();  // the buffer is free once the store has read it
        load_q(qb, full + 8 * s, tile + p.stages);
      }
    }
    bulk_wait_all();  // shared memory stays until the stores are done
    return;
  }

  const int r16 = (warp % R) * 16, cols = p.hg * p.hd;
  int cur_kv = -1;
  for (int i = 0; i < n; ++i) {
    const int tile = t0 + i, s = i % p.stages;
    if (tile / p.rtiles != cur_kv) {  // this batch item's (and group's) k and v
      if (cur_kv >= 0) named_sync(1, consumers);  // every consumer is done with the old ones
      cur_kv = tile / p.rtiles;
      const int grp = cur_kv % p.groups, bt = cur_kv / p.groups;
      const size_t base = (size_t)bt * p.S * p.C + (size_t)grp * cols;
      for (int e = threadIdx.x; e < SP * (cols / 4); e += consumers) {
        const int key = e / (cols / 4), c = (e - key * (cols / 4)) * 4;
        float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
        if (key < p.S) {
          kk = *reinterpret_cast<const float4*>(p.k + base + (size_t)key * p.C + c);
          vv = *reinterpret_cast<const float4*>(p.v + base + (size_t)key * p.C + c);
        }
        *reinterpret_cast<float4*>(kf + key * ks + c) = kk;
        *reinterpret_cast<float4*>(vf + key * ks + c) = vv;
      }
      named_sync(1, consumers);
    }
    mbar_wait(full + 8 * s, (i / p.stages) & 1);
    float* qt = reinterpret_cast<float*>(smem + s * tile_bytes);

    for (int hh = warp / R; hh < p.hg; hh += p.ways) {
      const int c0 = hh * p.hd;
      // scores of this warp's 16 rows against the SP keys, four key
      // n-tiles at a time; k-step kk takes head-dim columns 8 kk + t, + 4
      float sc[SP / 8][4];
      constexpr int NCH = SP / 8 < 4 ? SP / 8 : 4;
#pragma unroll
      for (int n0 = 0; n0 < SP / 8; n0 += NCH) {
        float acc[NCH][4], part[NCH][4];
#pragma unroll
        for (int j = 0; j < NCH; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        const float* kb = kf + (8 * n0 + g) * ks + c0 + t;
        for (int kk = 0; kk < p.hd / 8; ++kk) {
          const int col = c0 + 8 * kk + t;
          uint32_t ah[4], al[4];
          split(qt[sw_f32(p.tr, r16 + g, col)], ah[0], al[0]);
          split(qt[sw_f32(p.tr, r16 + g + 8, col)], ah[1], al[1]);
          split(qt[sw_f32(p.tr, r16 + g, col + 4)], ah[2], al[2]);
          split(qt[sw_f32(p.tr, r16 + g + 8, col + 4)], ah[3], al[3]);
          float bb[NCH][2];
#pragma unroll
          for (int j = 0; j < NCH; ++j) {
            bb[j][0] = kb[8 * j * ks + 8 * kk];
            bb[j][1] = kb[8 * j * ks + 8 * kk + 4];
          }
          if (kk % FLUSH == 0)
            mma3<NCH, true>(part, ah, al, bb);
          else
            mma3<NCH, false>(part, ah, al, bb);
          if (kk % FLUSH == FLUSH - 1 || kk == p.hd / 8 - 1) flush<NCH>(acc, part);
        }
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          sc[n0 + j][0] = acc[j][0];
          sc[n0 + j][1] = acc[j][1];
          sc[n0 + j][2] = acc[j][2];
          sc[n0 + j][3] = acc[j][3];
        }
      }
      // softmax of rows g and g + 8 in f32; keys past S masked
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < SP / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * t + (e & 1);
          sc[j][e] = key < p.S ? sc[j][e] * p.scale : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < SP / 8; ++j) {
        sc[j][0] = expf(sc[j][0] - mx0);
        sc[j][1] = expf(sc[j][1] - mx0);
        sc[j][2] = expf(sc[j][2] - mx1);
        sc[j][3] = expf(sc[j][3] - mx1);
        s0 += sc[j][0] + sc[j][1];
        s1 += sc[j][2] + sc[j][3];
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
#pragma unroll
      for (int j = 0; j < SP / 8; ++j) {
        sc[j][0] /= s0;
        sc[j][1] /= s0;
        sc[j][2] /= s1;
        sc[j][3] /= s1;
      }
      // p v, four head-dim n-tiles at a time, then two, then one (head_dim
      // 48 ends on two, 40 on one), over this warp's rows of the head's q
      // columns and no further (the next head's are another warp's)
      int n0 = 0;
      for (; n0 + 4 <= p.hd / 8; n0 += 4) pv_chunk<SP, 4>(sc, vf, ks, qt, p.tr, r16 + g, c0, n0);
      for (; n0 + 2 <= p.hd / 8; n0 += 2) pv_chunk<SP, 2>(sc, vf, ks, qt, p.tr, r16 + g, c0, n0);
      if (n0 < p.hd / 8) pv_chunk<SP, 1>(sc, vf, ks, qt, p.tr, r16 + g, c0, n0);
    }
    fence_async_smem();  // the out tile is read by the TMA store (async proxy)
    mbar_arrive(empty + 8 * s);
  }
}

template <int SP>
int cvt_f32_launch(const CUtensorMap& tq, const CUtensorMap& to, const CvtF32Params& p, int grid,
                   int smem, cudaStream_t s) {
  static int smem_set = 0;  // the attribute only grows; set it once per size
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(cvt_attn_f32_kernel<SP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  cvt_attn_f32_kernel<SP><<<grid, 32 * (p.tr / 16 * p.ways + 1), smem, s>>>(tq, to, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dsal_cvt_attention(const void* q, const void* k, const void* v, void* out,
                                  int Bt, int L, int S, int C, int heads, float scale,
                                  void* stream) {
  CvtPlan plan;
  if (!cvt_plan(Bt, L, S, C, heads, &plan)) return (int)cudaErrorInvalidValue;
  CvtParams p;
  p.L = L;
  p.S = S;
  p.hd = C / heads;
  p.groups = plan.groups;
  p.hg = heads / plan.groups;
  p.chunks = plan.chunks;
  p.rtiles = (L + TR - 1) / TR;
  p.ntiles = Bt * plan.groups * p.rtiles;
  p.stages = plan.stages;
  p.scale = scale;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, Bt, L, C, TR) || !make_map(&tk, k, Bt, S, C, plan.sp) ||
      !make_map(&tv, v, Bt, S, C, plan.sp) || !make_map(&to, out, Bt, L, C, TR))
    return (int)cudaErrorInvalidValue;
  const int grid = p.ntiles < plan.per_sm * NUM_SMS ? p.ntiles : plan.per_sm * NUM_SMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return plan.head_ways == 2 ? cvt_launch_sp<2>(plan.sp, tq, tk, tv, to, p, grid, plan.smem, s)
                              : cvt_launch_sp<1>(plan.sp, tq, tk, tv, to, p, grid, plan.smem, s);
}

// the f32 instance: q, k, v, out f32, contiguous and 16-byte aligned;
// head_dim a multiple of 8 (so C * 4 bytes, TMA's row stride, is a multiple
// of 16), 1 <= S <= 128, one head's k and v within one CTA's shared memory
// beside a 16-row tile (`cvt_f32_plan`)
extern "C" int dsal_cvt_attention_f32(const void* q, const void* k, const void* v, void* out,
                                      int Bt, int L, int S, int C, int heads, float scale,
                                      void* stream) {
  CvtF32Plan plan;
  if (!cvt_f32_plan(Bt, L, S, C, heads, &plan)) return (int)cudaErrorInvalidValue;
  CvtF32Params p;
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.L = L;
  p.S = S;
  p.C = C;
  p.hd = C / heads;
  p.groups = plan.groups;
  p.hg = heads / plan.groups;
  p.chunks = plan.chunks;
  p.tr = plan.tr;
  p.rtiles = (L + plan.tr - 1) / plan.tr;
  p.ntiles = Bt * plan.groups * p.rtiles;
  p.stages = plan.stages;
  p.ways = plan.head_ways;
  p.scale = scale;
  CUtensorMap tq, to;
  if (!make_map(&tq, q, Bt, L, C, plan.tr, true) || !make_map(&to, out, Bt, L, C, plan.tr, true))
    return (int)cudaErrorInvalidValue;
  const int grid = p.ntiles < plan.per_sm * NUM_SMS ? p.ntiles : plan.per_sm * NUM_SMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan.sp) {
    case 8: return cvt_f32_launch<8>(tq, to, p, grid, plan.smem, s);
    case 16: return cvt_f32_launch<16>(tq, to, p, grid, plan.smem, s);
    case 32: return cvt_f32_launch<32>(tq, to, p, grid, plan.smem, s);
    case 64: return cvt_f32_launch<64>(tq, to, p, grid, plan.smem, s);
    default: return cvt_f32_launch<128>(tq, to, p, grid, plan.smem, s);
  }
}
