// Split TF32 on the tensor cores, shared by the f32 instances of the
// attention kernels (csrc/attention_f32_fwd.cu, csrc/attention_f32.cu) and
// of K7 (csrc/cvt_attention.cu): f32 products at about f32's accuracy.
//
// The tensor cores take f32 only as TF32 (10 mantissa bits). Each operand
// x = hi + lo with hi = x rounded to TF32 and lo = x - hi (exact), and
// a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b, small products first, f32
// accumulation (the dropped lo lo term is ~2^-22 of |a b|). Three TF32
// products run at 495 / 3 = 165 TFLOP/s on the H100, 2.5x the FFMA peak.
// An operand that TF32 holds exactly (a one-hot matrix) needs only two.
//
// Also the cp.async copies the f32 kernels stage their tiles with.
// smem_u32 and ex2 come from hopper.cuh. ops/kernels.py hashes included
// headers, and the headers they include, with each source.

#pragma once

#include "hopper.cuh"

namespace {

// 16 bytes from device memory into shared memory, or 16 zero bytes
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes, or a zero
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// x = hi + lo exactly (Veltkamp's split): hi, x rounded to nearest at 11
// significant bits, is a TF32 value; lo = x - hi has at most 13, of which
// the tensor cores read the top 11 (an error below 2^-23 |x|). Four f32
// operations at the full f32 rate, none of them fused (the _rn
// intrinsics), in place of two cvt.rna.tf32.f32 at the conversion rate.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.f);  // 2^13 + 1
  const float h = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

// d = a b (from zero) and d += a b; no side effects, so the compiler may
// interleave independent products
__device__ __forceinline__ void mma_z(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// t[n] (+)= a b[n] for NB n-tiles in split TF32, on the tensor cores: the
// three TF32 products of each n-tile, the small ones first, pass by pass
// over the n-tiles so that NB independent ones are in flight at a time.
// With FIRST, t starts from zero. The caller adds t into its f32 sums every
// FLUSH k-steps: the tensor cores' own accumulation does not round to
// nearest, and over a whole row of k-steps its error grew to 2e-5 on
// outputs of magnitude 1 (measured on the H100), past the f32 tolerance.
template <int NB, bool FIRST>
__device__ __forceinline__ void mma3(float (*t)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const float (&b)[NB][2]) {
  uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    split(b[n][0], bh[n][0], bl[n][0]);
    split(b[n][1], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    if (FIRST)
      mma_z(t[n], al, bh[n][0], bh[n][1]);
    else
      mma(t[n], al, bh[n][0], bh[n][1]);
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) mma(t[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < NB; ++n) mma(t[n], ah, bh[n][0], bh[n][1]);
}

constexpr int FLUSH = 2;  // k-steps summed on the tensor cores between f32 adds

template <int NB>
__device__ __forceinline__ void flush(float (*d)[4], const float (*t)[4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    d[n][0] += t[n][0];
    d[n][1] += t[n][1];
    d[n][2] += t[n][2];
    d[n][3] += t[n][3];
  }
}

}  // namespace
