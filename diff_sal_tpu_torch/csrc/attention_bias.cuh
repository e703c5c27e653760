// The bias terms of the pooled attention's backward, shared by its bf16
// kernels (csrc/attention_bwd.cu) and its f32 instances
// (csrc/attention_f32.cu): where the (t, h, w) terms of a query row lie in
// either layout, and each key's three indices into a raw rel row.
// ops/kernels.py hashes this header with each source that includes it.

#pragma once

#include <cuda_bf16.h>

namespace {

// Where the three parts (t, h, w) of the bias terms of one query row lie:
// element c of part p for (batch b, row, head h) is at
// p[part][(b * Lq + row) * ld[part] + h * hs + c]. K5: one packed bf16
// (B, Lq, H, kt + kh + kw) tensor; K12: three f32 tensors of one head.
template <typename R>
struct RelIn {
  const R* p[3];
  int ld[3];
  int hs;
};

template <typename R>
struct RelOut {
  R* p[3];
  int ld[3];
  int hs;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}
__device__ __forceinline__ void from_f32(float* dst, float x) { *dst = x; }

// part (0 = t, 1 = h, 2 = w) of bias column c, and c's index within it
__device__ __forceinline__ int rel_part(int c, int kt, int kh, int& cc) {
  const int part = c < kt ? 0 : (c < kt + kh ? 1 : 2);
  cc = c - (part == 0 ? 0 : (part == 1 ? kt : kt + kh));
  return part;
}

// index of key j's three bias terms in a raw rel row, 10 bits each: (t,
// kt + h, kt + kh + w); the cls key reads three zeros (column K), a key past
// Lk -inf (column K + 1) and two zeros
__device__ __forceinline__ int key_index(int j, int Lk, int kt, int kh, int kw) {
  const int K = kt + kh + kw;
  if (j == 0) return K | (K << 10) | (K << 20);
  if (j >= Lk) return (K + 1) | (K << 10) | (K << 20);
  const int jj = j - 1, khw = kh * kw, t = jj / khw, rem = jj - t * khw, h = rem / kw;
  return t | ((kt + h) << 10) | ((kt + kh + rem - h * kw) << 20);
}

// the bias of one score, summed as the plain versions sum it: (t + h) + w
__device__ __forceinline__ float bias_at(const float* row, int e) {
  return (row[e & 1023] + row[(e >> 10) & 1023]) + row[e >> 20];
}

}  // namespace
