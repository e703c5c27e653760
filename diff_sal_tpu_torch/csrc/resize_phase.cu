// K9: the decoder's head as conv-at-low-res, as two separable passes through
// shared memory.
//
// Replaces the TPU kernel diff_sal_tpu/ops/resize.py:567
// resize_sum_conv_relu_phase (body _phase_resize_head_kernel :526). conv3x3
// and bilinear resize are both linear, so
//   relu(conv3x3_same(sum_i resize(x_i)) + b)
//     = relu(sum_i sum_dx Aw_dx (sum_dy Ah_dy u_i[dy, dx]) + b),
// with u_i = x_i K' computed per task at its low resolution outside the
// kernel (a matmul, as in the JAX package), its 9 * O columns ordered (dy,
// dx, O). Row o of the dy-shifted row matrix Ah_dy is row o + dy - 1 of the
// bilinear matrix and zero past the borders, which reproduces the conv's
// zero padding exactly; the same holds for the columns and dx. Each bilinear
// row has at most two non-zeros. The kernel is `separable.cuh` with three
// shifts (NS = 3): per CTA (b, a band of output rows, a chunk of O), a dy
// pass computes V_i[o, c, dx, chunk] = sum_dy sum_row-taps wy u_i[row, c, dy,
// dx, chunk] once per (output row, input column, dx) into shared memory in
// u's dtype, each row of u_i read once per band and dy with 16-byte loads,
// and a dx pass adds sum_dx sum_col-taps wx V_i[o, col, dx, :] of every task
// from shared memory in f32 registers, then the f32 bias and ReLU, one
// rounding and 16-byte stores. V never reaches device memory, as the TPU
// kernel keeps its (TH, TW, C) accumulator out of HBM. (The first kernel, one
// thread per output pixel and 8 channels, recomputed the dy contraction for
// every output column: up to 144 loads of 16 bytes from L1/L2 per 16 bytes
// written.) On the H100 the gather is bound by reading u_i (~25 MB at B = 2)
// and writing the output; the plan (`phase_plan` in ops/resize.py) gives the
// band, the O chunk and the column tile.
// Rounding follows the TPU kernel: the interpolation weights are given
// rounded to u's dtype (they are the TPU kernel's bf16 matrices), the dy
// contraction accumulates in f32 and is rounded to u's dtype, the dx
// contraction and the sum over tasks accumulate in f32, then f32 bias, ReLU
// and one rounding of the output.
// Layouts: u_i (B, h_i, w_i, 9 * O), out (B, TH, TW, O), contiguous, one
// dtype (bf16 or f32); tap tables idx (n, 2, 3 * (TH + TW)) int32 [lo | hi]
// and wts (n, 2, 3 * (TH + TW)) f32 [w_lo | w_hi]: entry dy * TH + o is
// output row o under shift dy, entry 3 * TH + dx * TW + p output column p
// under shift dx (zero weights past the borders).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "separable.cuh"

// bf16 needs O % 8 == 0, f32 O % 4 == 0; (bh, cc, tw, cols, ctas) the plan's
// band, O chunk, column tile, staged columns and persistent CTAs
extern "C" int dsal_resize_phase_head(const void* u0, const void* u1, const void* u2,
                                      const void* u3, const int* idx, const float* wts,
                                      const float* bias, void* out, int h0, int h1, int h2,
                                      int h3, int w0, int w1, int w2, int w3, int n, int B,
                                      int TH, int TW, int O, int bh, int cc, int tw, int cols,
                                      int ctas, int is_bf16, void* stream) {
  sep::Args a;
  a.x[0] = u0; a.x[1] = u1; a.x[2] = u2; a.x[3] = u3;
  a.h[0] = h0; a.h[1] = h1; a.h[2] = h2; a.h[3] = h3;
  a.w[0] = w0; a.w[1] = w1; a.w[2] = w2; a.w[3] = w3;
  a.idx = idx;
  a.wts = wts;
  a.bias = bias;
  a.out = out;
  a.n = n; a.B = B; a.H = TH; a.W = TW; a.C = O;
  a.cc = cc; a.tw = tw; a.cols = cols;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return sep::launch<__nv_bfloat16, __nv_bfloat16, 3>(a, bh, ctas, s);
  return sep::launch<float, float, 3>(a, bh, ctas, s);
}
