"""Drive the PyTorch port's paths (AV inference with DDIM, the AV training
step, AV inference with DPM-Solver++ and the eval lowerings, the
visual-only model in both MViT layouts, both models in f32, the f32
attention and training step at full width) on one NVIDIA
GPU and hold each of its hand-written kernels (thirteen in bf16 and the
seven f32 instances an f32 model runs) against its plain PyTorch version.

    python3 chip_smoke.py [--iters N] [--profile]

Phases (each prints its wall time; any failure raises and exits non-zero):
  1. require CUDA and print the card's name and power limit (nvidia-smi);
  2. build every kernel from `diff_sal_tpu_torch/csrc/` (one nvcc per
     source, all started together; cached by the hash of the source and
     its headers in `diff_sal_tpu_torch/_build/`);
  3. main path at full width: `ModelConfig.audio_visual()` (MViTv2-small at
     224x384x16, VGGish, AudioAttnNet, SalUNet) in bf16 from seeded random
     weights, B=2, `sample_saliency` with DDIM NFE=1; checks the (B,224,384,1)
     map is finite, in [0, 1] and not constant; counts each kernel's launches
     in one run (counts set to 0 just before it, read just after) and
     records every kernel call's inputs (the four task maps K4 sums among
     them); times the path with CUDA events on rotating inputs and prints
     clips/s;
  4. each kernel against its plain version on exactly the recorded inputs
     (working dtype, stated tolerance), with the kernel, the plain version,
     the one PyTorch call that computes the same function where there is
     one, each timed by CUDA events, the kernel's and the library call's
     device time under torch.profiler (every kernel, memcpy and memset the
     call issues, each recorded call run once: `device_ms`,
     `library_device_ms`), and the least time the card could take (bytes
     over 3.35 TB/s or operations over the peak rate of their type,
     whichever is larger); for K1 (K12 forward in phase 9; K5 and K12
     backward where they are held) one line per MViT block shape with the
     kernel's and SDPA's ms per call, device time, the share of the bound
     and the launch plan (forward: rows per CTA, keys per tile, stages,
     shared memory; backward: query splits, q-major and k-major CTAs and
     their shared memory), and for K2, K3 and K6 one line per (rows, C)
     with the device time per call, the bound per call and the share of it
     (K2 and K6 also with whether the bulk path took it);
     K4 with a `[shape ...]` line per call shape (its plan: band, chunk,
     column tile, CTAs) and beside it, as context (timed only, never on
     the port's path), the device time of four `F.interpolate(bilinear)`
     calls on channels-last views of its maps and their sum; then K10,
     which no model path calls: the four recorded task maps added one by
     one into a zero accumulator (launches counted in that run), against
     K4's sum of the same maps and each call against K10's plain version;
  5. the whole port at a small size: bf16 through the kernels on the card
     against f32 through the plain versions on the CPU;
  6. the training step at full width: the AV config in bf16, B=4, x0
     target, MSE, Adam with clip, decoder dropout 0.1 and DropPath 0.15,
     `skip_dead_frames_train` on; one warm-up step, then checks (finite
     loss and gradient norm, a finite gradient on every trainable
     parameter on the graph, non-zero gradients in MViT, AudioAttnNet and
     the decoder, none on the frozen VGGish, parameters moved), one step
     with the launch counts set to 0 just before it and read just after
     (K1, K2, K4, K5, K6 launched, K3 not) that records K5's and K6's
     inputs, then timed steps on rotating batches (ms per step, clips/s,
     peak memory); K5 and K6 are then held against their plain versions
     on the recorded inputs and timed as in phase 4;
  7. one training step at a small size (128x96): bf16 through the kernels
     on the card and bf16 through the plain versions on the CPU, each
     against f32 on the CPU: the loss, and the gradients per sub-network
     and per tensor;
  8. the second inference path: `sample_saliency` with DPM-Solver++ 2M
     (bench.py's sweep settings) at NFE 2 and 5 on the full-width AV model
     in bf16 at B=2 with the three eval lowerings (`pool_mode="pallas"`,
     `fused_attn`, `head_lowres`): checks the maps; checks every kernel's
     launches per run against the count the config implies (K11 once per
     pool, independent of NFE; K7 and K3 4 per denoiser call, K9 1; K1 once
     per MViT block; K2 per LayerNorm call of the encoders plus the
     decoder's per call; K4 none) and records K7's, K9's and K11's inputs in
     the NFE 2 run; the same with the head through K8 (`fused_head`), K8
     launched once per denoiser call; the maps against
     the default lowerings on the same inputs and noise (bf16 bound 3e-2);
     ms per run and clips/s with and without the lowerings; K7, K8, K9 and
     K11 held against their plain versions and timed as in phase 4, with a
     `[shape ...]` line per K8 call shape ((out_hw, C, O, inputs)) and per
     K11 call shape (((B, T, H, W), C, stride): its share of the bound that
     counts the input pixels some tap touches, and of the one reading all
     of x), and beside K8 and K9, as context, the device time of the
     unfused head they replace (K4 + cuDNN's conv + bias + ReLU) on each
     one's recorded inputs; K9's device time split into its cuBLAS products
     and its gather kernel, each against its share of the bound, a `[shape
     ...]` line with its plan, and its bound as first counted (every output
     recomputing its dy contraction: `bound_ms_first_count` on its `kernels`
     row);
     the small AV model with the lowerings through DPM++ NFE 2, bf16 on the
     card against f32 on the CPU;
  9. the visual-only model (`ModelConfig.visual_only()`, the DHF1k visual
     pretraining model: MViTv2-small and the SalUNet without audio) at full
     width in bf16, in both MViT layouts with the same weights, inputs,
     noise and draws: `cls_stream` (K1, K5) and the token-concat layout
     (`cls_stream=False`: K12 forward and backward). DDIM NFE 1 at B=2:
     maps checked and within 3e-2 of each other, launches per run against
     `path_launches`; the training step at B=4 with phase 6's recipe: the
     first step's gradients (finite on every trainable tensor on the
     graph, non-zero in MViT and the decoder) compared per sub-network
     between the layouts (cosine >= LAYOUT_GRAD_COS), launches per step;
     ms per run and per step, clips/s and peak memory per layout, timed in
     turns; K12 forward and backward held against their plain versions on
     the recorded inputs (with the forward's logsumexp, which the backward
     kernels read);
 10. f32 (both packages' default compute dtype) at a small size (128x96):
     the small AV model (with `fused_attn`, so K7 runs, and `fused_head`
     set on its head module, so K8 runs) and the small
     visual-only model in the token-concat layout, f32 through the kernels'
     f32 instances on the card against f32 through the plain versions on
     the CPU, same weights, noise and draws: one DDIM run (map within
     F32_MAP_TOL) and one training step (loss, and every gradient tensor
     within F32_GRAD_TOL relative L2), launches per run and per step
     against `path_launches` with the f32 instances in place of the bf16
     kernels, then each f32 instance held against its plain version on
     the recorded inputs at the f32 tolerance (K8's f32 instance against
     its plain version computed in f64, within the larger of 1e-5 and twice
     the f32 plain version's own distance: `hold_f64`);
 11. the f32 attention and K7 at full width: phase 3's recorded K1 calls
     and phase 9's recorded K12 forward calls cast to f32, each through the
     f32 instance, its plain version (computed in f64; the f32 tolerance on
     the output and the logsumexp) and SDPA in f32, one `[block ...]` line per MViT block
     shape (device time per call of the kernel and of SDPA, share of the
     bound at split TF32's rate), and the CUDA kernels SDPA f32 runs; then
     phase 6's 16 recorded K5 calls and phase 9's 16 recorded K12 backward
     calls cast to f32, each through the f32 backward fed with the f32
     forward's logsumexp on the same inputs, every output held against the
     plain version computed in f64 within the larger of 1e-5 and twice the
     f32 plain version's own distance from it (both logged), one `[block
     ..._bwd_f32]` line per block shape beside SDPA f32's backward, the
     device time by CUDA kernel and the CUDA kernels SDPA f32's backward
     runs; then phase 8's recorded K7 calls (DPM++ NFE 2) cast to f32
     against their plain version at 1e-5, one `[shape cvt_attention_f32]`
     line per (Bt, L, C) beside SDPA per head in f32 with the share of the
     bytes bound; then phase 3's four recorded K3 calls cast to f32 through
     K3's f32 instance, each held against the plain version computed in
     f64 within the larger of 1e-5 and twice the f32 plain version's own
     distance from it, one `[shape block_tail_f32]` line per (rows, C) with
     the device time per call and the share of the split-TF32 bound, and
     beside it, as context, the device time of the tail's two products as
     f32 `torch.matmul` (TF32 off) on the same shapes; then phase 8's two
     recorded K8 calls cast to f32 through K8's f32 instance, held against
     the plain version computed in f64 within the larger of 1e-5 and twice
     the f32 plain version's own distance, one `[shape
     resize_conv_relu_f32]` line per call;
 12. the AV training step at full width in f32 (both packages' default),
     B=4, phase 6's recipe: one warm-up step with phase 6's checks, one
     step counted against `f32_launches(cfg, train=True)` (K1 f32 and K5
     f32 16 times each), then ten timed steps (ms per step by CUDA events,
     each step's and the window's), one step's device events summed and as
     the device's busy time (the union of their intervals: overlapping
     kernels count once), the f32 backward's and the convolutions' busy
     time as shares of it and of the step, K6's device time in the step,
     the step's top CUDA kernels and peak memory;
then prints the `kernels` JSON line, the nvidia-smi line and, last, the
result line {"ok": true, "device": {...}}. The f32 instances' bound takes
their matrix products at split TF32's rate (495 / 3 TFLOP/s: f32's accuracy
on the tensor cores); K7 adds one `[shape ...]` line per (Bt, L, C).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM
BF16_TENSOR_FLOPS = 989e12      # dense bf16 tensor cores
F32_FLOPS = 67e12               # f32 outside the tensor cores
# f32 products at f32's accuracy on the tensor cores: split TF32 (three TF32
# products per product, 495 TFLOP/s dense TF32), the fastest route to them
SPLIT_TF32_FLOPS = 495e12 / 3
B = 2
B_TRAIN = 4
TRAIN_ITERS = 5  # timed training steps
VISUAL_TRAIN_ITERS = 2  # timed visual-only steps per turn, four turns
LAYOUTS = ("cls_stream", "token_concat")
# phase 9: the two layouts' bf16 gradients at random weights differ as two
# bf16 runs do. The same comparison on the CPU at 64x96 through the plain
# versions (tests/test_torch_visual_only.py::
# test_bf16_layouts_give_the_same_step_on_the_cpu) reads cosine 0.978
# (MViT) and 0.983 (decoder); phase 7 holds the card to 0.9 likewise
LAYOUT_GRAD_COS = 0.9
DEVICE = "cuda"
INFER_KERNELS = ("bias_attention", "layer_norm", "block_tail", "bilinear_resize_sum")
KERNELS = INFER_KERNELS + ("bias_attention_bwd", "layer_norm_bwd", "cvt_attention",
                           "resize_conv_relu", "resize_phase_head", "bilinear_resize_add",
                           "depthwise_pool3d", "fused_bias_attention",
                           "fused_bias_attention_bwd")
# the f32 instances (an f32 model's route), each a row of its own
F32_KERNELS = ("bias_attention_f32", "block_tail_f32", "cvt_attention_f32",
               "fused_bias_attention_f32", "bias_attention_bwd_f32",
               "fused_bias_attention_bwd_f32", "resize_conv_relu_f32")
KERNELS += F32_KERNELS
TRAIN_KERNELS = ("bias_attention_bwd", "layer_norm_bwd")
# the pooled attention (K1, K12 forward, K5, K12 backward), timed per MViT
# block shape
ATTENTION = ("bias_attention", "fused_bias_attention", "bias_attention_bwd",
             "fused_bias_attention_bwd")
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 0.0)}  # (atol, rtol)
# bf16: kernel and plain version round the same f32 values at other points
# and may differ by one bf16 ulp of the output, which atol + rtol*|x| covers.
# phase 10: f32 on the card against f32 on the CPU, the port-vs-JAX
# per-network tolerance of PERF.md on the [0, 1] map, and per gradient
# tensor the relative L2 that two f32 implementations may differ by at
# random weights (1.3e-3 measured between the port and JAX, PERF.md)
F32_MAP_TOL = 1e-4
F32_GRAD_TOL = 1e-2


def main_config():
    from diff_sal_tpu_torch.config import ModelConfig

    return ModelConfig.audio_visual(compute_dtype="bfloat16")


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Recorder:
    """Wraps an op module's kernel wrapper so that, while `on`, every call
    keeps a copy of its arguments. The wrapper itself still counts its
    launches."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []
        self.on = False
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        if self.on:
            self.calls.append(_clone((args, kw)))
        return self.fn(*args, **kw)


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        # same strides: a column slice of a wider tensor stays one
        return torch.empty_strided(obj.shape, obj.stride(), dtype=obj.dtype,
                                   device=obj.device).copy_(obj.detach())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    return obj


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_terms(kernel: str, args, kw):
    """(bytes, [(operations, peak rate of their type), ...]) one call must
    at least move and compute: elementwise work at the CUDA cores' f32
    rate, matrix products at the bf16 tensor cores' rate, an f32
    instance's at split TF32's (f32's accuracy on the tensor cores)."""
    e = args[0].element_size() if isinstance(args[0], torch.Tensor) else 2
    mm_peak = BF16_TENSOR_FLOPS if e == 2 else SPLIT_TF32_FLOPS
    kernel = kernel.removesuffix("_f32")
    if kernel == "bias_attention":
        q, k, v, rel, (kt, kh, kw_), H = args[:6]
        Bq, Lq, HD = q.shape
        Lk = k.shape[1]
        nbytes = (2 * q.numel() + 2 * k.numel() + rel.numel()) * e
        return nbytes, [(4.0 * Bq * Lq * Lk * HD, mm_peak)]
    if kernel == "layer_norm":
        x, w, b = args[:3]
        C = x.shape[-1]
        return 2 * x.numel() * x.element_size() + 2 * C * 4, [(8.0 * x.numel(), F32_FLOPS)]
    if kernel == "block_tail":
        skip, attn, lw, lb, w1, b1, w2, b2 = args[:8]
        R, C = skip.shape
        Hd = w1.shape[0]
        nbytes = 3 * R * C * e + 2 * C * Hd * e + (3 * C + Hd) * 4
        return nbytes, [(4.0 * R * C * Hd, mm_peak)]
    if kernel == "bilinear_resize_sum":
        xs, (H, W) = args[:2]
        out = xs[0].shape[0] * H * W * xs[0].shape[-1]
        nbytes = sum(x.numel() for x in xs) * xs[0].element_size() + out * xs[0].element_size()
        return nbytes, [(8.0 * len(xs) * out, F32_FLOPS)]
    if kernel == "fused_bias_attention":
        # read q, k, v and the three f32 bias terms, write out
        q, k, v, rt, rh, rw = args[:6]
        BH, Lq, D = q.shape
        nbytes = e * (2 * q.numel() + 2 * k.numel()) + 4 * (rt.numel() + rh.numel() + rw.numel())
        return nbytes, [(4.0 * BH * Lq * k.shape[1] * D, mm_peak)]
    if kernel == "fused_bias_attention_bwd":
        # read q, g, k, v, the bias terms and the forward's logsumexp, write
        # dq, dk, dv and the f32 bias gradients; five (Lq, Lk, D) products
        # per head
        q, k, v, rt, rh, rw = args[:6]
        BH, Lq, D = q.shape
        nbytes = (e * (3 * q.numel() + 4 * k.numel()) + 8 * (rt.numel() + rh.numel() + rw.numel())
                  + 4 * BH * Lq)
        return nbytes, [(10.0 * BH * Lq * k.shape[1] * D, mm_peak)]
    if kernel == "bilinear_resize_add":
        # read acc and x, write out; 4 taps per output element in f32
        acc, x = args[:2]
        return ((2 * acc.numel() * acc.element_size() + x.numel() * x.element_size()),
                [(8.0 * acc.numel(), F32_FLOPS)])
    if kernel == "bias_attention_bwd":
        # read q, g, k, v, rel and the forward's f32 logsumexp; write dq, dk,
        # dv, drel; five (Lq, Lk, D) products per head (S, dP, dV, dQ, dK)
        q, k, v, rel, g, _, H = args[:7]
        Bq, Lq, HD = q.shape
        nbytes = e * (3 * q.numel() + 4 * k.numel() + 2 * rel.numel()) + 4 * Bq * H * Lq
        return nbytes, [(10.0 * Bq * Lq * k.shape[1] * HD, mm_peak)]
    if kernel == "layer_norm_bwd":
        x, g, w = args[:3]
        return (3 * x.numel() * x.element_size() + 3 * w.numel() * 4,
                [(12.0 * x.numel(), F32_FLOPS)])
    if kernel == "cvt_attention":
        # read q, k, v, write out; q k^T and p v
        q, k = args[:2]
        Bt, L, C = q.shape
        return e * (2 * q.numel() + 2 * k.numel()), [(4.0 * Bt * L * k.shape[1] * C, mm_peak)]
    if kernel == "depthwise_pool3d":
        # read the C used channels of the input pixels some tap touches
        # once (at stride 8 a 3-tap window reads 3 of every 8 rows and
        # columns), w, write out; 27 f32 multiply-adds per output element
        x, w, (_, sh, sw) = args[:3]
        B, T, H, W, C = x.shape
        rows, cols = pool_touched(H, sh), pool_touched(W, sw)
        out = B * T * ((H - 1) // sh + 1) * ((W - 1) // sw + 1) * C
        return ((B * T * rows * cols * C + out) * x.element_size() + w.numel() * 4,
                [(54.0 * out, F32_FLOPS)])
    if kernel in ("resize_conv_relu", "resize_phase_head"):
        xs, (H, W), kern, bias = args[:4]
        B, C, O = xs[0].shape[0], xs[0].shape[-1], kern.shape[-1]
        e = xs[0].element_size()
        nbytes = (sum(x.numel() for x in xs) + kern.numel() + B * H * W * O) * e + O * 4
        if kernel == "resize_conv_relu":
            # the 3x3 conv on the tensor cores (the f32 instance's at split
            # TF32's rate), the resize-sum (4 taps per input element) in f32
            return nbytes, [(2.0 * B * H * W * 9 * C * O,
                             BF16_TENSOR_FLOPS if e == 2 else SPLIT_TF32_FLOPS),
                            (8.0 * len(xs) * B * H * W * C, F32_FLOPS)]
        # u_i = x_i K' on the tensor cores, then the separable form's f32
        # work: per task the dy contraction once per (output row, input
        # column, dx) over the live row taps, the dx contraction once per
        # output over the live column taps; bias and ReLU
        from diff_sal_tpu_torch.ops import resize

        shapes = tuple((x.shape[1], x.shape[2]) for x in xs)
        _, wts = resize._phase_arrays(shapes, (H, W), xs[0].dtype)
        sep = 2.0 * H * W
        for k, (_, w) in enumerate(shapes):
            live = (wts[k] != 0).sum(0)  # live taps per table entry
            sep += 2.0 * 3 * w * live[:3 * H].sum() + 2.0 * H * live[3 * H:].sum()
        mm = sum(2.0 * B * x.shape[1] * x.shape[2] * C * 9 * O for x in xs)
        return nbytes, [(mm, BF16_TENSOR_FLOPS), (B * O * sep, F32_FLOPS)]
    raise KeyError(kernel)


def phase_gather_terms(args):
    """K9's operations as first counted: the products and the
    per-output-pixel gather, every output recomputing its dy contraction
    per column tap; kept beside the separable count so that shares of the
    first bound stay comparable."""
    from diff_sal_tpu_torch.ops import resize

    xs, (H, W), kern = args[:3]
    B, C, O = xs[0].shape[0], xs[0].shape[-1], kern.shape[-1]
    _, wts = resize._phase_arrays(tuple((x.shape[1], x.shape[2]) for x in xs), (H, W),
                                  xs[0].dtype)
    gather = 0.0
    for k in range(len(xs)):
        nz = (wts[k] != 0).sum(0).astype(np.float64)  # non-zero taps per table entry
        rows = 2.0 + 2.0 * nz[:3 * H].reshape(3, H).sum(0)
        cols = nz[3 * H:].reshape(3, W).sum(0)
        gather += float(rows.sum() * cols.sum())
    mm = sum(2.0 * B * x.shape[1] * x.shape[2] * C * 9 * O for x in xs)
    return [(mm, BF16_TENSOR_FLOPS), (B * O * (gather + 2.0 * H * W), F32_FLOPS)]


def pool_touched(n: int, s: int) -> int:
    """How many of n input rows (or columns) a 3-tap window at stride s,
    padding 1, touches."""
    return len({o * s + k for o in range((n - 1) // s + 1) for k in (-1, 0, 1)} & set(range(n)))


def pool_full_read_bytes(args) -> int:
    """K11's bytes bound as it was first counted: all of x read once."""
    x, w, (_, sh, sw) = args[:3]
    B, T, H, W, C = x.shape
    out = B * T * ((H - 1) // sh + 1) * ((W - 1) // sw + 1) * C
    return (x.numel() + out) * x.element_size() + w.numel() * 4


def attention_plan(name, args):
    """The launch plan of K1 or K12 forward (rows per CTA, keys per tile,
    stages, shared-memory bytes; f32: rows, keys per tile, key splits,
    shared-memory bytes) or of their backward (query splits, q-major and k-major CTAs,
    their shared-memory bytes; f32: rows per q-major CTA, query splits,
    q-major and k-major CTAs, their shared-memory bytes) for these
    arguments."""
    from diff_sal_tpu_torch.ops import attention

    q, k = args[:2]
    B, Lq, HD = q.shape
    base = name.removesuffix("_f32")
    k_shape, H = {"bias_attention": (args[4], args[5]), "fused_bias_attention": (args[6], 1),
                  "bias_attention_bwd": (args[5], args[6]),
                  "fused_bias_attention_bwd": (args[7], 1)}[base]
    if name.endswith("_bwd_f32"):
        p = attention.f32_bwd_plan(B, H, Lq, k.shape[1], HD // H, tuple(k_shape))
        return p.q_rows, p.splits, p.q_ctas, p.k_ctas, p.smem_q, p.smem_k
    if name.endswith("_f32"):
        p = attention.f32_fwd_plan(B, H, Lq, k.shape[1], HD // H, tuple(k_shape))
        return p.rows, p.block_n, p.splits, p.smem
    if name.endswith("_bwd"):
        p = attention.bwd_plan(B, H, Lq, k.shape[1], HD // H, tuple(k_shape))
        return p.splits, p.q_ctas, p.k_ctas, p.smem_q, p.smem_k
    p = attention.fwd_plan(B, H, Lq, k.shape[1], HD // H, tuple(k_shape))
    return p.rows, p.block_n, p.stages, p.smem


def library_call(name, args, kw):
    """The one PyTorch call that computes the same function on the same
    inputs, as a thunk for timing, or None. Timed only, never on the path."""
    F = torch.nn.functional
    name = name.removesuffix("_f32")  # an f32 instance: the same call in f32
    if name == "layer_norm":
        x, w, b = args[:3]
        eps = args[3] if len(args) > 3 else kw.get("eps", 1e-6)
        w, b = w.to(x.dtype), b.to(x.dtype)
        return lambda: F.layer_norm(x, (x.shape[-1],), w, b, eps)
    if name == "layer_norm_bwd":
        x, g, w = args[:3]
        eps = args[3] if len(args) > 3 else kw.get("eps", 1e-6)
        xg = x.detach().requires_grad_()
        wg = w.to(x.dtype).detach().requires_grad_()
        bg = torch.zeros_like(wg, requires_grad=True)
        out = F.layer_norm(xg, (x.shape[-1],), wg, bg, eps)
        return lambda: torch.autograd.grad(out, (xg, wg, bg), g, retain_graph=True)
    if name == "cvt_attention":
        q, k, v, heads, scale = args[:5]
        q4, k4, v4 = (t.reshape(t.shape[0], t.shape[1], heads, -1).transpose(1, 2)
                      for t in (q, k, v))
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
    if name == "depthwise_pool3d":
        # cuDNN's grouped conv3d on an NCDHW copy made beforehand
        x, w, stride = args[:3]
        xc = x.permute(0, 4, 1, 2, 3).contiguous()
        wc = w.to(x.dtype).permute(3, 0, 1, 2)[:, None].contiguous()
        return lambda: F.conv3d(xc, wc, None, stride, 1, 1, x.shape[-1])
    if name in ("bias_attention", "bias_attention_bwd"):
        # (B, L, H*D) with the packed (B, Lq, H, kt+kh+kw) bias terms
        q, k, v, rel = args[:4]
        k_shape, H, scale = args[5:8] if name == "bias_attention_bwd" else args[4:7]
        Bq, Lq, HD = q.shape
        kt, kh, _ = k_shape
        heads = [t.reshape(Bq, -1, H, HD // H).transpose(1, 2) for t in (q, k, v)]
        r = rel.float().permute(0, 2, 1, 3)
        parts = (r[..., :kt], r[..., kt:kt + kh], r[..., kt + kh:])
        g = args[4].reshape(Bq, Lq, H, -1).transpose(1, 2) if name.endswith("_bwd") else None
        return _sdpa_call(heads, parts, k_shape, scale, g)
    if name in ("fused_bias_attention", "fused_bias_attention_bwd"):
        # (BH, L, D) per head with three f32 bias terms
        bwd = name.endswith("_bwd")
        k_shape, scale = args[7:9] if bwd else args[6:8]
        heads = [t[:, None] for t in args[:3]]
        parts = [t[:, None].float() for t in args[3:6]]
        return _sdpa_call(heads, parts, k_shape, scale, args[6][:, None] if bwd else None)
    return None


def _sdpa_call(heads, parts, k_shape, scale, g=None):
    """SDPA on q, k, v (N, H, L, D) with the dense float bias built from the
    t, h and w terms (N, H, Lq, k*), zero for key 0 (no residual): the
    forward, or with g the backward with the bias gradient reduced to the
    three terms' sums. The bias is stored with its last axis padded to 16
    elements, as the memory-efficient backend wants."""
    F = torch.nn.functional
    q, k, v = heads
    N, H, Lq, _ = q.shape
    Lk = k.shape[2]
    rt, rh, rw = parts
    bias = (rt[..., :, None, None] + rh[..., None, :, None] + rw[..., None, None, :])
    bias = F.pad(bias.reshape(N, H, Lq, -1), (1, 0))
    if g is None:
        bias = bias.to(q.dtype).contiguous()
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)
    store = torch.zeros((N, H, Lq, -(-Lk // 16) * 16), dtype=q.dtype, device=q.device)
    store[..., :Lk] = bias
    store.requires_grad_()
    ins = [t.detach().requires_grad_() for t in heads]
    out = F.scaled_dot_product_attention(*ins, attn_mask=store[..., :Lk], scale=scale)

    def bwd():
        *_, db = torch.autograd.grad(out, ins + [store], g, retain_graph=True)
        d5 = db[..., 1:Lk].reshape(N, H, Lq, *k_shape)
        return d5.sum((4, 5)), d5.sum((3, 5)), d5.sum((3, 4))
    return bwd


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


def _tolerance(name: str, i: int, ref: torch.Tensor, args):
    """(atol, rtol) of output i: the working dtype's; for K6's f32
    parameter gradients, sums over up to ~10^5 rows taken in another
    order, 1e-5 of the sum of the terms' magnitudes per channel (which
    bounds f32 rounding even where the terms cancel to ~0) and 1e-4
    relative."""
    if name == "fused_bias_attention_bwd" and i >= 3:
        # K12's f32 bias gradients, summed from dS as bf16 hi + lo parts on
        # the tensor cores: the bf16 outputs' bound
        return TOL[torch.bfloat16]
    if name == "layer_norm_bwd" and i > 0:
        x, g = args[0], args[1]
        C = x.shape[-1]
        xf, gf = x.reshape(-1, C).float(), g.reshape(-1, C).float()
        if i == 1:
            mean = xf.mean(-1, keepdim=True)
            var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
            gf = gf * (xf - mean) * torch.rsqrt(var + 1e-6)
        mag = gf.abs().sum(0)[:ref.shape[0]]
        return 1e-5 * mag, 1e-4
    return TOL[ref.dtype]


# device_ms's sessions: how many ran, how many lost events in their
# prologue (absorbed there), and how many were run again
DEVICE_MS_TALLY = {"sessions": 0, "prologue_lost": 0, "retried": 0}
PROLOGUE_SPINS = 8


def device_ms(thunks, attempts: int = 24):
    """The profiler's device time (ms) of the thunks and the number of their
    device events: `device_events` summed."""
    events = device_events(thunks, attempts)
    return sum(e.time_range.elapsed_us() for e in events) / 1e3, len(events)


def busy_ms(events):
    """The time (ms) in which at least one of the device events ran: the
    union of their intervals, so that overlapping kernels count once."""
    busy, stop = 0.0, -float("inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if b > stop:
            busy += b - max(a, stop)
            stop = b
    return busy / 1e3


def device_events(thunks, attempts: int = 24):
    """The profiler's device events of the thunks, each run once: every
    CUDA kernel, memcpy and memset they issue, so that summed, a cast or a
    workspace fill inside a wrapper counts against its kernel. On the card
    the tracer loses the first device events of a session now and then: the
    first three, or all of them. So a session first gives it a prologue to
    lose, ~1 ms of spinning (`torch.cuda._sleep`) and PROLOGUE_SPINS short
    spins, waited for; then it runs the thunks three times, each pass
    followed by a short spin on the same stream, and one more spin after.
    Counted back from that last pair, the second pass is taken when its
    window and the third's hold the same number of events; else the session
    is run again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        DEVICE_MS_TALLY["sessions"] += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.2)
            torch.cuda._sleep(2_000_000)
            for _ in range(PROLOGUE_SPINS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(3):
                for f in thunks:
                    f()
                torch.cuda._sleep(1000)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA and e.time_range.start >= 0),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        if len(marks) < PROLOGUE_SPINS + 5:
            DEVICE_MS_TALLY["prologue_lost"] += 1
        if len(marks) >= 4 and marks[-1] == marks[-2] + 1:
            second = events[marks[-4] + 1:marks[-3]]
            if second and len(second) == marks[-2] - marks[-3] - 1:
                return second
        DEVICE_MS_TALLY["retried"] += 1
        log(f"[device time] the profiler dropped events ({len(marks)} of "
            f"{PROLOGUE_SPINS + 5} spins traced); measuring again")
    raise AssertionError(f"the profiler dropped events in {attempts} sessions in a row")


def shape_key(name, args):
    """The calls of a kernel grouped for the per-shape lines: attention by
    (q shape, k shape, launch plan), LayerNorm and its backward by (rows, C,
    bulk path), the block tail by (R, C), K7 by (Bt, L, C); other kernels
    form one group."""
    base = name.removesuffix("_f32")
    if base in ATTENTION:
        return tuple(args[0].shape), tuple(args[1].shape), attention_plan(name, args)
    if base in ("layer_norm", "layer_norm_bwd"):  # and whether the bulk path takes it
        x = args[0]
        C = x.shape[-1]
        aligned = all(t.data_ptr() % 16 == 0 for t in args[:1 + (base == "layer_norm_bwd")])
        return x.numel() // C, C, C * x.element_size() % 16 == 0 and aligned
    if base == "block_tail":
        return tuple(args[0].shape)
    if base == "cvt_attention":
        return tuple(args[0].shape)
    if base == "depthwise_pool3d":
        x, _, stride = args[:3]
        return tuple(x.shape[:4]), x.shape[4], tuple(stride)
    if base == "resize_conv_relu":
        xs, out_hw, kern = args[:3]
        return tuple(out_hw), xs[0].shape[-1], kern.shape[-1], len(xs)
    if base in ("bilinear_resize_sum", "resize_phase_head"):
        # with the separable plan's (band, chunk, column tile, CTAs)
        from diff_sal_tpu_torch.ops import resize

        xs, (H, W) = args[:2]
        shapes = tuple((x.shape[1], x.shape[2]) for x in xs)
        B, C, dt = xs[0].shape[0], xs[0].shape[-1], xs[0].dtype
        if base == "bilinear_resize_sum":
            p = resize.resize_plan(B, H, W, C, shapes, dt)
        else:
            C = args[2].shape[-1]
            p = resize.phase_plan(B, H, W, shapes, C, dt)
        return (B, H, W), C, shapes, (p.bh, p.cc, p.tw, p.ctas)
    return None


# what the key of a `[shape ...]` line lists
SHAPE_LABEL = {"layer_norm": "(rows, C, bulk)", "layer_norm_bwd": "(rows, C, bulk)",
               "block_tail": "(rows, C)",
               "cvt_attention": "(Bt, L, C)",
               "depthwise_pool3d": "((B, T, H, W), C, stride)",
               "resize_conv_relu": "(out_hw, C, O, inputs)",
               "bilinear_resize_sum": "((B, H, W), C, inputs, plan (bh, cc, tw, CTAs))",
               "resize_phase_head": "((B, TH, TW), O, tasks, plan (bh, cc, tw, CTAs))"}


# f32 instances held against their plain version computed in f64, within
# the larger of the f32 tolerance and twice the f32 plain version's own
# distance from it: K8's plain version is one f32 conv2d, and the algorithm
# cuDNN picks for it on the card sits further from f64 (2.4e-5 at the head's
# C = 768) than the kernel does
F64_HELD = ("resize_conv_relu_f32",)


def hold_f64(name, out, plain_fn, args, kw):
    """Holds `out` (an f32 kernel's output on args) against plain_fn
    computed in f64 within max(f32 tolerance, twice the f32 plain version's
    own distance from it); returns (max|d|, the plain version's)."""
    def dbl(v):
        if isinstance(v, torch.Tensor):
            return v.double()
        if isinstance(v, (list, tuple)):
            return type(v)(dbl(t) for t in v)
        return v
    ref = plain_fn(*dbl(args), **kw).double()
    own = float((plain_fn(*args, **kw).double() - ref).abs().max())
    d = float((out.double() - ref).abs().max())
    torch.cuda.synchronize()
    limit = max(TOL[torch.float32][0], 2 * own)
    assert out.shape == ref.shape and d <= limit, (
        f"{name}: kernel output at shape {tuple(out.shape)} {d:.3e} from the plain version "
        f"in f64, limit {limit:.3e} (the f32 plain version {own:.3e})")
    return d, own


def hold_kernels(names, recorders, plain, counts, profile=False):
    """Each recorded call of each kernel against its plain version, with
    the kernel's, the plain version's and the library call's times (CUDA
    events, and the profiler's device time) and the least time the card
    could take; returns the `kernels` rows. Per shape group (`shape_key`)
    one line of ms per call, device time and share of the bound. With
    `profile`, also the device time of each attention kernel's recorded
    calls by CUDA kernel (the backward is four)."""
    from diff_sal_tpu_torch.ops import kernels

    rows = []
    for name in names:
        rec = recorders[name]
        assert rec.calls, name
        err = kern_ms = plain_ms = lib_ms = 0.0
        t_bytes = t_ops = 0.0
        has_lib = False
        # shape key -> calls, kernel thunks, library thunks, event ms, library
        # event ms, bound ms
        groups = {}
        full_x = {}  # K11: the bytes bound reading all of x, per shape group (ms)
        for args, kw in rec.calls:
            got = _outputs(rec.fn(*args, **kw))
            if name in F64_HELD:
                err = max(err, hold_f64(name, got[0], plain[name], args, kw)[0])
                ref = got = ()
            else:
                ref = _outputs(plain[name](*args, **kw))
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(got, ref)):
                atol, rtol = _tolerance(name, i, b, args)
                diff = (a.float() - b.float()).abs()
                bad = diff > atol + rtol * b.float().abs()
                assert a.shape == b.shape and not bool(bad.any()), (
                    f"{name}: kernel output {i} disagrees with its plain version at shape "
                    f"{tuple(a.shape)}: max|d| {float(diff.max()):.3e}")
                err = max(err, float(diff.max()))
            del got, ref

            def call(args=args, kw=kw):
                rec.fn(*args, **kw)

            call_ms = cuda_ms(call)
            kern_ms += call_ms
            plain_ms += cuda_ms(lambda: plain[name](*args, **kw), reps=3, warmup=1)
            lib = library_call(name, args, kw)
            call_lib = None
            if lib is not None:
                has_lib = True
                call_lib = cuda_ms(lib)
                lib_ms += call_lib
            nbytes, ops = bound_terms(name, args, kw)
            t_bytes += nbytes / HBM_BYTES_PER_S * 1e3
            t_ops += sum(n / peak for n, peak in ops) * 1e3
            g = groups.setdefault(shape_key(name, args), [0, [], [], 0.0, 0.0, 0.0])
            g[0] += 1
            g[1].append(call)
            if lib is not None:
                g[2].append(lib)
            g[3] += call_ms
            g[4] += call_lib or 0.0
            g[5] += max(nbytes / HBM_BYTES_PER_S, sum(n / p for n, p in ops)) * 1e3
            if name == "depthwise_pool3d":
                key = shape_key(name, args)
                full_x[key] = full_x.get(key, 0.0) + max(
                    pool_full_read_bytes(args) / HBM_BYTES_PER_S,
                    sum(n / p for n, p in ops)) * 1e3
        dev_ms = lib_dev_ms = 0.0
        dev_events = 0
        for key, g in groups.items():
            ms, n_ev = device_ms(g[1])
            lms = device_ms(g[2])[0] if g[2] else None
            g.extend([ms, lms])
            dev_ms += ms
            dev_events += n_ev
            lib_dev_ms += lms or 0.0
        kern = kernels.registry()[name]
        bound = max(t_bytes, t_ops)
        extra = {}
        if name == "resize_phase_head":
            first = max(t_bytes, sum(sum(n / p for n, p in phase_gather_terms(a)) * 1e3
                                   for a, _ in rec.calls))
            extra["bound_ms_first_count"] = first
            log(f"[kernel {name}] bound as first counted (every output recomputes its dy "
                f"contraction) {first:.4f} ms, {100.0 * first / dev_ms:.1f}% of it by device time")
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"diff_sal_tpu_torch/csrc/{kern.source}",
            "replaces": kern.replaces.split()[0],
            "launches": counts[kern.name],
            "max_abs_err": err,
            "ms": kern_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms if has_lib else None,
            "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms if has_lib else None,
            **extra,
        })
        log(f"[kernel {name}] {len(rec.calls)} calls per run: kernel {kern_ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, library {lib_ms if has_lib else None}, "
            f"bound {bound:.3f} ms (bytes {t_bytes:.3f}, ops {t_ops:.3f}), "
            f"max|d| {err:.3e}; device (profiler) kernel {dev_ms:.4f} ms ({dev_events} device "
            f"events), library {lib_dev_ms if has_lib else None}, "
            f"{100.0 * bound / dev_ms:.1f}% of bound by device time")
        if profile and name in ATTENTION:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as profiler

            with profiler(activities=[ProfilerActivity.CUDA]) as prof:
                for args, kw in rec.calls:
                    rec.fn(*args, **kw)
                torch.cuda.synchronize()
            log(f"[profile {name}] the {len(rec.calls)} recorded calls once, device time by "
                "CUDA kernel")
            log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8))
        for key, (n, _, _, ms, lms, bound, dms, ldms) in groups.items():
            if name.removesuffix("_f32") in ATTENTION:
                qs, ks, plan = key
                log(f"[block {name}] q {qs} k {ks} plan {plan}: {n} calls, kernel {ms / n:.4f} "
                    f"ms, SDPA {lms / n:.4f} ms, bound {bound / n:.4f} ms (operations), "
                    f"{100.0 * bound / ms:.1f}% of bound, SDPA / kernel {lms / ms:.2f}; device "
                    f"{1e3 * dms / n:.2f} us per call ({100.0 * bound / dms:.1f}% of bound), "
                    f"SDPA {1e3 * ldms / n if ldms else 0.0:.2f} us")
            elif key is not None:
                lib_us = f"{1e3 * ldms / n:.2f} us" if ldms is not None else "none"
                old = (f"; reading all of x {1e3 * full_x[key] / n:.2f} us, "
                       f"{100.0 * full_x[key] / dms:.1f}%" if key in full_x else "")
                log(f"[shape {name}] {SHAPE_LABEL[name.removesuffix('_f32')]} {key}: {n} calls, "
                    f"device {1e3 * dms / n:.2f} us "
                    f"per call, bound {1e3 * bound / n:.2f} us per call, "
                    f"{100.0 * bound / dms:.1f}% of bound{old}; events {ms / n:.4f} ms per call; "
                    f"library device {lib_us} per call")
        if full_x:
            tot = sum(full_x.values())
            log(f"[kernel {name}] bound reading all of x (as first counted) {tot:.3f} ms, "
                f"{100.0 * tot / dev_ms:.1f}% of it by device time")
        rec.calls.clear()
    return rows


def grad_agreement(got, ref):
    """Relative L2 and cosine of gradient dicts, per sub-network and over
    all, and the worst per-tensor relative L2 (tensors whose reference is
    zero up to rounding left out)."""
    top = max(float(v.abs().max()) for v in ref.values())
    names = [n for n in ref if float(ref[n].abs().max()) > 1e-6 * top]
    stats = {}
    for sub in ("visual_net", "spatiotemp_net", "decoder_net", "all"):
        ns = [n for n in names if sub == "all" or n.startswith(sub + ".")]
        if not ns:  # the visual-only model has no audio branch
            continue
        a = torch.cat([got[n].flatten() for n in ns])
        b = torch.cat([ref[n].flatten() for n in ns])
        stats[sub] = (float((a - b).norm() / b.norm()),
                      float(torch.nn.functional.cosine_similarity(a, b, dim=0)))
    worst = max(((float((got[n] - ref[n]).norm() / ref[n].norm()), n) for n in names))
    return stats, worst


def first_train_step(tstep, opt, batch, gen, params, what, t0):
    """The AV model's first training step from fresh weights, and phase 6's
    checks: finite loss and gradient norm, a finite gradient on every
    trainable parameter on the graph, non-zero gradients in MViT,
    AudioAttnNet and the decoder, none on the frozen VGGish, parameters
    moved."""
    before = {n: p.detach().clone() for n, p in params.items()}
    m0 = tstep(opt, batch, gen)
    torch.cuda.synchronize()
    log(f"[{what}] model built, first step in {time.perf_counter() - t0:.1f} s: "
        + json.dumps({k: float(v) for k, v in m0.items()}))
    loss0, gn0 = float(m0["total"]), float(m0["grad_norm"])
    assert np.isfinite(loss0) and loss0 > 0 and np.isfinite(gn0) and gn0 > 0, (loss0, gn0)
    # the finest pyramid scale is never read by the decoder (reference
    # quirk), so its norm is the one trainable module off the graph
    off_graph = {n for n, p in params.items() if p.requires_grad and p.grad is None}
    assert off_graph == {"visual_net.norm0.weight", "visual_net.norm0.bias"}, off_graph
    for n, p in params.items():
        if n.startswith("audio_net."):
            assert p.grad is None and not p.requires_grad and torch.equal(p, before[n]), n
        elif p.grad is not None:
            assert bool(torch.isfinite(p.grad).all()), n
    for sub in ("visual_net", "spatiotemp_net", "decoder_net"):
        assert any(p.grad is not None and float(p.grad.abs().max()) > 0
                   for n, p in params.items() if n.startswith(sub + ".")), sub
    moved = sum(not torch.equal(p, before[n]) for n, p in params.items() if p.requires_grad)
    assert moved > 0.9 * len(opt.params), (moved, len(opt.params))
    log(f"[{what}] {moved} of {len(opt.params)} trainable tensors moved in the first step")


def lowered_config(cfg):
    """`cfg` with the three eval lowerings: the MViT pools through K11, the
    CvT attention through K7 and the head as conv-at-low-res through K9."""
    return dataclasses.replace(
        cfg, visual=dataclasses.replace(cfg.visual, pool_mode="pallas"),
        decoder=dataclasses.replace(cfg.decoder, fused_attn=True, head_lowres=True))


def path_launches(cfg, nfe: int = 1, train: bool = False, fused_head: bool = False):
    """Launches of each kernel in one `sample_saliency` run of `cfg` with
    `nfe` denoiser calls, or (`train`) in one training step, from the
    config's structure: the encoders run once per map or step, the decoder
    once per call; the eval lowerings (K3, K7, K8, K9) at eval only. With
    `fused_head` (the head module's field, which no config sets) the head
    runs through K8 unless `head_lowres` takes it through K9."""
    from diff_sal_tpu_torch.models.mvit import block_plan

    v, d = cfg.visual, cfg.decoder
    stages = d.mid_num_stages  # one TransformerBlock each
    calls = 1 if train else nfe
    # MViT: norm1 and norm2 on the spatial and on the cls rows, norm_q/k/v,
    # one norm per emitted scale; AudioAttnNet (AV model only): two per
    # layer and a final one; the decoder per call: each block's norm and
    # its q, k and v token norms, one per stage output, and norm2, which
    # runs inside K3 at eval
    audio = 2 * cfg.spatiotemp.depth + 1 if cfg.spatiotemp is not None else 0
    ln = (7 * v.num_layers + len(v.out_scales) + audio
          + calls * (6 if train else 5) * stages)
    # one pool per block where q and kv share a stride, else a q and a kv
    # pool; K11 only with the cls stream (the token-concat layout pools by
    # convolution, as in JAX)
    pools = sum(1 if p["stride_q"] == p["stride_kv"] else 2 for p in block_plan(v))
    attn = "bias_attention" if v.cls_stream else "fused_bias_attention"
    want = {name: 0 for name in KERNELS}
    want.update({attn: v.num_layers, "layer_norm": ln,
                 "depthwise_pool3d": pools if v.pool_mode == "pallas" and v.cls_stream else 0})
    if train:
        # every MViT block's attention and every LayerNorm backward, except
        # two norms off the graph: the finest pyramid scale's (the decoder
        # never reads it) and the last block's norm2 of the cls row (its
        # output is never read); the resize-sum's backward is plain math
        want.update({attn + "_bwd": v.num_layers, "layer_norm_bwd": ln - 2,
                     "bilinear_resize_sum": 1})
    else:
        k8 = fused_head and not d.head_lowres
        want.update({"block_tail": nfe * stages,
                     "bilinear_resize_sum": 0 if d.head_lowres or k8 else nfe,
                     "resize_phase_head": nfe if d.head_lowres else 0,
                     "resize_conv_relu": nfe if k8 else 0,
                     "cvt_attention": nfe * stages if d.fused_attn else 0})
    return want


def check_launches(counts, want, what: str):
    bad = {n: (counts[n], k) for n, k in want.items() if counts[n] != k}
    assert not bad, f"{what}: launches (got, expected) {bad}"


def dpm_sampling(nfe: int):
    """bench.py's DPM-Solver++ sweep settings (multistep, order 2, logSNR
    spacing, denoise to zero): `nfe` denoiser calls per map."""
    from diff_sal_tpu_torch.config import SamplingConfig

    return SamplingConfig(sample_type="dpmsolver++", timesteps=nfe, dpm_solver_method="multistep",
                          dpm_solver_order=2, skip_type="logSNR")


def dpm_phase(cli, dev, schedule, data_cfg, recorders, plain, kind, smi, full_calls):
    """Phase 8: `sample_saliency` with DPM-Solver++ 2M at NFE 2 and 5 on
    the full-width AV model with the three eval lowerings; launch counts
    per run, the K8 head variant, the maps against the default lowerings,
    timing, each new kernel against its plain version, and the small model
    against the CPU. Returns the `kernels` rows of K7, K8, K9 and K11."""
    from diff_sal_tpu_torch.config import (AudioAttnConfig, ModelConfig, MViTConfig,
                                           SalUNetConfig, VGGishConfig)
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel, build_model
    from diff_sal_tpu_torch.ops import kernels

    cfg = lowered_config(main_config())
    model = build_model(cfg, seed=0, device=dev)
    # the flags change no parameter: the default lowerings' model, same weights
    model_d = VideoSaliencyModel(main_config()).eval()
    model_d.load_state_dict(model.state_dict())
    model_d.to(dev)
    head = model.decoder_net.invpt_decoder.mt_proj
    g = torch.Generator(device=dev).manual_seed(8)
    (H, W), T = cfg.decoder.img_size, cfg.visual.temporal_size
    inputs = [(torch.randn(B, T, H, W, 3, generator=g, device=dev) * 0.5,
               torch.randn(B, 9, H // 2, W // 2, 1, generator=g, device=dev),
               torch.randn(B, H, W, 1, generator=g, device=dev)) for _ in range(3)]

    def run(m, nfe, i=0):
        rgb, audio, noise = inputs[i % len(inputs)]
        return sample_saliency(m, schedule, dpm_sampling(nfe), data_cfg, rgb, audio, noise=noise)

    def counted(m, nfe, record=()):
        for n in record:
            recorders[n].on = True
        kernels.reset_launch_counts()
        out = run(m, nfe)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for n in record:
            recorders[n].on = False
        assert tuple(out.shape) == (B, H, W, 1), out.shape
        assert bool(torch.isfinite(out).all()), f"NFE {nfe}: non-finite map"
        lo, hi, std = float(out.min()), float(out.max()), float(out.std())
        assert 0.0 <= lo and hi <= 1.0 and std > 0.0, (nfe, lo, hi, std)
        return out, counts

    run(model, 2)
    run(model_d, 2)  # warm-up
    torch.cuda.synchronize()
    new = ("cvt_attention", "resize_phase_head", "depthwise_pool3d")
    counts8, maps = {}, {}
    for nfe in (2, 5):
        maps[nfe], counts8[nfe] = counted(model, nfe, new if nfe == 2 else ())
        c = counts8[nfe]
        log(f"[dpm] NFE {nfe}: launches per run " + json.dumps(c))
        check_launches(c, path_launches(cfg, nfe), f"NFE {nfe}")

    # the other head lowering: K8 at full resolution
    head.head_lowres, head.fused_head = False, True
    counts_k8 = {}
    for nfe in (2, 5):
        out, c = counted(model, nfe, ("resize_conv_relu",) if nfe == 2 else ())
        counts_k8[nfe] = c
        check_launches(c, {**path_launches(cfg, nfe), "resize_phase_head": 0,
                           "resize_conv_relu": nfe}, f"NFE {nfe} with fused_head")
        log(f"[dpm] NFE {nfe} with fused_head: K8 {c['resize_conv_relu']} launches, "
            f"max|map - head_lowres map| {float((out - maps[nfe]).abs().max()):.3e}")
    head.head_lowres, head.fused_head = True, False

    # against the default lowerings on the same inputs and noise: conv pools,
    # einsum attention, K4 + conv head. Every lowering is a rewrite of the
    # same function up to where bf16 rounds (the einsum path rounds the
    # scores to bf16, cuDNN the pool weights), so the maps may differ by the
    # bf16 bound phase 5 holds the whole port to: 3e-2 on the [0, 1] map
    for nfe in (2, 5):
        ref, c = counted(model_d, nfe)
        check_launches(c, path_launches(main_config(), nfe), f"NFE {nfe} default lowerings")
        d = float((maps[nfe] - ref).abs().max())
        log(f"[dpm] NFE {nfe}: max|lowered - default lowerings| {d:.3e} (limit 3e-2), "
            f"mean {float((maps[nfe] - ref).abs().mean()):.3e}")
        assert d <= 3e-2, (nfe, d)

    # host-bound runs drift within a process: time the two models in turns
    # (lowered, default, default, lowered) and report each turn and the mean
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for nfe in (2, 5):
        iters = max(3, cli.iters // nfe)
        times = {"lowered": [], "default": []}
        for name in ("lowered", "default", "default", "lowered"):
            m = model if name == "lowered" else model_d
            start.record()
            for i in range(iters):
                out = run(m, nfe, i)
            end.record()
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out).all()) and float(out.std()) > 0
            times[name].append(start.elapsed_time(end) / iters)
        for name, ts in times.items():
            ms = sum(ts) / len(ts)
            log(f"[dpm] NFE {nfe} {name} lowerings: {ms:.2f} ms per B={B} run (turns "
                + ", ".join(f"{t:.2f}" for t in ts) + f"), {1000.0 * B / ms:.2f} clips/s "
                f"({2 * iters} iters, rotating inputs) on {kind} [{smi}]")
    log(f"[dpm] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if cli.profile:
        from torch.profiler import ProfilerActivity, profile

        for nfe, name, m in ((2, "lowered", model), (2, "default", model_d)):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                run(m, nfe, 1)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t1) * 1e3
            # the table's last line sums the device time
            log(f"[dpm profile] NFE {nfe} {name} lowerings: {wall:.2f} ms wall under the "
                "profiler")
            log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    del model, model_d, inputs

    counts = dict(counts8[2])
    counts["resize_conv_relu"] = counts_k8[2]["resize_conv_relu"]
    full_calls["cvt_attention"] = list(recorders["cvt_attention"].calls)
    full_calls["resize_conv_relu"] = list(recorders["resize_conv_relu"].calls)
    unfused_head(full_calls["resize_conv_relu"], "resize_conv_relu")
    phase_calls = list(recorders["resize_phase_head"].calls)
    unfused_head(phase_calls, "resize_phase_head")
    phase_split(phase_calls)
    del phase_calls
    rows = hold_kernels(("cvt_attention", "resize_conv_relu", "resize_phase_head",
                         "depthwise_pool3d"), recorders, plain, counts)

    # the small AV model with the three lowerings, DPM++ NFE 2: bf16 through
    # the kernels on the card against f32 through the plain versions on the CPU
    small = lowered_config(ModelConfig(visual=MViTConfig.tiny(spatial_size=(64, 96)),
                                       audio=VGGishConfig(), spatiotemp=AudioAttnConfig(),
                                       decoder=SalUNetConfig(img_size=(64, 96))))
    gc = torch.Generator().manual_seed(9)
    rgb_s, aud_s = (torch.randn(2, 16, 64, 96, 3, generator=gc),
                    torch.randn(2, 9, 32, 48, 1, generator=gc))
    noise_s = torch.randn(2, 64, 96, 1, generator=gc)
    cpu_model = build_model(small, seed=10, device="cpu")
    ref = sample_saliency(cpu_model, schedule, dpm_sampling(2), data_cfg, rgb_s, aud_s,
                          noise=noise_s)
    gpu_model = VideoSaliencyModel(dataclasses.replace(small, compute_dtype="bfloat16")).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    kernels.reset_launch_counts()
    got = sample_saliency(gpu_model.to(dev), schedule, dpm_sampling(2), data_cfg, rgb_s.to(dev),
                          aud_s.to(dev), noise=noise_s).cpu()
    c = kernels.launch_counts()
    assert all(c[n] > 0 for n in new), c
    err = float((got - ref).abs().max())
    log(f"[dpm small] bf16 card vs f32 CPU plain, DPM++ NFE 2 with the lowerings: max|d| "
        f"{err:.3e} (limit 3e-2)")
    assert err <= 3e-2, err
    return rows


def unfused_head(calls, name):
    """Context for K8 and K9: on the recorded inputs of `name`, the device
    time of the route they replace, ConvBNRelu's default path at eval
    (`models/layers.py`): K4's resize-sum, then cuDNN's conv with the folded
    kernel and bias, then ReLU. Timed only."""
    from diff_sal_tpu_torch.ops import resize

    F = torch.nn.functional
    thunks = []
    for args, kw in calls:
        xs, out_hw, kern, bias = args[:4]
        w = kern.permute(3, 2, 0, 1).contiguous()
        b = bias.to(kern.dtype)

        def head(xs=xs, out_hw=out_hw, w=w, b=b):
            a = resize.bilinear_resize_sum_fwd(xs, out_hw)
            return torch.relu(F.conv2d(a.permute(0, 3, 1, 2), w, b, 1, 1)).permute(0, 2, 3, 1)
        thunks.append(head)
    ms = device_ms(thunks)[0]
    log(f"[shape {name}] the unfused head on the {len(calls)} recorded calls (K4 + "
        f"cuDNN conv + bias + ReLU): device {1e3 * ms / len(calls):.2f} us per call, "
        f"{ms:.4f} ms per run")
    return ms


# CUDA kernels of K9's separable gather (csrc/separable.cuh); every other
# device event of a K9 call is its u_i = x_i K' products
GATHER_KERNEL = "separable_kernel"


def phase_split(calls):
    """K9's device time on its recorded calls split into the cuBLAS
    products (u_i = x_i K') and the gather kernel, each against its share
    of the bound: the products at the bf16 tensor cores' rate, the gather
    by the larger of its bytes (u_i read once, the output written once) and
    the separable form's f32 operations."""
    from diff_sal_tpu_torch.ops import resize

    events = device_events([lambda a=a, k=k: resize.resize_sum_conv_relu_phase(*a, **k)
                            for a, k in calls])
    gather = sum(e.time_range.elapsed_us() for e in events if GATHER_KERNEL in e.name) / 1e3
    total = sum(e.time_range.elapsed_us() for e in events) / 1e3
    mm_ms = sep_ms = 0.0
    for a, k in calls:
        xs, (H, W), kern = a[:3]
        nbytes, ((mm, mm_peak), (ops, peak)) = bound_terms("resize_phase_head", a, k)
        O, e = kern.shape[-1], xs[0].element_size()
        u_bytes = sum(x.numel() // x.shape[-1] * 9 * O for x in xs) * e
        out_bytes = xs[0].shape[0] * H * W * O * e
        mm_ms += mm / mm_peak * 1e3
        sep_ms += max((u_bytes + out_bytes) / HBM_BYTES_PER_S, ops / peak) * 1e3
    n = len(calls)
    log(f"[shape resize_phase_head] device time split over the {n} recorded calls: products "
        f"(cuBLAS) {1e3 * (total - gather) / n:.2f} us per call (bound {1e3 * mm_ms / n:.2f} us, "
        f"{100.0 * mm_ms / max(total - gather, 1e-9):.1f}%), gather kernel {1e3 * gather / n:.2f} "
        f"us per call (bound {1e3 * sep_ms / n:.2f} us, {100.0 * sep_ms / max(gather, 1e-9):.1f}%)"
        f"; {total:.4f} ms per run")


def interpolate_sum(call):
    """Context for K4 (timed only, never on the port's path): the device
    time of its function as four `F.interpolate(mode="bilinear",
    align_corners=False)` calls on channels-last views of the recorded task
    maps and their sum, in x's dtype."""
    F = torch.nn.functional
    (xs, out_hw), _ = call
    views = [x.permute(0, 3, 1, 2) for x in xs]  # NCHW shape, channels-last memory

    def fn():
        acc = None
        for v in views:
            r = F.interpolate(v, size=tuple(out_hw), mode="bilinear", align_corners=False)
            acc = r if acc is None else acc + r
        return acc
    ms = device_ms([fn])[0]
    log(f"[shape bilinear_resize_sum] four F.interpolate (bilinear, channels-last) + sum on the "
        f"recorded maps: device {1e3 * ms:.2f} us")
    return ms


def visual_config(cls_stream: bool = True):
    """Phase 9's model: the visual-only (DHF1k) model in bf16 at full width,
    in the given MViT layout."""
    from diff_sal_tpu_torch.config import ModelConfig

    cfg = ModelConfig.visual_only(compute_dtype="bfloat16")
    return dataclasses.replace(cfg, visual=dataclasses.replace(cfg.visual,
                                                               cls_stream=cls_stream))


def visual_only_phase(cli, dev, schedule, data_cfg, recorders, plain, kind, smi, full_calls):
    """Phase 9: the visual-only model at full width in both MViT layouts,
    same weights, inputs, noise and draws: DDIM NFE 1 at B=2 and the
    training step at B=4; maps, launches, gradients, timings, and K12
    forward and backward against their plain versions. Returns K12's
    `kernels` rows; K12's recorded forward calls also go into
    `full_calls` (phase 11)."""
    from diff_sal_tpu_torch.config import ExperimentConfig, SamplingConfig
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel, build_model
    from diff_sal_tpu_torch.ops import kernels
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_train_step

    cfgs = {"cls_stream": visual_config(True), "token_concat": visual_config(False)}
    models = {"cls_stream": build_model(cfgs["cls_stream"], seed=20, device=dev)}
    # one parameter tree serves both layouts
    models["token_concat"] = VideoSaliencyModel(cfgs["token_concat"]).eval()
    models["token_concat"].load_state_dict(models["cls_stream"].state_dict())
    models["token_concat"].to(dev)
    (H, W), T = cfgs["cls_stream"].decoder.img_size, cfgs["cls_stream"].visual.temporal_size
    g = torch.Generator(device=dev).manual_seed(21)
    inputs = [(torch.randn(B, T, H, W, 3, generator=g, device=dev) * 0.5,
               torch.randn(B, H, W, 1, generator=g, device=dev)) for _ in range(3)]
    sampling = SamplingConfig()

    def run(layout, i=0):
        rgb, noise = inputs[i % len(inputs)]
        return sample_saliency(models[layout], schedule, sampling, data_cfg, rgb, noise=noise)

    for layout in LAYOUTS:
        run(layout)  # warm-up
    torch.cuda.synchronize()
    maps, counts, peak = {}, {}, {}
    for layout in LAYOUTS:
        recorders["fused_bias_attention"].on = layout == "token_concat"
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = run(layout)
        torch.cuda.synchronize()
        counts[layout] = kernels.launch_counts()
        recorders["fused_bias_attention"].on = False
        peak[layout] = torch.cuda.max_memory_allocated() / 2**30
        assert tuple(out.shape) == (B, H, W, 1), out.shape
        assert bool(torch.isfinite(out).all()), f"{layout}: non-finite map"
        lo, hi, std = float(out.min()), float(out.max()), float(out.std())
        assert 0.0 <= lo and hi <= 1.0 and std > 0.0, (layout, lo, hi, std)
        check_launches(counts[layout], path_launches(cfgs[layout], 1), f"visual-only {layout}")
        maps[layout] = out
        log(f"[visual] {layout}: map min {lo:.4f} max {hi:.4f} std {std:.5f}; launches per "
            f"run " + json.dumps(counts[layout]) + f"; peak memory {peak[layout]:.2f} GiB")
    d = float((maps["token_concat"] - maps["cls_stream"]).abs().max())
    log(f"[visual] max|token_concat map - cls_stream map| {d:.3e} (limit 3e-2)")
    assert d <= 3e-2, d

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    iters = max(3, cli.iters // 2)
    times = {layout: [] for layout in LAYOUTS}
    for layout in LAYOUTS[::-1] + LAYOUTS:  # in turns
        start.record()
        for i in range(iters):
            out = run(layout, i)
        end.record()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()) and float(out.std()) > 0
        times[layout].append(start.elapsed_time(end) / iters)
    for layout, ts in times.items():
        ms = sum(ts) / len(ts)
        log(f"[visual] {layout}: {ms:.2f} ms per B={B} DDIM run (turns "
            + ", ".join(f"{t:.2f}" for t in ts) + f"), {1000.0 * B / ms:.2f} clips/s "
            f"({2 * iters} iters, rotating inputs) on {kind} [{smi}]")
    del maps

    # the training step: the first step of each layout from the same
    # weights, batch, draws and dropout masks gives the gradients compared
    gen = torch.Generator(device=dev).manual_seed(22)
    batches = [{"rgb": torch.randn(B_TRAIN, T, H, W, 3, generator=gen, device=dev) * 0.5,
                "salmap": torch.rand(B_TRAIN, H, W, 1, generator=gen, device=dev)}
               for _ in range(3)]
    draws = {"deq": torch.randn(B_TRAIN, H, W, 1, generator=gen, device=dev),
             "noise": torch.randn(B_TRAIN, H, W, 1, generator=gen, device=dev),
             "t": torch.tensor(500)}
    steps, grads, tcounts, tpeak = {}, {}, {}, {}
    for layout in LAYOUTS:
        m = models[layout]
        ecfg = ExperimentConfig(model=cfgs[layout])
        opt = make_optimizer(m, ecfg.optim, steps_per_epoch=1000, n_epochs=4)
        step = make_train_step(m, schedule, ecfg)
        steps[layout] = (opt, step)
        t0 = time.perf_counter()
        met = step(opt, batches[0], torch.Generator(device=dev).manual_seed(23), draws=draws)
        torch.cuda.synchronize()
        loss, gn = float(met["total"]), float(met["grad_norm"])
        log(f"[visual train] {layout}: first step in {time.perf_counter() - t0:.1f} s, loss "
            f"{loss:.4f}, grad_norm {gn:.4f}")
        assert np.isfinite(loss) and loss > 0 and np.isfinite(gn) and gn > 0, (layout, loss, gn)
        params = dict(m.named_parameters())
        off_graph = {n for n, p in params.items() if p.requires_grad and p.grad is None}
        assert off_graph == {"visual_net.norm0.weight", "visual_net.norm0.bias"}, off_graph
        assert all(bool(torch.isfinite(p.grad).all()) for p in params.values()
                   if p.grad is not None), layout
        for sub in ("visual_net", "decoder_net"):
            assert any(p.grad is not None and float(p.grad.abs().max()) > 0
                       for n, p in params.items() if n.startswith(sub + ".")), (layout, sub)
        grads[layout] = {n: p.grad.detach().float().clone() for n, p in params.items()
                         if p.grad is not None}

        recorders["fused_bias_attention_bwd"].on = layout == "token_concat"
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        met = step(opt, batches[1], gen)
        torch.cuda.synchronize()
        tcounts[layout] = kernels.launch_counts()
        recorders["fused_bias_attention_bwd"].on = False
        tpeak[layout] = torch.cuda.max_memory_allocated() / 2**30
        assert np.isfinite(float(met["total"])), met
        check_launches(tcounts[layout], path_launches(cfgs[layout], train=True),
                       f"visual-only {layout} train step")
        log(f"[visual train] {layout}: launches per step " + json.dumps(tcounts[layout])
            + f"; peak memory {tpeak[layout]:.2f} GiB")
    stats, worst = grad_agreement(grads["token_concat"], grads["cls_stream"])
    log("[visual train] first-step gradients, token_concat vs cls_stream (relative L2, "
        f"cosine): " + json.dumps(stats) + f" worst tensor {worst}")
    for sub, (_, cos) in stats.items():
        assert cos >= LAYOUT_GRAD_COS, (sub, cos)
    del grads

    times = {layout: [] for layout in LAYOUTS}
    for layout in LAYOUTS[::-1] + LAYOUTS:  # in turns
        opt, step = steps[layout]
        start.record()
        for i in range(VISUAL_TRAIN_ITERS):
            met = step(opt, batches[i % len(batches)], gen)
        end.record()
        torch.cuda.synchronize()
        assert np.isfinite(float(met["total"])) and float(met["grad_norm"]) > 0, met
        times[layout].append(start.elapsed_time(end) / VISUAL_TRAIN_ITERS)
    for layout, ts in times.items():
        ms = sum(ts) / len(ts)
        log(f"[visual train] {layout}: {ms:.2f} ms per B={B_TRAIN} step (turns "
            + ", ".join(f"{t:.2f}" for t in ts) + f"), {1000.0 * B_TRAIN / ms:.2f} clips/s "
            f"({2 * VISUAL_TRAIN_ITERS} steps, rotating batches) on {kind} [{smi}]")
    if cli.profile:
        from torch.profiler import ProfilerActivity, profile

        for layout in LAYOUTS:
            opt, step = steps[layout]
            for what, fn in (("DDIM run", lambda: run(layout, 1)),
                             ("train step", lambda: step(opt, batches[2], gen))):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t1) * 1e3
                # the table's last line sums the device time
                log(f"[visual profile] {layout} {what}: {wall:.2f} ms wall under the profiler")
                log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    del models, steps, batches

    counts = dict(counts["token_concat"])
    counts["fused_bias_attention_bwd"] = tcounts["token_concat"]["fused_bias_attention_bwd"]
    full_calls["fused_bias_attention"] = list(recorders["fused_bias_attention"].calls)
    full_calls["fused_bias_attention_bwd"] = list(recorders["fused_bias_attention_bwd"].calls)
    return hold_kernels(("fused_bias_attention", "fused_bias_attention_bwd"), recorders,
                        plain, counts, cli.profile)


def f32_launches(cfg, nfe: int = 1, train: bool = False, fused_head: bool = False):
    """`path_launches` for an f32 model: the f32 instances launch where the
    bf16 kernels would (attention, K3, K7, K8), every other kernel takes
    f32 as it is."""
    want = path_launches(cfg, nfe, train, fused_head)
    for name in F32_KERNELS:
        base = name.removesuffix("_f32")
        want[name], want[base] = want[base], 0
    return want


def f32_phase(dev, schedule, data_cfg, recorders, plain):
    """Phase 10: the small AV model (`fused_attn` on, so K7 runs) and the
    small visual-only model in the token-concat layout, in f32, through
    the kernels' f32 instances on the card against the plain versions in
    f32 on the CPU: one DDIM run and one training step each, launches
    checked, the f32 instances' calls recorded and held against their plain
    versions. Returns their `kernels` rows."""
    from types import SimpleNamespace

    from diff_sal_tpu_torch.config import (AudioAttnConfig, ExperimentConfig, ModelConfig,
                                           MViTConfig, SalUNetConfig, SamplingConfig,
                                           VGGishConfig)
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel, build_model
    from diff_sal_tpu_torch.ops import kernels
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_train_step

    hw = (128, 96)  # the coarsest grid keeps > 1 CvT key, as in phase 7
    dec = SalUNetConfig(img_size=hw, dropout=0.0, drop_path_rate=(0.0,) * 4)
    cfgs = {"av": ModelConfig(visual=MViTConfig.tiny(spatial_size=hw), audio=VGGishConfig(),
                              spatiotemp=AudioAttnConfig(),
                              decoder=dataclasses.replace(dec, fused_attn=True)),
            "visual token_concat": ModelConfig(
                visual=MViTConfig.tiny(spatial_size=hw, cls_stream=False), audio=None,
                spatiotemp=None, decoder=dec)}
    bases = {n.removesuffix("_f32") for n in F32_KERNELS}
    calls = {n: [] for n in F32_KERNELS}
    counts = {}
    gc = torch.Generator().manual_seed(30)
    for i, (what, cfg) in enumerate(cfgs.items()):
        av = cfg.audio is not None
        rgb = torch.randn(2, 16, *hw, 3, generator=gc)
        audio = torch.randn(2, 9, hw[0] // 2, hw[1] // 2, 1, generator=gc) if av else None
        noise = torch.randn(2, *hw, 1, generator=gc)
        cpu_model = build_model(cfg, seed=31 + i, device="cpu")
        card = VideoSaliencyModel(cfg).eval()
        # the AV model's head through K8 (its f32 instance on the card), as
        # phase 8 sets it: a module field, in both models
        for m in (cpu_model, card):
            m.decoder_net.invpt_decoder.mt_proj.fused_head = av
        ref = sample_saliency(cpu_model, schedule, SamplingConfig(), data_cfg, rgb, audio,
                              noise=noise)
        sd = {k: v.clone() for k, v in cpu_model.state_dict().items()}
        card.load_state_dict(sd)
        card.to(dev)

        def record(on):
            for n in bases:
                recorders[n].on = on

        def keep(bwd, launched):
            """The recorded calls of the forward (DDIM run) or backward
            (train step) f32 instances, with that run's launches."""
            for n in F32_KERNELS:
                base = n.removesuffix("_f32")
                if n.endswith("_bwd_f32") == bwd and recorders[base].calls and not calls[n]:
                    calls[n], counts[n] = recorders[base].calls, launched[n]
                recorders[base].calls = []

        record(True)
        kernels.reset_launch_counts()
        got = sample_saliency(card, schedule, SamplingConfig(), data_cfg, rgb.to(dev),
                              audio.to(dev) if av else None, noise=noise)
        torch.cuda.synchronize()
        c = kernels.launch_counts()
        record(False)
        keep(False, c)
        check_launches(c, f32_launches(cfg, 1, fused_head=av), f"f32 {what} DDIM run")
        err = float((got.cpu() - ref).abs().max())
        log(f"[f32] {what}: f32 card vs f32 CPU plain, DDIM NFE 1: max|d| {err:.3e} "
            f"(limit {F32_MAP_TOL}); launches per run " + json.dumps(
                {n: k for n, k in c.items() if k}))
        assert err <= F32_MAP_TOL, (what, err)

        batch = {"rgb": rgb, "salmap": torch.rand(2, *hw, 1, generator=gc)}
        if av:
            batch["audio"] = audio
        draws = {"deq": torch.randn(2, *hw, 1, generator=gc),
                 "noise": torch.randn(2, *hw, 1, generator=gc), "t": torch.tensor(300)}

        def step(device):
            m = VideoSaliencyModel(cfg).train()
            m.load_state_dict(sd)
            m.to(device)
            ecfg = ExperimentConfig(model=cfg)
            met = make_train_step(m, schedule, ecfg)(make_optimizer(m, ecfg.optim, 10, 2),
                                                     batch, draws=draws)
            return float(met["total"]), {n: p.grad.cpu() for n, p in m.named_parameters()
                                         if p.grad is not None}

        l_cpu, g_cpu = step("cpu")
        record(True)
        kernels.reset_launch_counts()
        l_card, g_card = step(dev)
        tc = kernels.launch_counts()
        record(False)
        keep(True, tc)
        check_launches(tc, f32_launches(cfg, train=True), f"f32 {what} train step")
        stats, worst = grad_agreement(g_card, g_cpu)
        loss_err = abs(l_card - l_cpu) / abs(l_cpu)
        log(f"[f32] {what}: train step loss card {l_card:.6f} CPU {l_cpu:.6f} (rel "
            f"{loss_err:.3e}); gradients card vs CPU (relative L2, cosine) " + json.dumps(stats)
            + f"; worst tensor {worst} (limit {F32_GRAD_TOL}); launches per step "
            + json.dumps({n: k for n, k in tc.items() if k}))
        assert set(g_card) == set(g_cpu), set(g_card) ^ set(g_cpu)
        assert loss_err <= F32_MAP_TOL and worst[0] <= F32_GRAD_TOL, (what, loss_err, worst)
        del cpu_model, card
    recs = {n: SimpleNamespace(fn=recorders[n.removesuffix("_f32")].fn, calls=calls[n])
            for n in F32_KERNELS}
    return hold_kernels(F32_KERNELS, recs, plain, counts)


def f32_block_phase(full_calls):
    """Phase 11: the f32 attention forward at full width. Phase 3's recorded
    K1 calls and phase 9's recorded K12 forward calls, cast to f32, each
    through the f32 instance (with its logsumexp), its plain version and
    SDPA in f32; one `[block ...]` line per MViT block shape with the device
    time per call of the kernel and of SDPA and the share of the bound, and
    the CUDA kernels SDPA f32 runs. The kernel is held to the f32 tolerance
    against the plain version on the same inputs computed in f64: at these
    magnitudes (|out| up to ~8, sums over up to 2689 keys) the plain
    version's own f32 result sits up to ~1e-5 from it, a distance logged
    beside the kernel's. These launches compare a kernel with its plain
    version: no path's count reads them. Returns {name: (kernel device ms,
    SDPA device ms, bound ms, max|d|)} over the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diff_sal_tpu_torch.ops import attention

    fns = {"bias_attention": (attention.bias_attention_fwd, attention.bias_attention_plain),
           "fused_bias_attention": (attention.fused_bias_attention_fwd,
                                    attention.fused_bias_attention_plain)}
    atol, rtol = TOL[torch.float32]
    summary = {}
    for name, (fn, plain_fn) in fns.items():
        calls = full_calls[name]
        groups = {}  # shape key -> kernel thunks, SDPA thunks, bound ms
        err = plain_err = 0.0
        for args, kw in calls:
            a32 = tuple(x.float() if isinstance(x, torch.Tensor) else x for x in args)
            out, lse = fn(*a32, **kw, return_lse=True)
            ref, ref_lse = plain_fn(*(x.double() if isinstance(x, torch.Tensor) else x
                                      for x in a32), **kw, return_lse=True)
            torch.cuda.synchronize()
            d_out = float((out.double() - ref).abs().max())
            d_lse = (lse.double() - ref_lse).abs()
            assert d_out <= atol, f"{name}_f32 at {tuple(a32[0].shape)}: max|d| {d_out:.3e}"
            assert not bool((d_lse > 1e-5 + 1e-6 * ref_lse.abs()).any()), (
                f"{name}_f32 at {tuple(a32[0].shape)}: logsumexp max|d| {float(d_lse.max()):.3e}")
            err = max(err, d_out)
            plain_err = max(plain_err, float((plain_fn(*a32, **kw).double() - ref).abs().max()))
            del out, lse, ref, ref_lse
            q, k = a32[:2]
            k_shape, H = (a32[4], a32[5]) if name == "bias_attention" else (a32[6], 1)
            plan = attention.f32_fwd_plan(q.shape[0], H, q.shape[1], k.shape[1], q.shape[2] // H,
                                          tuple(k_shape))
            key = (tuple(q.shape), tuple(k.shape), (plan.rows, plan.block_n, plan.splits,
                                                    plan.smem))
            nbytes, ops = bound_terms(name + "_f32", a32, kw)
            g = groups.setdefault(key, [[], [], 0.0])
            g[0].append(lambda a=a32, kw=kw: fn(*a, **kw))
            g[1].append(library_call(name + "_f32", a32, kw))
            g[2] += max(nbytes / HBM_BYTES_PER_S, sum(n / p for n, p in ops)) * 1e3
        tot = [0.0, 0.0, 0.0]
        for (qs, ks, plan), (kern, lib, bound) in groups.items():
            n = len(kern)
            dms, lms = device_ms(kern)[0], device_ms(lib)[0]
            tot = [tot[0] + dms, tot[1] + lms, tot[2] + bound]
            log(f"[block {name}_f32] q {qs} k {ks} plan (rows, block_n, splits, smem) {plan}: {n} "
                f"calls, device {1e3 * dms / n:.2f} us per call ({100.0 * bound / dms:.1f}% of "
                f"bound), SDPA f32 device {1e3 * lms / n:.2f} us ({100.0 * bound / lms:.1f}% of "
                f"bound), bound {1e3 * bound / n:.2f} us (split TF32), SDPA / kernel "
                f"{lms / dms:.2f}")
        summary[name] = (*tot, err)
        log(f"[f32 full width] {name}_f32: {len(calls)} calls, device {tot[0]:.4f} ms, SDPA f32 "
            f"{tot[1]:.4f} ms, bound {tot[2]:.4f} ms; max|d| from the plain version in f64: "
            f"kernel {err:.3e}, the plain version in f32 {plain_err:.3e}")
        # what SDPA runs in f32, on the first block shape
        lib = next(iter(groups.values()))[1][0]
        names = set()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                lib()
                torch.cuda.synchronize()
            names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
            if names:
                break
        log(f"[f32 full width] SDPA f32 ({name}, first block shape) runs: {names}")
        del groups
    return summary


def f32_backward_phase(full_calls):
    """Phase 11, the backward: phase 6's recorded K5 calls and phase 9's
    recorded K12 backward calls, cast to f32, each fed with the f32
    forward's logsumexp on the same inputs and run through the f32
    backward. Each output is held against the plain version computed in
    f64 within the larger of the f32 tolerance and twice the f32 plain
    version's own distance from it (dk and dv sum over up to 43008 query
    rows, where an absolute 1e-5 may be beyond f32 itself); both distances
    are logged. One `[block ...]` line per MViT block shape with the device
    time per call of the kernel and of SDPA f32's backward and the share of
    the split-TF32 bound, and the CUDA kernels SDPA f32's backward runs.
    These launches compare a kernel with its plain version: no path's count
    reads them. Returns {name: (kernel device ms, SDPA device ms, bound ms)}
    over the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diff_sal_tpu_torch.ops import attention

    # name: forward, backward, plain backward, number of input tensors
    fns = {"bias_attention_bwd": (attention.bias_attention_fwd, attention.bias_attention_bwd,
                                  attention.bias_attention_bwd_plain, 4),
           "fused_bias_attention_bwd": (attention.fused_bias_attention_fwd,
                                        attention.fused_bias_attention_bwd,
                                        attention.fused_bias_attention_bwd_plain, 6)}
    atol = TOL[torch.float32][0]
    summary = {}
    for name, (fwd, bwd, plain_fn, n_in) in fns.items():
        calls = full_calls[name]
        groups = {}  # shape key -> kernel thunks, SDPA thunks, bound ms
        errs = {}  # output -> (kernel's distance, the f32 plain version's) from f64, worst
        for args, kw in calls:
            a32 = tuple(x.float() if isinstance(x, torch.Tensor) else x for x in args)
            ins, go, rest = a32[:n_in], a32[n_in], a32[n_in + 1:]
            lse = fwd(*ins, *rest, return_lse=True)[1]
            got = bwd(*ins, go, *rest, lse=lse)
            ref = plain_fn(*(x.double() for x in ins), go.double(), *rest)
            own = plain_fn(*ins, go, *rest)
            torch.cuda.synchronize()
            for i, (a, r, o) in enumerate(zip(got, ref, own)):
                d = float((a.double() - r).abs().max())
                po = float((o.double() - r).abs().max())
                limit = max(atol, 2 * po)
                assert d <= limit, (f"{name}_f32 at {tuple(ins[0].shape)}: output {i} max|d| "
                                    f"{d:.3e} from the f64 plain version, limit {limit:.3e} "
                                    f"(the f32 plain version's {po:.3e})")
                errs[i] = max(errs.get(i, (0.0, 0.0)), (d, po))
            del got, ref, own
            q, k = ins[:2]
            key = (tuple(q.shape), tuple(k.shape), attention_plan(name + "_f32", a32))
            nbytes, ops = bound_terms(name + "_f32", a32, kw)
            g = groups.setdefault(key, [[], [], 0.0])
            g[0].append(lambda i=ins, go=go, r=rest, l=lse: bwd(*i, go, *r, lse=l))
            g[1].append(library_call(name + "_f32", a32, kw))
            g[2] += max(nbytes / HBM_BYTES_PER_S, sum(n / p for n, p in ops)) * 1e3
        tot = [0.0, 0.0, 0.0]
        for (qs, ks, plan), (kern, lib, bound) in groups.items():
            n = len(kern)
            dms, lms = device_ms(kern)[0], device_ms(lib)[0]
            tot = [tot[0] + dms, tot[1] + lms, tot[2] + bound]
            log(f"[block {name}_f32] q {qs} k {ks} plan (q_rows, splits, q_ctas, k_ctas, "
                f"smem_q, smem_k) {plan}: {n} calls, device {1e3 * dms / n:.2f} us per call "
                f"({100.0 * bound / dms:.1f}% of bound), SDPA f32 backward device "
                f"{1e3 * lms / n:.2f} us ({100.0 * bound / lms:.1f}% of bound), bound "
                f"{1e3 * bound / n:.2f} us (split TF32), SDPA / kernel {lms / dms:.2f}")
        summary[name] = tuple(tot)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for kern, _, _ in groups.values():
                for f in kern:
                    f()
            torch.cuda.synchronize()
        log(f"[profile {name}_f32] the {len(calls)} calls once, device time by CUDA kernel")
        log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=6))
        log(f"[f32 full width] {name}_f32: {len(calls)} calls, device {tot[0]:.4f} ms, SDPA f32 "
            f"backward {tot[1]:.4f} ms, bound {tot[2]:.4f} ms; max|d| from the plain version in "
            "f64 per output (kernel, the plain version in f32): "
            + json.dumps({i: [float(f"{d:.3e}"), float(f"{po:.3e}")]
                          for i, (d, po) in errs.items()}))
        lib = next(iter(groups.values()))[1][0]
        names = set()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                lib()
                torch.cuda.synchronize()
            names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
            if names:
                break
        log(f"[f32 full width] SDPA f32 backward ({name}, first block shape) runs: {names}")
        del groups
    return summary


def f32_cvt_phase(calls):
    """Phase 11, K7: phase 8's recorded K7 calls (DPM++ NFE 2), cast to f32,
    each through the f32 instance against its plain version on the same
    inputs at the f32 tolerance; one `[shape cvt_attention_f32]` line per
    (Bt, L, C) with the device time per call, SDPA per head in f32 and the
    share of the bytes bound. Returns (kernel device ms, SDPA device ms,
    bound ms, max|d|) over the calls."""
    from diff_sal_tpu_torch.ops import attention

    atol = TOL[torch.float32][0]
    groups = {}  # (Bt, L, C) -> kernel thunks, SDPA thunks, bound ms
    err = 0.0
    with torch.no_grad():
        for args, kw in calls:
            a32 = tuple(x.float() if isinstance(x, torch.Tensor) else x for x in args)
            out = attention.cvt_cross_attention(*a32, **kw)
            ref = attention.reference_cvt_attention(*a32, **kw)
            torch.cuda.synchronize()
            d = float((out - ref).abs().max())
            assert d <= atol, f"cvt_attention_f32 at {tuple(a32[0].shape)}: max|d| {d:.3e}"
            err = max(err, d)
            nbytes, ops = bound_terms("cvt_attention_f32", a32, kw)
            g = groups.setdefault(tuple(a32[0].shape), [[], [], 0.0])
            g[0].append(lambda a=a32, kw=kw: attention.cvt_cross_attention(*a, **kw))
            g[1].append(library_call("cvt_attention_f32", a32, kw))
            g[2] += max(nbytes / HBM_BYTES_PER_S, sum(n / p for n, p in ops)) * 1e3
        tot = [0.0, 0.0, 0.0]
        for key, (kern, lib, bound) in groups.items():
            n = len(kern)
            dms, lms = device_ms(kern)[0], device_ms(lib)[0]
            tot = [tot[0] + dms, tot[1] + lms, tot[2] + bound]
            plan = attention.cvt_f32_plan(key[0], key[1], calls[0][0][1].shape[1], key[2],
                                          calls[0][0][3])
            log(f"[shape cvt_attention_f32] (Bt, L, C) {key}: {n} calls, device "
                f"{1e3 * dms / n:.2f} us per call ({100.0 * bound / dms:.1f}% of bound), SDPA "
                f"per head f32 device {1e3 * lms / n:.2f} us, bound {1e3 * bound / n:.2f} us "
                f"(bytes); plan {plan}")
    log(f"[f32 full width] cvt_attention_f32: {len(calls)} calls, device {tot[0]:.4f} ms, SDPA "
        f"per head f32 {tot[1]:.4f} ms, bound {tot[2]:.4f} ms, max|d| {err:.3e}")
    return (*tot, err)


def f32_conv_phase(calls):
    """Phase 11, K8 f32: phase 8's recorded K8 calls (DPM++ NFE 2 with
    `fused_head`) cast to f32, each through K8's f32 instance, held against
    the plain version computed in f64 within the larger of the f32 tolerance
    and twice the f32 plain version's own distance from it; one `[shape
    resize_conv_relu_f32]` line per (out_hw, C, O, inputs) with the device
    time per call and the share of the bound (the products at split TF32's
    rate). No path's count reads these launches. Returns (kernel device ms,
    bound ms, max|d|) over the calls."""
    from diff_sal_tpu_torch.ops import resize

    tot_ms = tot_bound = err = 0.0
    with torch.no_grad():
        for args, kw in calls:
            xs, out_hw, kern, bias = args[:4]
            a32 = ([x.float() for x in xs], out_hw, kern.float(), bias.float())
            out = resize.resize_sum_conv_relu(*a32)
            d, own = hold_f64("resize_conv_relu_f32", out, resize.resize_sum_conv_relu_plain,
                              a32, {})
            key = shape_key("resize_conv_relu", a32)
            err = max(err, d)
            del out
            nbytes, ops = bound_terms("resize_conv_relu_f32", a32, kw)
            bound = max(nbytes / HBM_BYTES_PER_S, sum(n / p for n, p in ops)) * 1e3
            ms = device_ms([lambda a=a32: resize.resize_sum_conv_relu(*a)])[0]
            tot_ms, tot_bound = tot_ms + ms, tot_bound + bound
            log(f"[shape resize_conv_relu_f32] (out_hw, C, O, inputs) {key}: device "
                f"{1e3 * ms:.2f} us per call, bound {1e3 * bound:.2f} us (split TF32), "
                f"{100.0 * bound / ms:.1f}% of bound; max|d| from f64 {d:.3e} (the f32 plain "
                f"version {own:.3e})")
    log(f"[f32 full width] resize_conv_relu_f32: {len(calls)} calls, device {tot_ms:.4f} ms, "
        f"bound {tot_bound:.4f} ms ({100.0 * tot_bound / tot_ms:.1f}% of bound); max|d| from "
        f"f64 {err:.3e}")
    return tot_ms, tot_bound, err


F32_TRAIN_ITERS = 10  # timed f32 training steps at full width
# the f32 backward's CUDA kernels (csrc/attention_f32.cu)
F32_BWD_CUDA = ("f32_bwd_q_kernel", "f32_bwd_kv_kernel", "f32_reduce_kernel")
# words in the names of cuDNN's convolution kernels, its FFT path's complex
# GEMMs (`sm80_xmma_gemm_cf32cf32...`) among them
def f32_tail_phase(calls):
    """Phase 11, K3 f32: phase 3's recorded K3 calls (the decoder's four
    block tails of an AV DDIM run at B=2) cast to f32, each through K3's
    f32 instance, held against the plain version computed in f64 within the
    larger of the f32 tolerance and twice the f32 plain version's own
    distance from it; one `[shape block_tail_f32]` line per (rows, C) with
    the device time per call and the share of the bound at split TF32's
    rate, and beside it, as context (no single PyTorch call computes the
    tail), the device time of its two products as f32 `torch.matmul` with
    TF32 off on the same shapes. These launches compare a kernel with its
    plain version: no path's count reads them. Returns (kernel device ms,
    bound ms, max|d|) over the calls."""
    from diff_sal_tpu_torch.ops import mlp

    atol = TOL[torch.float32][0]
    tot_ms = tot_mm = tot_bound = err = 0.0
    for args, kw in calls:
        a32 = tuple(x.float() if isinstance(x, torch.Tensor) else x for x in args)
        skip, w1, w2 = a32[0], a32[4], a32[6]
        R, C = skip.shape
        Hd = w1.shape[0]
        out = mlp.block_tail(*a32, **kw)
        ref = mlp.block_tail_plain(*(x.double() if isinstance(x, torch.Tensor) else x
                                     for x in a32), **kw)
        own = float((mlp.block_tail_plain(*a32, **kw).double() - ref).abs().max())
        d = float((out.double() - ref).abs().max())
        torch.cuda.synchronize()
        assert d <= max(atol, 2 * own), (
            f"block_tail_f32 at ({R}, {C}): max|d| from f64 {d:.3e}, the f32 plain version's "
            f"{own:.3e}")
        err = max(err, d)
        del out, ref
        nbytes, ops = bound_terms("block_tail_f32", a32, kw)
        bound = max(nbytes / HBM_BYTES_PER_S, sum(n / p for n, p in ops)) * 1e3
        ms = device_ms([lambda a=a32, kw=kw: mlp.block_tail(*a, **kw)])[0]
        xn, h = torch.randn(R, C, device=skip.device), torch.randn(R, Hd, device=skip.device)
        w1t, w2t = w1.t(), w2.t()
        mm = device_ms([lambda: torch.matmul(xn, w1t), lambda: torch.matmul(h, w2t)])[0]
        tot_ms, tot_mm, tot_bound = tot_ms + ms, tot_mm + mm, tot_bound + bound
        plan = mlp.tail_f32_plan(R, C, Hd)
        log(f"[shape block_tail_f32] (rows, C) ({R}, {C}) plan (nt, col_splits, hc, k_splits, "
            f"ctas) ({plan.nt}, {plan.col_splits}, {plan.hc}, {plan.k_splits}, {plan.ctas}): device "
            f"{1e3 * ms:.2f} us per call, bound {1e3 * bound:.2f} us (split TF32), "
            f"{100.0 * bound / ms:.1f}% of bound; the two products as f32 torch.matmul "
            f"{1e3 * mm:.2f} us; max|d| from f64 {d:.3e} (the f32 plain version {own:.3e})")
    log(f"[f32 full width] block_tail_f32: {len(calls)} calls, device {tot_ms:.4f} ms, bound "
        f"{tot_bound:.4f} ms ({100.0 * tot_bound / tot_ms:.1f}% of bound), two f32 matmuls "
        f"per call {tot_mm:.4f} ms; max|d| from f64 {err:.3e}")
    return tot_ms, tot_bound, err


CONV_WORDS = ("conv", "fft", "fprop", "dgrad", "wgrad", "cudnn", "cf32")


def f32_train_phase(dev, schedule, kind, smi):
    """Phase 12: the AV training step at full width in f32 (both packages'
    default), B=4, phase 6's recipe: one warm-up step with phase 6's checks,
    one step with the launch counts set to 0 just before it and read just
    after, held against `f32_launches`, then F32_TRAIN_ITERS timed steps on
    rotating batches (ms per step by CUDA events: each step's and the whole
    window's), the device events of one more step (`device_events`): their
    sum, the device's busy time (the union of their intervals, so that
    overlapping kernels count once), the f32 backward's (K5 f32, its three
    CUDA kernels) and the convolutions' busy time as shares of it and of the
    step, the other events' busy time, the streams they ran on, and peak
    memory."""
    from diff_sal_tpu_torch.config import ExperimentConfig, ModelConfig
    from diff_sal_tpu_torch.models.diff_model import build_model
    from diff_sal_tpu_torch.ops import kernels
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    tcfg = ExperimentConfig(model=ModelConfig.audio_visual())
    assert tcfg.model.compute_dtype == "float32", tcfg.model.compute_dtype
    tmodel = build_model(tcfg.model, seed=0, device=dev, train=True)
    opt = make_optimizer(tmodel, tcfg.optim, steps_per_epoch=1000, n_epochs=4)
    tstep = make_train_step(tmodel, schedule, tcfg)
    gen = torch.Generator(device=dev).manual_seed(12)
    (H, W), T = tcfg.model.decoder.img_size, tcfg.model.visual.temporal_size
    batches = [{"rgb": torch.randn(B_TRAIN, T, H, W, 3, generator=gen, device=dev) * 0.5,
                "salmap": torch.rand(B_TRAIN, H, W, 1, generator=gen, device=dev),
                "audio": torch.randn(B_TRAIN, 9, H // 2, W // 2, 1, generator=gen, device=dev)}
               for _ in range(3)]
    torch.cuda.reset_peak_memory_stats()
    first_train_step(tstep, opt, batches[0], gen, dict(tmodel.named_parameters()), "f32 train",
                     t0)
    kernels.reset_launch_counts()
    m1 = tstep(opt, batches[1], gen)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert np.isfinite(float(m1["total"])), m1
    check_launches(counts, f32_launches(tcfg.model, train=True), "f32 train step")
    assert counts["bias_attention_f32"] == counts["bias_attention_bwd_f32"] == 16, counts
    log("[f32 train] launches per step " + json.dumps({n: c for n, c in counts.items() if c}))

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(F32_TRAIN_ITERS + 1)]
    marks[0].record()
    for i in range(F32_TRAIN_ITERS):
        m = tstep(opt, batches[i % len(batches)], gen)
        marks[i + 1].record()
    torch.cuda.synchronize()
    steps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    step_ms = marks[0].elapsed_time(marks[-1]) / F32_TRAIN_ITERS
    assert np.isfinite(float(m["total"])) and float(m["grad_norm"]) > 0, m
    events = device_events([lambda: tstep(opt, batches[2], gen)])
    total = sum(e.time_range.elapsed_us() for e in events) / 1e3
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events)) / 1e3
    busy = busy_ms(events)
    k5 = busy_ms([e for e in events if any(k in e.name for k in F32_BWD_CUDA)])
    k6 = [e for e in events if "layernorm_bwd" in e.name]
    k6_ms = sum(e.time_range.elapsed_us() for e in k6) / 1e3
    is_conv = [any(w in e.name.lower() for w in CONV_WORDS) for e in events]
    conv = busy_ms([e for e, c in zip(events, is_conv) if c])
    others = busy_ms([e for e, c in zip(events, is_conv) if not c])
    streams = len({getattr(e, "device_resource_id", 0) for e in events})
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    log("[f32 train] device time by kernel, one step (ms, summed): "
        + "; ".join(f"{n[:90]} {t:.3f}" for n, t in top))
    log(f"[f32 train] {step_ms:.2f} ms per B={B_TRAIN} f32 step by events over "
        f"{F32_TRAIN_ITERS} steps on rotating batches (each step: "
        f"{', '.join(f'{t:.1f}' for t in steps)} ms), {1000.0 * B_TRAIN / step_ms:.2f} clips/s; "
        f"one profiled step: {len(events)} device events, {total:.3f} ms summed, device busy "
        f"{busy:.3f} ms (union of intervals) in a {span:.3f} ms span "
        f"({100.0 * busy / span:.1f}% busy); the f32 backward (K5 f32) busy {k5:.3f} ms "
        f"({100.0 * k5 / busy:.1f}% of busy, {100.0 * k5 / step_ms:.1f}% of the step); "
        f"K6 (layer_norm_bwd, f32) device {k6_ms:.3f} ms in {len(k6)} kernels "
        f"({counts['layer_norm_bwd']} launches per step); "
        f"convolutions (kernel names with {'/'.join(CONV_WORDS)}) busy {conv:.3f} ms "
        f"({100.0 * conv / busy:.1f}% of busy), every other event busy {others:.3f} ms; "
        f"{streams} streams; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {kind} [{smi}]; loss "
        f"{float(m['total']):.3f}; phase {time.perf_counter() - t0:.1f} s")


def resize_add_phase(k4_call, recorders, plain):
    """K10, which no model path calls: the four task maps K4 summed in the
    main path's run added one by one into a zero bf16 accumulator (counts
    set to 0 just before, read just after), against K4's output on the same
    maps, then each call against K10's plain version. Returns K10's
    `kernels` row."""
    from diff_sal_tpu_torch.ops import kernels, resize

    (xs, out_hw), _ = k4_call
    ref = resize.bilinear_resize_sum(xs, out_hw)
    acc = torch.zeros((xs[0].shape[0],) + tuple(out_hw) + (xs[0].shape[-1],),
                      dtype=xs[0].dtype, device=xs[0].device)
    recorders["bilinear_resize_add"].on = True
    kernels.reset_launch_counts()
    for x in xs:
        acc = resize.bilinear_resize_add(acc, x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    recorders["bilinear_resize_add"].on = False
    assert counts["bilinear_resize_add"] == len(xs), counts
    # K10 rounds the running sum to bf16 after each map, K4 once: n + 1
    # roundings of partial sums, each within half a bf16 ulp (2^-8
    # relative) of a partial sum, which the sum of the terms' magnitudes
    # bounds (the resize of |x|: non-negative weights)
    mag = resize.bilinear_resize_sum_plain([x.float().abs() for x in xs], out_hw)
    diff = (acc.float() - ref.float()).abs()
    assert not bool((diff > 1e-2 + (len(xs) + 1) * 2.0**-8 * mag).any()), float(diff.max())
    log(f"[resize add] {len(xs)} launches from a zero accumulator vs K4's sum: max|d| "
        f"{float(diff.max()):.3e}")
    return hold_kernels(("bilinear_resize_add",), recorders, plain, counts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10, help="timed main-path iterations")
    ap.add_argument("--profile", action="store_true",
                    help="also print torch.profiler tables of one main-path run, one "
                         "training step, one DPM++ NFE 2 run with and without the "
                         "eval lowerings, the visual-only model's DDIM run and "
                         "training step in each layout, and each attention kernel's "
                         "recorded calls by CUDA kernel")
    cli = ap.parse_args()

    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from diff_sal_tpu_torch.config import (AudioAttnConfig, DataTransformConfig,
                                           ExperimentConfig, ModelConfig, MViTConfig,
                                           SalUNetConfig, SamplingConfig, VGGishConfig)
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel, build_model
    from diff_sal_tpu_torch.ops import attention, kernels, layernorm, mlp, pool, resize
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_train_step

    # -- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    secs = kernels.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s " + json.dumps(secs))
    logs = {k.source: k.build_log for k in kernels.registry().values()}
    for source, text in logs.items():
        for line in text.splitlines():
            # the forward attention's, K2's and K3's lines also name each template
            # instance; a warning line (C7514, C7512: wgmma serialised) is kept
            if ("Used" in line or "spill" in line or "warning" in line
                    or (source in ("attention.cu", "layernorm.cu", "mlp.cu",
                                   "attention_f32_fwd.cu", "cvt_attention.cu")
                        and "entry function" in line)):
                log(f"[ptxas {source}] {line.strip()}")

    # -- phase 3: main path -----------------------------------------------
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    cfg = main_config()
    model = build_model(cfg, seed=0, device=dev)
    schedule, sampling, data_cfg = make_schedule(), SamplingConfig(), DataTransformConfig()
    g = torch.Generator(device=dev).manual_seed(0)
    (H, W), T = cfg.decoder.img_size, cfg.visual.temporal_size
    inputs = [(torch.randn(B, T, H, W, 3, generator=g, device=dev) * 0.5,
               torch.randn(B, 9, H // 2, W // 2, 1, generator=g, device=dev)) for _ in range(3)]

    def run(i: int):
        rgb, audio = inputs[i % len(inputs)]
        return sample_saliency(model, schedule, sampling, data_cfg, rgb, audio,
                               generator=torch.Generator(device=dev).manual_seed(i))

    out = run(0)  # warm-up
    torch.cuda.synchronize()
    log(f"[main] model built and warmed up in {time.perf_counter() - t0:.1f} s")

    recorders = {
        "bias_attention": Recorder(attention, "bias_attention"),
        "layer_norm": Recorder(layernorm, "layer_norm"),
        "block_tail": Recorder(mlp, "block_tail"),
        "bilinear_resize_sum": Recorder(resize, "bilinear_resize_sum"),
        "bias_attention_bwd": Recorder(attention, "bias_attention_bwd"),
        "layer_norm_bwd": Recorder(layernorm, "layer_norm_bwd"),
        "cvt_attention": Recorder(attention, "cvt_cross_attention"),
        "resize_conv_relu": Recorder(resize, "resize_sum_conv_relu"),
        "resize_phase_head": Recorder(resize, "resize_sum_conv_relu_phase"),
        "depthwise_pool3d": Recorder(pool, "depthwise_pool3d"),
        "bilinear_resize_add": Recorder(resize, "bilinear_resize_add"),
        "fused_bias_attention": Recorder(attention, "fused_bias_attention"),
        "fused_bias_attention_bwd": Recorder(attention, "fused_bias_attention_bwd"),
    }
    for n in INFER_KERNELS:
        recorders[n].on = True
    kernels.reset_launch_counts()
    out = run(0)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for r in recorders.values():
        r.on = False
    assert tuple(out.shape) == (B, H, W, 1), out.shape
    assert bool(torch.isfinite(out).all()), "non-finite saliency map"
    lo, hi, std = float(out.min()), float(out.max()), float(out.std())
    assert 0.0 <= lo and hi <= 1.0 and std > 0.0, (lo, hi, std)
    missing = [n for n in INFER_KERNELS if counts[n] == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    check_launches(counts, path_launches(cfg, 1), "main path")
    log(f"[main] map {tuple(out.shape)} min {lo:.4f} max {hi:.4f} std {std:.5f}")
    log("[main] launches per run " + json.dumps(counts)
        + " per clip " + json.dumps({n: c / B for n, c in counts.items()}))

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(cli.iters):
        out = run(i)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / cli.iters
    assert bool(torch.isfinite(out).all()) and float(out.std()) > 0
    log(f"[main] {ms:.2f} ms per B={B} run, {1000.0 * B / ms:.2f} clips/s "
        f"({cli.iters} iters, rotating inputs) on {kind} [{smi}]")
    log(f"[main] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"phase {time.perf_counter() - t0:.1f} s")

    if cli.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(1)
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))

    # -- phase 4: each kernel against its plain version ---------------------
    t0 = time.perf_counter()
    plain = {
        "bias_attention": attention.bias_attention_plain,
        "layer_norm": layernorm.layer_norm_plain,
        "block_tail": mlp.block_tail_plain,
        "bilinear_resize_sum": resize.bilinear_resize_sum_plain,
        "bias_attention_bwd": attention.bias_attention_bwd_plain,
        "layer_norm_bwd": layernorm.layer_norm_bwd_plain,
        "cvt_attention": attention.reference_cvt_attention,
        "resize_conv_relu": resize.resize_sum_conv_relu_plain,
        "resize_phase_head": resize.resize_sum_conv_relu_lowres,
        "depthwise_pool3d": pool.pool_plain,
        "bilinear_resize_add": resize.bilinear_resize_add_plain,
        "fused_bias_attention": attention.fused_bias_attention_plain,
        "fused_bias_attention_bwd": attention.fused_bias_attention_bwd_plain,
    }
    plain.update({n: plain[n.removesuffix("_f32")] for n in F32_KERNELS})
    k4_call = recorders["bilinear_resize_sum"].calls[0]
    interpolate_sum(k4_call)
    # phase 11 casts the main path's K1 calls (and phase 9's K12 forward
    # calls) to f32; hold_kernels empties the recorders
    full_calls = {"bias_attention": list(recorders["bias_attention"].calls),
                  "block_tail": list(recorders["block_tail"].calls)}
    rows = hold_kernels(INFER_KERNELS, recorders, plain, counts, cli.profile)
    rows += resize_add_phase(k4_call, recorders, plain)
    del k4_call
    log(f"[kernels] phase {time.perf_counter() - t0:.1f} s")

    # -- phase 5: small input against the CPU reference --------------------
    t0 = time.perf_counter()
    small = ModelConfig(visual=MViTConfig.tiny(spatial_size=(64, 96)), audio=VGGishConfig(),
                        spatiotemp=AudioAttnConfig(), decoder=SalUNetConfig(img_size=(64, 96)))
    gc = torch.Generator().manual_seed(1)
    rgb_s, aud_s = torch.randn(2, 16, 64, 96, 3, generator=gc), torch.randn(2, 9, 32, 48, 1, generator=gc)
    noise_s = torch.randn(2, 64, 96, 1, generator=gc)
    cpu_model = build_model(small, seed=1, device="cpu")
    ref = sample_saliency(cpu_model, schedule, sampling, data_cfg, rgb_s, aud_s, noise=noise_s)
    gpu_model = VideoSaliencyModel(dataclasses.replace(small, compute_dtype="bfloat16")).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    got = sample_saliency(gpu_model.to(dev), schedule, sampling, data_cfg, rgb_s.to(dev),
                          aud_s.to(dev), noise=noise_s).cpu()
    small_err = float((got - ref).abs().max())
    # bf16 keeps ~3 significant digits; the map lies in [0, 1]
    assert small_err <= 3e-2, f"small-input map: bf16 on the card vs f32 on the CPU {small_err}"
    log(f"[small] bf16 card vs f32 CPU plain: max|d| {small_err:.3e} (limit 3e-2); "
        f"phase {time.perf_counter() - t0:.1f} s")
    del model, inputs, cpu_model, gpu_model

    # -- phase 6: the training step at full width ---------------------------
    t0 = time.perf_counter()
    tcfg = ExperimentConfig(model=main_config())
    tmodel = build_model(tcfg.model, seed=0, device=dev, train=True)
    opt = make_optimizer(tmodel, tcfg.optim, steps_per_epoch=1000, n_epochs=4)
    tstep = make_train_step(tmodel, schedule, tcfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = [{"rgb": torch.randn(B_TRAIN, T, H, W, 3, generator=gen, device=dev) * 0.5,
                "salmap": torch.rand(B_TRAIN, H, W, 1, generator=gen, device=dev),
                "audio": torch.randn(B_TRAIN, 9, H // 2, W // 2, 1, generator=gen, device=dev)}
               for _ in range(3)]
    torch.cuda.reset_peak_memory_stats()
    first_train_step(tstep, opt, batches[0], gen, dict(tmodel.named_parameters()), "train", t0)

    for n in TRAIN_KERNELS:
        recorders[n].on = True
    kernels.reset_launch_counts()
    m1 = tstep(opt, batches[1], gen)
    torch.cuda.synchronize()
    tcounts = kernels.launch_counts()
    for r in recorders.values():
        r.on = False
    assert np.isfinite(float(m1["total"])), m1
    missing = [n for n in ("bias_attention", "layer_norm", "bilinear_resize_sum")
               + TRAIN_KERNELS if tcounts[n] == 0]
    assert not missing, f"kernels not launched in the training step: {missing}"
    check_launches(tcounts, path_launches(tcfg.model, train=True), "train step")
    log("[train] launches per step " + json.dumps(tcounts)
        + " per clip " + json.dumps({n: c / B_TRAIN for n, c in tcounts.items()}))

    start.record()
    for i in range(TRAIN_ITERS):
        m = tstep(opt, batches[i % len(batches)], gen)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / TRAIN_ITERS
    assert np.isfinite(float(m["total"])) and float(m["grad_norm"]) > 0, m
    log(f"[train] {step_ms:.2f} ms per B={B_TRAIN} step, {1000.0 * B_TRAIN / step_ms:.2f} "
        f"clips/s ({TRAIN_ITERS} steps, rotating batches) on {kind} [{smi}]; loss "
        f"{float(m['total']):.2f}, grad_norm {float(m['grad_norm']):.2f}")
    log(f"[train] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"phase {time.perf_counter() - t0:.1f} s")

    if cli.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tstep(opt, batches[2], gen)
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))

    t0 = time.perf_counter()
    full_calls["bias_attention_bwd"] = list(recorders["bias_attention_bwd"].calls)
    rows += hold_kernels(TRAIN_KERNELS, recorders, plain, tcounts, cli.profile)
    log(f"[train kernels] phase {time.perf_counter() - t0:.1f} s")
    del tmodel, opt, batches

    # -- phase 7: one small training step against the CPU -------------------
    t0 = time.perf_counter()
    hw = (128, 96)  # the coarsest grid (4, 3) keeps >1 CvT key: every sub-network learns
    small_t = ModelConfig(visual=MViTConfig.tiny(spatial_size=hw), audio=VGGishConfig(),
                          spatiotemp=AudioAttnConfig(),
                          decoder=SalUNetConfig(img_size=hw, dropout=0.0,
                                                drop_path_rate=(0.0,) * 4))
    sd = build_model(small_t, seed=3, device="cpu").state_dict()
    gc = torch.Generator().manual_seed(4)
    batch_s = {"rgb": torch.randn(2, 16, *hw, 3, generator=gc),
               "salmap": torch.rand(2, *hw, 1, generator=gc),
               "audio": torch.randn(2, 9, hw[0] // 2, hw[1] // 2, 1, generator=gc)}
    draws = {"deq": torch.randn(2, *hw, 1, generator=gc),
             "noise": torch.randn(2, *hw, 1, generator=gc), "t": torch.tensor(300)}

    def small_step(dtype: str, device):
        m = VideoSaliencyModel(dataclasses.replace(small_t, compute_dtype=dtype)).train()
        m.load_state_dict(sd)
        m.to(device)
        ecfg = ExperimentConfig(model=m.cfg)
        met = make_train_step(m, schedule, ecfg)(make_optimizer(m, ecfg.optim, 10, 2),
                                                 batch_s, draws=draws)
        return float(met["total"]), {n: p.grad.float().cpu() for n, p in m.named_parameters()
                                     if p.grad is not None}

    l32, g32 = small_step("float32", "cpu")
    l16c, g16c = small_step("bfloat16", "cpu")
    l16, g16 = small_step("bfloat16", dev)
    cpu_stats, cpu_worst = grad_agreement(g16c, g32)
    card_stats, card_worst = grad_agreement(g16, g32)
    loss_err = abs(l16 - l32) / abs(l32)
    log(f"[small train] loss f32 CPU {l32:.4f}, bf16 CPU {l16c:.4f}, bf16 card {l16:.4f} "
        f"(rel {loss_err:.3e}, limit 2e-2)")
    log("[small train] gradients vs f32 CPU (relative L2, cosine): bf16 plain CPU "
        + json.dumps(cpu_stats) + f" worst tensor {cpu_worst}; bf16 kernels card "
        + json.dumps(card_stats) + f" worst tensor {card_worst}")
    # bf16 rounding alone moves these gradients by ~0.2 in relative L2 at
    # this size (the CPU's bf16 plain path above; JAX's bf16 step lands as
    # far from f64, tests/test_torch_train_step.py): the kernels may not do
    # worse than twice that plus 0.05, must keep every sub-network's
    # direction (cosine >= 0.9) and give no tensor a gradient as far off
    # as a dropped one (relative L2 1)
    assert loss_err <= 2e-2, loss_err
    for sub, (rel, cos) in card_stats.items():
        assert rel <= 2 * cpu_stats[sub][0] + 0.05 and cos >= 0.9, (sub, rel, cos)
    assert card_worst[0] < 0.75, card_worst
    assert set(g16) == set(g32), set(g16) ^ set(g32)
    log(f"[small train] phase {time.perf_counter() - t0:.1f} s")

    # -- phase 8: DPM-Solver++ with the eval lowerings at full width ---------
    t0 = time.perf_counter()
    rows += dpm_phase(cli, dev, schedule, data_cfg, recorders, plain, kind, smi, full_calls)
    log(f"[dpm] phase {time.perf_counter() - t0:.1f} s")

    # -- phase 9: the visual-only model in both MViT layouts ----------------
    t0 = time.perf_counter()
    rows += visual_only_phase(cli, dev, schedule, data_cfg, recorders, plain, kind, smi,
                              full_calls)
    log(f"[visual] phase {time.perf_counter() - t0:.1f} s")

    # -- phase 10: f32 through the kernels' f32 instances -----------------
    t0 = time.perf_counter()
    rows += f32_phase(dev, schedule, data_cfg, recorders, plain)
    log(f"[f32] phase {time.perf_counter() - t0:.1f} s")

    # -- phase 11: the f32 attention and K7 at full width -------------------
    t0 = time.perf_counter()
    f32_block_phase(full_calls)
    f32_backward_phase(full_calls)
    f32_cvt_phase(full_calls["cvt_attention"])
    f32_tail_phase(full_calls["block_tail"])
    f32_conv_phase(full_calls["resize_conv_relu"])
    del full_calls
    log(f"[f32 full width] phase {time.perf_counter() - t0:.1f} s")

    # -- phase 12: the f32 training step at full width -----------------------
    f32_train_phase(dev, schedule, kind, smi)

    log("[device time] profiler sessions " + json.dumps(DEVICE_MS_TALLY))
    log(f"[total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
