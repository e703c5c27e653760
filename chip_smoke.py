"""Drive the PyTorch port's paths (AV inference with DDIM, the AV training
step, AV inference with DPM-Solver++ and the eval lowerings, the
visual-only model in both MViT layouts, both models in f32, the f32
attention and training step at full width, the AV trainer from a packed
tree on disk to its checkpoints, the entry points: the CLI, the device
metrics, adaptive DPM-Solver and the int8 MLPs, the import of the
reference's released checkpoints and MViT's `remat`, data parallelism
over torch.distributed, MViT without its cls token and the random-pyramid
ablation, tensor parallelism on a ('data', 'model') mesh) on one NVIDIA
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
 13. the trainer from disk to checkpoint at full width (`trainer_phase`):
     a packed AV tree written with numpy into a temporary directory (4 train
     and 2 test videos of 160 frames at 224x384, 16 kHz waves), then
     `train_av_splits` with the AV config in bf16, B=4, 2 epochs of 3 steps
     and one validation batch each, every step running the log-mel frontend
     and the uint8 STAViS normalization on the card; checks the logs (one
     finite row per epoch), the checkpoints and `best.json`, the launches
     of the whole run (6 steps and 2 evaluations by `path_launches`), a
     bitwise resume and `restore_best` in a new trainer, and the card's
     frontend against the numpy one (MEL_TOL); prints ms per step by CUDA
     events, the StepTimer's times, the loader's wait per epoch and the
     seconds per checkpoint save and restore; with --profile, one more
     epoch of the resumed trainer's `fit` under torch.profiler (the
     device's busy share of its wall time, the save's and the loader's);
 14. the entry points at full width (`entry_phase`), in a temporary
     directory: `cli.main(["train-visual", ...])` in process on packed
     DHF1k trees written with numpy (`write_packed_dhf1k_tree`: 81 and 36
     frames at 224x384, one B=4 step and one validation batch, bf16):
     the checkpoint, `best.json`, one finite log row and the whole run's
     launches against `path_launches` (one step, one DDIM run); then the
     device metrics (`metrics/device.py`) on the card on the maps of that
     trainer's `evaluate` after `restore_best` (generator seed 0), the
     fixations the GT's top 2% of pixels, against the numpy metrics on the
     CPU (NSS, CC, SIM within METRIC_TOL of max(1, |x|), AUC-Judd within
     AUC_TOL); then `python -m diff_sal_tpu_torch.cli train-av` as a
     subprocess on a packed AV tree (`write_packed_av_tree`, split1, bf16,
     B=4) warm-started from train-visual's weights: rc 0, a checkpoint per
     epoch (4) and `best.json`, and its "warm start: N parameters
     loaded" line with N > 0; then on phase 3's AV model, inputs and noise
     (rebuilt from their seeds): `adaptive_sample` (DPM-Solver++, orders 2
     and 3, default atol / rtol) with its NFE, accepted and rejected steps,
     the launches against `path_launches(nfe=NFE + 1)` and ms per run;
     `dpm_solver_sample(wrapped_eps_fn=model_wrapper(x_start))` at NFE 2
     within 3e-2 of DPM++ NFE 2; the model with `mlp_quant` "w8" and
     "w8a8" (weights by `quantize_state_dict`): DDIM NFE 1 maps checked,
     launches equal to phase 3's, MViT's pyramid within QUANT_TOL of the
     fp model's (max|d| / max|x| and relative L2), and ms per run of the
     three models timed in turns;
 15. the released-checkpoint import and MViT's `remat` at full width
     (`import_phase`, `remat_phase`): (a) phase 3's model (rebuilt from
     its seed) written as a reference-format DiffSal best.pth into a
     temporary directory (`module.` prefixes, VGGish's FC head at its
     reference size, AudioAttnNet's dead patch and position embeddings,
     random off-centre slices in every CvT q projection, one key outside
     the model); (b) imported through `diff_sal_tpu_torch.scripts.
     import_reference_ckpt`, read back by the CLI's `_best_state_dict`
     and loaded strictly into a fresh model on the card: the drop report
     names exactly the planted keys, DDIM NFE 1 on phase 3's inputs and
     noise gives phase 3's map (bound 0: the same weights through the same
     kernels) with `path_launches(cfg)`; the import's seconds and the
     file's GiB; (c) a `backbone.` file of the same MViT with a classifier
     key, imported with `--kind mvit` and warm-started into a fresh AV
     trainer: visual_net equal to the source's, every other entry (the
     decoder's BatchNorm statistics among them, F8) its initial value;
     (d) the AV bf16 step at B=4 (phase 6's recipe and checks) from seed-0
     weights with `remat` off, on and off again, the same batch and draws:
     the losses equal (the same forward runs), gradients per sub-network
     within REMAT_GRAD_RL2 relative L2 (off against off again, the card's
     own spread, held to it too), launches equal to
     `path_launches(train=True)` (with `remat`, MViT's K1 and K2 forward
     launches again in the backward), peak memory (each run's gradients
     kept on the host, so no run's peak holds another's) and ms per step
     by CUDA events of each; (e) the AV step in f32 at the reference's
     per-card batch (F32_REF_BATCH) with `remat` (one step with phase 6's
     checks, one timed): finite loss, ms per step, peak memory; then the
     same batch without `remat` (its loss equal, its ms and peak, or that
     it does not fit);
 16. data parallelism (`dp_phase`): the plain references first (one
     process: DDIM NFE 1 and DPM++ 2M NFE 2 on a B=4 batch whose last row
     is padding, and the AV step at B=4 from phase 6's weights and batch
     in bf16 and in f32, the decoder's dropout and DropPath 0: each rank
     draws its own masks); (a)-(b) two ranks on the one card through gloo
     (this script with `--dp-spec`, subprocesses on a free port): the two
     evaluations (all-reduced scores within DP_SCORE_TOL, each rank's maps
     its rows of one process's within DP_MAP_TOL, launches
     `path_launches(nfe)`), then the step in bf16 (loss within
     DP_LOSS_RTOL, each sub-network's gradient direction, cosine >=
     LAYOUT_GRAD_COS: at half the batch bf16 rounds at other points) and
     in f32 (loss, gradients within REMAT_GRAD_RL2 relative L2 per
     sub-network, BatchNorm statistics within DP_STATS_RL2), parameters
     and buffers bitwise equal across the ranks, launches as
     `path_launches(train=True)` / `f32_launches`; (c) one rank through
     NCCL, the step at B=4 in both dtypes, held as (a)'s; ms per step by
     CUDA events of the plain step, of (c) and of each rank of (a); (d)
     `train-av` under `torch.distributed.run` with two ranks (this script
     with `--dp-cli`, the AV protocol cut to 2 epochs) on a packed tree of
     7 training windows: one header and one row per epoch in each log, a
     checkpoint per epoch, the logged loss the mean of the ranks' own.
     Every launch has a timeout; a failed or late process ends the others;
 17. the two model modes (`modes_phase`): (1) the visual-only model with
     `with_cls_token=False` at full width in bf16 (MViT's attention in
     plain torch, JAX's einsum path; no K1, K11 or K12): DDIM NFE 1 at B=2
     (map checked, launches against `path_launches`) and the training step
     at B=4 (finite loss and gradients, `cls_token` and the finest scale's
     norm the only trainable tensors off the graph, launches per step, peak
     memory), each beside the cls-token model on the same weights: ms per
     run and per step by CUDA events, in turns, and the profiler's device
     time of one run and one step (`device_ms`); (2) the same mode small (MViT
     tiny at 128x96) in f32, the card against the CPU with phase 10's
     bounds and `f32_launches`; (3) the random-pyramid ablation
     (`visual=None`) at 224x384 in bf16: the pyramid's shapes and dtypes
     (JAX's: the rgb's, uint8 normalised to f32), equal per seed and fresh
     per seed, `ValueError` without a generator (also from
     `sample_saliency` and the train step, as in JAX), the decoder-only
     forward at B=2 and one backward of the MSE on x0 at B=4 in train mode
     (gradients finite, peak memory), the AV ablation's forward at B=2,
     each with its launches against `path_launches`;
 18. tensor parallelism (`tp_phase`): four ranks sharing the one card
     through gloo (this script with `--tp-spec`, subprocesses on a free
     port) as a (2 data x 2 model) mesh (`parallel/mesh.make_device_mesh`),
     phase 3's model with JAX's rule's parameters sharded on 'model'
     (`parallel/tensor.shard_model`, min_dim 256: 107 weights). (a) DDIM
     NFE 1 on phase 3's inputs and noise, one row per data rank: each
     rank's map against its row of phase 3's map within TP_MAP_TOL; (b)
     every rank's launches per run against `path_launches` (K1-K4 run on
     the gathered activations, K3 on gathered weights); (c) each rank's
     parameter and buffer bytes against the rule's prediction and the whole
     model's; (d) one bf16 loss backward (MSE on x0 at TP_STEP, phase 16's
     config) at B=2 on the mesh, the gradients averaged over 'data' and the
     shards gathered, against one process's on the same batch: cosine >=
     LAYOUT_GRAD_COS per sub-network, the replicated gradients bitwise equal
     down each model column; ms per DDIM run by events of one process (B=2)
     and of each rank (B=1), as a record;
then prints the `kernels` JSON line, the nvidia-smi line and, last, the
result line {"ok": true, "device": {...}}. The f32 instances' bound takes
their matrix products at split TF32's rate (495 / 3 TFLOP/s: f32's accuracy
on the tensor cores); K7 adds one `[shape ...]` line per (Bt, L, C).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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
    zero up to rounding left out), summed in f64: an f32 cosine over tens
    of millions of entries on the host reads above 1."""
    top = max(float(v.abs().max()) for v in ref.values())
    names = [n for n in ref if float(ref[n].abs().max()) > 1e-6 * top]
    stats = {}
    for sub in ("visual_net", "spatiotemp_net", "decoder_net", "all"):
        ns = [n for n in names if sub == "all" or n.startswith(sub + ".")]
        if not ns:  # the visual-only model has no audio branch
            continue
        a = torch.cat([got[n].flatten() for n in ns]).double()
        b = torch.cat([ref[n].flatten() for n in ns]).double()
        stats[sub] = (float((a - b).norm() / b.norm()),
                      float(torch.nn.functional.cosine_similarity(a, b, dim=0)))
    worst = max(((float((got[n] - ref[n]).norm() / ref[n].norm()), n) for n in names))
    return stats, worst


def first_train_step(tstep, opt, batch, gen, params, what, t0):
    """The AV model's first training step from fresh weights, and phase 6's
    checks: finite loss and gradient norm, a finite gradient on every
    trainable parameter on the graph, non-zero gradients in MViT,
    AudioAttnNet and the decoder, none on the frozen VGGish, parameters
    moved. Returns the step's metrics."""
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
    return m0


def lowered_config(cfg):
    """`cfg` with the three eval lowerings: the MViT pools through K11, the
    CvT attention through K7 and the head as conv-at-low-res through K9."""
    return dataclasses.replace(
        cfg, visual=dataclasses.replace(cfg.visual, pool_mode="pallas"),
        decoder=dataclasses.replace(cfg.decoder, fused_attn=True, head_lowres=True))


def path_launches(cfg, nfe: int = 1, train: bool = False, fused_head: bool = False):
    """Launches of each kernel in one `sample_saliency` run of `cfg` with
    `nfe` denoiser calls, or (`train`) in one training step, from the
    config's structure: the encoders run once per map or step (MViT's
    blocks twice in a step with `remat`), the decoder once per call; the
    eval lowerings (K3, K7, K8, K9) at eval only. With
    `fused_head` (the head module's field, which no config sets) the head
    runs through K8 unless `head_lowres` takes it through K9. MViT without
    its cls token runs 5 LayerNorms per block and its attention in plain
    torch (no K1, K11 or K12); `visual=None` (the random-pyramid ablation)
    launches nothing for the visual side."""
    from diff_sal_tpu_torch.models.mvit import block_plan

    v, d = cfg.visual, cfg.decoder
    stages = d.mid_num_stages  # one TransformerBlock each
    calls = 1 if train else nfe
    # AudioAttnNet (AV model only): two per layer and a final one; the
    # decoder per call: each block's norm and its q, k and v token norms,
    # one per stage output, and norm2, which runs inside K3 at eval
    audio = 2 * cfg.spatiotemp.depth + 1 if cfg.spatiotemp is not None else 0
    ln = audio + calls * (6 if train else 5) * stages
    want = {name: 0 for name in KERNELS}
    # LayerNorm backwards off the graph: the finest pyramid scale's norm
    # (the decoder never reads it) and the last block's norm2 of the cls
    # row (its output is never read)
    off_graph = 0
    if v is not None:
        # MViT per block: norm1 and norm2 (on the spatial rows, and again on
        # the cls row), norm_q/k/v (cls and spatial rows in one launch);
        # one norm per emitted scale
        per_block = 7 if v.with_cls_token else 5
        ln += per_block * v.num_layers + len(v.out_scales)
        off_graph = 2 if v.with_cls_token else 1
        # with `remat` a step runs every MViT block's forward again in the
        # backward: its attention, its LayerNorms and its pools (the emitted
        # scales' norms sit outside the blocks)
        again = 2 if train and v.remat else 1
        want["layer_norm"] += (again - 1) * per_block * v.num_layers
        if v.with_cls_token:
            # one pool per block where q and kv share a stride, else a q and
            # a kv pool; K11 only with the cls stream (the token-concat
            # layout pools by convolution, as in JAX)
            pools = sum(1 if p["stride_q"] == p["stride_kv"] else 2 for p in block_plan(v))
            attn = "bias_attention" if v.cls_stream else "fused_bias_attention"
            want[attn] = again * v.num_layers
            want["depthwise_pool3d"] = (again * pools if v.pool_mode == "pallas"
                                        and v.cls_stream else 0)
            if train:
                want[attn + "_bwd"] = v.num_layers
    want["layer_norm"] += ln
    if train:
        # every LayerNorm backward but those off the graph; the
        # resize-sum's backward is plain math
        want.update({"layer_norm_bwd": ln - off_graph, "bilinear_resize_sum": 1})
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


# phase 13: the packed AV tree the trainer reads, written with numpy alone in
# PackedAVDataset's layout (`data/synthetic.write_packed_av_tree`): one dataset,
# split1 with 4 train and 2 test videos of 160 frames at 25 fps. The default
# windows (a step of 90 - 16 = 74 frames) give 3 windows per video: 12 train
# windows, 3 steps of B=4 per epoch, and 6 test windows, one validation batch
TRAINER_FRAMES, TRAINER_FPS = 160, 25.0
TRAINER_FOLDS = {"train": tuple((v, TRAINER_FRAMES) for v in ("t1", "t2", "t3", "t4")),
                 "test": (("e1", TRAINER_FRAMES), ("e2", TRAINER_FRAMES))}
TRAINER_EPOCHS = 2
# the device frontend against the numpy one: the JAX package's own bound for
# its device path against its host path (tests/test_audio_mel.py:54-60)
MEL_TOL = 2e-4


def profiled_fit(t, config, packed, timed_save, timed_iter, saves, waits, kind, smi):
    """Phase 13 with --profile: one more epoch of the resumed trainer's
    `fit` (a new epoch's loaders, as `train_av_splits` builds them) under
    torch.profiler, with the phase's timing hooks on `_save` and the
    loader; the device's busy share of the epoch's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diff_sal_tpu_torch.data.loader import Loader
    from diff_sal_tpu_torch.data.packed import PackedAVDataset
    from diff_sal_tpu_torch.train.trainer import Trainer

    n_saves, n_waits = len(saves), len(waits)
    train = Loader(PackedAVDataset(packed, config, "split1", True), B_TRAIN, shuffle=True)
    val = Loader(PackedAVDataset(packed, config, "split1", False), B_TRAIN, shuffle=False)
    t.n_epochs = TRAINER_EPOCHS + 1
    save, loader_iter = Trainer._save, Loader.__iter__
    Trainer._save, Loader.__iter__ = timed_save, timed_iter
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            t.fit(train, val, log_name="split1")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e3
    finally:
        Trainer._save, Loader.__iter__ = save, loader_iter
    assert t.epoch == TRAINER_EPOCHS + 1, t.epoch
    save_ms = sum(saves[n_saves:]) * 1e3
    wait_ms = sum(r["wait"] for r in waits[n_waits:] if r["loader"] == id(train)) * 1e3
    del saves[n_saves:], waits[n_waits:]
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and e.time_range.start >= 0]
    busy = busy_ms(events)
    log(f"[trainer profile] one epoch of Trainer.fit (3 steps, the checkpoint save, one "
        f"validation batch): wall {wall:.1f} ms, {len(events)} device events, device busy "
        f"{busy:.1f} ms (union of intervals): {100.0 * busy / wall:.1f}% busy, "
        f"{100.0 - 100.0 * busy / wall:.1f}% idle (with the profiler's own host cost); the "
        f"save {save_ms:.1f} ms ({100.0 * save_ms / wall:.1f}%), the train loader's wait "
        f"{wait_ms:.1f} ms ({100.0 * wait_ms / wall:.1f}%); StepTimer step "
        f"{t.timer.step_time.avg * 1e3:.2f} ms, data {t.timer.data_time.avg * 1e3:.2f} ms "
        f"on {kind} [{smi}]")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))


def trainer_phase(dev, kind, smi, profile=False):
    """Phase 13: the AV fine-tune protocol from disk to checkpoint at full
    width. `train_av_splits` with `ModelConfig.audio_visual()` in bf16 on
    a packed tree (`write_packed_av_tree`) in a temporary directory:
    split1, B=4, 2 epochs of 3 steps, each followed by one validation batch
    (DDIM NFE 1), log_freq 1. Every step reads uint8 frames (STAViS
    normalization in the model) and 16 kHz excerpts (the log-mel frontend
    in the step) on the card. Checks: every logged loss and score finite,
    one row per epoch in `split1/split1.log` and `split1/split1_val.log`,
    a checkpoint per epoch and `best.json` on the epoch with the higher val
    total, the kernels' launches in the whole run equal to 6 training steps
    and 2 evaluations by `path_launches`; a new Trainer on the workdir
    resumes at epoch 2, step 6 with the second checkpoint's parameters,
    buffers and Adam moments bit for bit (and the trained trainer's), and
    logs the same lr; `restore_best` loads the best epoch's state_dict bit
    for bit; the card's f32 `log_mel_examples` on the phase's excerpts
    within MEL_TOL of the numpy frontend. Prints the StepTimer's step and
    data times, ms per step by CUDA events, the loader's wait as a share of
    each epoch, seconds per checkpoint save and restore, and the phase's
    wall time. With `profile`, the resumed trainer's `fit` runs one more
    epoch (3 steps, the checkpoint save and the validation batch) under
    torch.profiler: the device's busy time (the union of its events'
    intervals) against the epoch's wall time, with the save's and the
    train loader's wait's shares of that wall time."""
    import os
    import shutil
    import tempfile

    from diff_sal_tpu_torch.audio.mel import log_mel_examples, waveform_to_examples_np
    from diff_sal_tpu_torch.config import ExperimentConfig, ModelConfig, TrainingConfig
    from diff_sal_tpu_torch.data import loader as loader_mod
    from diff_sal_tpu_torch.data.packed import PackedAVDataset
    from diff_sal_tpu_torch.data.synthetic import write_packed_av_tree
    from diff_sal_tpu_torch.ops import kernels
    from diff_sal_tpu_torch.train import trainer as trainer_mod

    t0 = time.perf_counter()
    cfg = ExperimentConfig(model=ModelConfig.audio_visual(compute_dtype="bfloat16"),
                           training=TrainingConfig(batch_size=B_TRAIN, log_freq=1,
                                                   n_epochs_for_av_data=TRAINER_EPOCHS))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    Trainer, Loader = trainer_mod.Trainer, loader_mod.Loader
    init_state, save, loader_iter = Trainer.init_state, Trainer._save, Loader.__iter__
    step_events, saves, waits = [], [], []

    def timed_init(self, *a, **kw):
        out = init_state(self, *a, **kw)
        step = self.train_step

        def timed_step(opt, batch, gen):
            assert batch["rgb"].dtype == torch.uint8 and "audio" not in batch, sorted(batch)
            assert batch["wave"].device.type == torch.device(dev).type, batch["wave"].device
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            m = step(opt, batch, gen)
            ev[1].record()
            step_events.append(ev)
            return m

        self.train_step = timed_step
        return out

    def timed_save(self, epoch):
        t = time.perf_counter()
        save(self, epoch)
        saves.append(time.perf_counter() - t)

    def timed_iter(self):
        rec = {"epoch": self.epoch, "n": 0, "wait": 0.0, "first": not any(
            r["loader"] == id(self) for r in waits), "loader": id(self)}
        waits.append(rec)
        it, start = loader_iter(self), time.perf_counter()
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                rec["wall"] = time.perf_counter() - start
                return
            rec["wait"] += time.perf_counter() - t
            rec["n"] += 1
            yield batch

    try:
        config = write_packed_av_tree(os.path.join(tmp, "packed"), cfg.model.decoder.img_size,
                                      TRAINER_FOLDS, TRAINER_FPS, seed=13)
        t_tree = time.perf_counter() - t0
        Trainer.init_state, Trainer._save, Loader.__iter__ = timed_init, timed_save, timed_iter
        try:
            kernels.reset_launch_counts()
            t_fit = time.perf_counter()
            t = trainer_mod.train_av_splits(cfg, config, os.path.join(tmp, "work"),
                                            splits=("split1",),
                                            packed_root=os.path.join(tmp, "packed"),
                                            device=dev)["split1"]
            torch.cuda.synchronize()
            t_fit = time.perf_counter() - t_fit
            counts = kernels.launch_counts()
        finally:
            Trainer.init_state, Trainer._save, Loader.__iter__ = init_state, save, loader_iter
        steps = TRAINER_EPOCHS * 3
        assert t.cfg.model.uint8_norm == "stavis", t.cfg.model.uint8_norm
        assert (t.epoch, t.global_step, len(step_events)) == (TRAINER_EPOCHS, steps, steps)
        rows, val = [], []
        for out, name in ((rows, "split1.log"), (val, "split1_val.log")):
            with open(os.path.join(t.workdir, name)) as f:
                out.extend(r.rstrip("\n").split("\t") for r in f)
        assert rows[0] == trainer_mod.TRAIN_COLUMNS and val[0] == trainer_mod.VAL_COLUMNS
        assert len(rows) == len(val) == TRAINER_EPOCHS + 1, (rows, val)
        for r in rows[1:] + val[1:]:
            assert all(np.isfinite(float(x)) for x in r), r
        assert t.ckpt.all_steps() == list(range(TRAINER_EPOCHS)), t.ckpt.all_steps()
        totals = [float(r[1]) for r in val[1:]]
        best = t.ckpt.best()
        assert best["step"] == int(np.argmax(totals)) and best["score"] == max(totals), best
        train_want = path_launches(t.cfg.model, train=True)
        eval_want = path_launches(t.cfg.model, nfe=1)
        want = {n: steps * train_want[n] + TRAINER_EPOCHS * eval_want[n] for n in train_want}
        check_launches(counts, want, "trainer")
        log(f"[trainer] {steps} steps and {TRAINER_EPOCHS} validation batches: launches "
            + json.dumps({n: c for n, c in counts.items() if c}) + " = "
            f"{steps} x path_launches(train=True) + {TRAINER_EPOCHS} x path_launches(nfe=1); "
            f"train log {rows[1:]}; val log {val[1:]}; best {best}")

        # resume and restore_best in a new trainer on the same workdir
        t_new = time.perf_counter()
        t2 = Trainer(t.cfg, t.workdir, steps_per_epoch=3, n_epochs=TRAINER_EPOCHS, device=dev)
        t2.init_state()
        t_new = time.perf_counter() - t_new
        t_resume = time.perf_counter()
        t2.resume()
        torch.cuda.synchronize()
        t_resume = time.perf_counter() - t_resume
        assert (t2.epoch, t2.global_step) == (TRAINER_EPOCHS, steps), (t2.epoch, t2.global_step)
        last = t.ckpt.restore(TRAINER_EPOCHS - 1, map_location=dev)
        names = t2._trainable_names()
        mine = t2.optimizer.state_dict(names)
        for src in (last, {"state_dict": t.model.state_dict(),
                           "optim_dict": t.optimizer.state_dict(names)}):
            sd = src["state_dict"]
            assert set(sd) == set(t2.model.state_dict())
            for k, v in t2.model.state_dict().items():
                assert torch.equal(v, sd[k]), k
            for key in ("mu", "nu"):
                for k in names:
                    assert torch.equal(mine[key][k], src["optim_dict"][key][k]), (key, k)
        assert mine["count"] == last["optim_dict"]["count"] == steps
        assert repr(t2.lr_schedule(t2.global_step)) == rows[-1][-1], (rows[-1], t2.global_step)
        t_best = time.perf_counter()
        t2.restore_best()
        torch.cuda.synchronize()
        t_best = time.perf_counter() - t_best
        best_sd = t.ckpt.restore(best["step"], map_location=dev)["state_dict"]
        for k, v in t2.model.state_dict().items():
            assert torch.equal(v, best_sd[k]), k
        del last, best_sd, mine
        if profile:
            profiled_fit(t2, config, os.path.join(tmp, "packed"), timed_save, timed_iter,
                         saves, waits, kind, smi)
        del t2

        # the card's frontend against the numpy frontend on the phase's waves
        ds = PackedAVDataset(os.path.join(tmp, "packed"), config, "split1", True)
        waves = np.stack([ds[i]["wave"] for i in range(len(ds))])
        got = log_mel_examples(torch.from_numpy(waves).to(dev)).cpu().numpy()
        host = np.stack([waveform_to_examples_np(w, 16000) for w in waves])
        mel_err = float(np.abs(got - host).max())
        assert got.shape == host.shape == (len(ds), 9, 64, 64) and mel_err <= MEL_TOL, mel_err
        size = sum(os.path.getsize(t.ckpt.path(s)) for s in range(TRAINER_EPOCHS)) / TRAINER_EPOCHS
        t.model = t.optimizer = None  # the card's memory
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    ms = [a.elapsed_time(b) for a, b in step_events]
    train_iters = [r for r in waits if r["n"] == 3]
    assert len(train_iters) == TRAINER_EPOCHS, waits
    timer = t.timer
    log(f"[trainer] ms per step by CUDA events (B={B_TRAIN}, {steps} steps, 2 epochs): "
        + ", ".join(f"{x:.2f}" for x in ms) + f"; mean of the last {steps - 1} "
        f"{np.mean(ms[1:]):.2f} ms; StepTimer (last epoch, mean per step): step "
        f"{timer.step_time.avg * 1e3:.2f} ms (the host's dispatch of the step), data "
        f"{timer.data_time.avg * 1e3:.2f} ms (the loader's wait and, at log_freq 1, the "
        f"log point's wait for the step's metrics) on {kind} [{smi}]")
    log("[trainer] the train loader's wait for a batch, per epoch: "
        + "; ".join(f"epoch {r['epoch']}: {r['wait'] * 1e3:.1f} ms of a {r['wall'] * 1e3:.1f} ms "
                    f"epoch ({100.0 * r['wait'] / r['wall']:.1f}%)" for r in train_iters)
        + f"; its first batch (init_state's sample) "
        + ", ".join(f"{r['wait'] * 1e3:.1f} ms" for r in waits if r["first"] and "wall" not in r))
    log(f"[trainer] checkpoints: {size / 2**30:.2f} GiB each; save "
        + ", ".join(f"{x:.2f}" for x in saves) + f" s; new trainer {t_new:.2f} s, resume "
        f"(load + copy) {t_resume:.2f} s, restore_best {t_best:.2f} s; frontend on the card "
        f"vs numpy max|d| {mel_err:.3e} (limit {MEL_TOL}); packed tree written in "
        f"{t_tree:.1f} s; train_av_splits {t_fit:.1f} s; phase "
        f"{time.perf_counter() - t0:.1f} s on {kind} [{smi}]")


# phase 14: the entry points. Packed DHF1k trees for `train-visual`: 81
# frames give 4 training windows (len_snippet 32, a step of 16), one B=4
# step; 36 frames give 4 validation windows (a step of 1), one batch. The
# AV tree for the `train-av` subprocess: 2 + 2 videos of 160 frames at
# 25 fps, 3 windows each, one B=4 step and one validation batch per epoch
ENTRY_TRAIN_FRAMES, ENTRY_VAL_FRAMES = 81, 36
ENTRY_AV_FOLDS = {"train": (("t1", 160), ("t2", 160)), "test": (("e1", 160), ("e2", 160))}
# the device metrics against the numpy ones on the same maps: NSS, CC and
# SIM within 1e-4 of max(1, |value|) (f32 sums over 86016 pixels against
# f64); AUC-Judd within 5e-3, the numpy metric's 1e-7 jitter breaking the
# ties the batched one averages (tests/test_metrics.py:47)
METRIC_TOL, AUC_TOL = 1e-4, 5e-3
# the quantised MViT's pyramid against the fp one: tests/test_quant.py's
# bound (max|d| / max|x|), and here also as relative L2
QUANT_TOL = 0.08
ENTRY_ITERS = 3  # timed runs per model, in turns


def entry_phase(dev, kind, smi, schedule, data_cfg):
    """Phase 14: the entry points at full width (see the module docstring).
    Returns nothing; any failed check raises."""
    import os
    import shutil
    import tempfile

    from diff_sal_tpu_torch import cli as port_cli
    from diff_sal_tpu_torch.config import TrainingConfig
    from diff_sal_tpu_torch.data.loader import Loader
    from diff_sal_tpu_torch.data.packed import PackedVideoDataset
    from diff_sal_tpu_torch.data.synthetic import write_packed_av_tree, write_packed_dhf1k_tree
    from diff_sal_tpu_torch.metrics import device as metrics_device
    from diff_sal_tpu_torch.metrics import saliency as metrics_np
    from diff_sal_tpu_torch.ops import kernels
    from diff_sal_tpu_torch.train import trainer as trainer_mod

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    try:
        # -- 1. train-visual, in process ----------------------------------
        hw = visual_config().decoder.img_size
        train_root = write_packed_dhf1k_tree(os.path.join(tmp, "dhf1k_train"), hw,
                                             {"1": ENTRY_TRAIN_FRAMES}, seed=14)
        val_root = write_packed_dhf1k_tree(os.path.join(tmp, "dhf1k_val"), hw,
                                           {"601": ENTRY_VAL_FRAMES}, seed=15)
        work = os.path.join(tmp, "visual")
        Trainer = trainer_mod.Trainer
        init_state = Trainer.init_state
        made, step_events = [], []

        def timed_init(self, *a, **kw):
            out = init_state(self, *a, **kw)
            made.append(self)
            step = self.train_step

            def timed_step(opt, batch, gen):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                m = step(opt, batch, gen)
                ev[1].record()
                step_events.append(ev)
                return m

            self.train_step = timed_step
            return out

        Trainer.init_state = timed_init
        try:
            kernels.reset_launch_counts()
            t_cli = time.perf_counter()
            port_cli.main(["train-visual", "--packed_root", train_root, "--packed_val_root",
                           val_root, "--bf16", "--batch_size", str(B_TRAIN), "--n_epochs", "1",
                           "--log_freq", "1", "--workdir", work, "--n_threads", "4"])
            torch.cuda.synchronize()
            t_cli = time.perf_counter() - t_cli
            counts = kernels.launch_counts()
        finally:
            Trainer.init_state = init_state
        t = made[0]
        vcfg = t.cfg.model
        assert vcfg == visual_config() and t.device == torch.device(dev), (vcfg, t.device)
        assert (t.epoch, t.global_step, len(step_events)) == (1, 1, 1), (t.epoch, t.global_step)
        assert t.ckpt.all_steps() == [0] and t.ckpt.best()["step"] == 0, t.ckpt.best()
        with open(os.path.join(work, "train.log")) as f:
            rows = [r.rstrip("\n").split("\t") for r in f]
        assert rows[0] == trainer_mod.TRAIN_COLUMNS and len(rows) == 2, rows
        assert all(np.isfinite(float(x)) for x in rows[1]), rows
        want = {n: path_launches(vcfg, train=True)[n] + path_launches(vcfg, nfe=1)[n]
                for n in KERNELS}
        check_launches(counts, want, "train-visual")
        missing = [n for n in ("bias_attention", "layer_norm", "bilinear_resize_sum",
                               "bias_attention_bwd", "layer_norm_bwd") if counts[n] == 0]
        assert not missing, missing
        step_ms = step_events[0][0].elapsed_time(step_events[0][1])
        log(f"[entry] train-visual (visual-only, bf16, B={B_TRAIN}, 1 step + 1 validation "
            f"batch) in {t_cli:.1f} s: launches " + json.dumps({n: c for n, c in counts.items()
                                                                  if c})
            + f" = path_launches(train=True) + path_launches(nfe=1); log {rows[1]}; the CLI's "
            f"step {step_ms:.2f} ms by CUDA events (the first, cold) on {kind} [{smi}]")

        # -- 3. the device metrics on step 1's evaluation -------------------
        t.restore_best()
        seen = []
        eval_step = t.eval_step

        def keep(batch, gen):
            scores, pred = eval_step(batch, gen)
            seen.append((batch["salmap"], pred))
            return scores, pred

        t.eval_step = keep
        val = Loader(PackedVideoDataset(val_root, 32, "val"), B_TRAIN, shuffle=False)
        scores = t.evaluate(val)
        (gt, pred), = seen
        flat = gt.reshape(gt.shape[0], -1)
        fix = (flat >= torch.quantile(flat.float(), 0.98, dim=1, keepdim=True)).reshape(gt.shape)
        fix = fix.float()
        got = {"auc_judd": metrics_device.auc_judd(pred, fix),
               "nss": metrics_device.nss_fix(pred, fix), "cc": metrics_device.cc_maps(pred, gt),
               "sim": metrics_device.sim_maps(pred, gt)}
        assert pred.device.type == torch.device(dev).type
        assert all(v.device == pred.device for v in got.values())
        p_np, g_np, f_np = (a.float().cpu().numpy()[..., 0] for a in (pred, gt, fix))
        ref = {"auc_judd": [metrics_np.AUC_Judd(p, f, rng=np.random.RandomState(0))
                            for p, f in zip(p_np, f_np)],
               "nss": [metrics_np.NSS(p, f) for p, f in zip(p_np, f_np)],
               "cc": [metrics_np.CC(p, g) for p, g in zip(p_np, g_np)],
               "sim": [metrics_np.SIM(p, g) for p, g in zip(p_np, g_np)]}
        worst = {}
        for name, vals in ref.items():
            d = np.abs(got[name].cpu().numpy() - np.asarray(vals))
            lim = AUC_TOL if name == "auc_judd" else METRIC_TOL * np.maximum(1.0, np.abs(vals))
            assert bool(np.all(d <= lim)), (name, got[name], vals)
            worst[name] = float(d.max())
        log(f"[entry] device metrics on the card vs numpy on the CPU, step 1's evaluation "
            f"(B={B_TRAIN}, fixations the GT's top 2%): "
            + json.dumps({k: [round(float(x), 5) for x in v.cpu()] for k, v in got.items()})
            + " max|d| " + json.dumps({k: f"{v:.2e}" for k, v in worst.items()})
            + f" (AUC {AUC_TOL}, others {METRIC_TOL} of max(1, |x|)); evaluate's scores "
            + json.dumps({k: round(v, 4) for k, v in scores.items()}))
        t.model = t.optimizer = None
        del t, made, seen

        # -- 2. train-av, as a subprocess ----------------------------------
        packed = os.path.join(tmp, "av_packed")
        config = write_packed_av_tree(packed, hw, ENTRY_AV_FOLDS, 25.0, seed=16)
        with open(os.path.join(tmp, "dataset.json"), "w") as f:
            json.dump(config, f)
        work_av = os.path.join(tmp, "av")
        t_sub = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "diff_sal_tpu_torch.cli", "train-av", "--packed_root", packed,
             "--dataset_json", os.path.join(tmp, "dataset.json"), "--splits", "split1",
             "--bf16", "--batch_size", str(B_TRAIN), "--log_freq", "1", "--pretrain_path",
             os.path.join(work, "weights"), "--workdir", work_av, "--n_threads", "4"],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600)
        t_sub = time.perf_counter() - t_sub
        if proc.returncode != 0:
            log(proc.stdout[-4000:])
            log(proc.stderr[-4000:])
        assert proc.returncode == 0, proc.returncode
        loaded = [int(line.split()[2]) for line in proc.stdout.splitlines()
                  if line.startswith("warm start: ")]
        assert len(loaded) == 1 and loaded[0] > 0, proc.stdout[-2000:]
        weights = os.path.join(work_av, "split1", "weights")
        n_av = TrainingConfig().n_epochs_for_av_data
        assert sorted(os.listdir(weights)) == sorted([f"{i}.pth" for i in range(n_av)]
                                                     + ["best.json"]), os.listdir(weights)
        with open(os.path.join(weights, "best.json")) as f:
            best = json.load(f)
        # the trainer's log line per step (log_freq 1): its StepTimer's data
        # (the loader's wait) and step (the host's dispatch of the step)
        # seconds; with one step an epoch the device's wait for the step's
        # metrics falls after both
        timer = [line.split()[-3:] for line in proc.stdout.splitlines()
                 if line.startswith("epoch ")]
        assert len(timer) == n_av, proc.stdout[-2000:]
        log(f"[entry] train-av subprocess rc {proc.returncode} in {t_sub:.1f} s (AV bf16, "
            f"B={B_TRAIN}, {n_av} epochs of 1 step + 1 validation batch): warm start "
            f"{loaded[0]} parameters loaded from train-visual's best; {n_av} checkpoints, best "
            f"{best}; host time per step (StepTimer data + step): "
            + ", ".join(f"{1e3 * (float(d[:-1]) + float(st[:-1])):.1f} ms" for d, _, st in timer))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[entry] CLI part {time.perf_counter() - t0:.1f} s")
    adaptive_and_quant_phase(dev, kind, smi, schedule, data_cfg)
    log(f"[entry] phase {time.perf_counter() - t0:.1f} s")


def adaptive_and_quant_phase(dev, kind, smi, schedule, data_cfg):
    """Phase 14, steps 4 and 5: adaptive DPM-Solver and the quantised MViT
    on phase 3's model, inputs and noise."""
    from diff_sal_tpu_torch.config import SamplingConfig
    from diff_sal_tpu_torch.data.transforms import inverse_data_transform
    from diff_sal_tpu_torch.diffusion import dpm_solver
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel, build_model
    from diff_sal_tpu_torch.ops import kernels
    from diff_sal_tpu_torch.ops.quant import quantize_state_dict

    t0 = time.perf_counter()
    cfg = main_config()
    model = build_model(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    (H, W), T = cfg.decoder.img_size, cfg.visual.temporal_size
    # phase 3's first inputs, and x_T from its run(0)'s generator
    rgb = torch.randn(B, T, H, W, 3, generator=g, device=dev) * 0.5
    audio = torch.randn(B, 9, H // 2, W // 2, 1, generator=g, device=dev)
    noise = torch.randn((B, H, W, 1), generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)

    def check_map(out, what):
        assert tuple(out.shape) == (B, H, W, 1), (what, out.shape)
        assert bool(torch.isfinite(out).all()), what
        lo, hi, std = float(out.min()), float(out.max()), float(out.std())
        assert 0.0 <= lo and hi <= 1.0 and std > 0.0, (what, lo, hi, std)

    def encoded(m):
        return m.encode_visual(rgb), m.encode_audio(audio)

    # -- 4. adaptive DPM-Solver++ -------------------------------------
    def adaptive(order):
        with torch.no_grad():
            feats, aud = encoded(model)
            x, stats = dpm_solver.adaptive_sample(
                schedule, lambda x, t: model.denoise(x, t, feats, aud), noise.clone(),
                algorithm="dpmsolver++", order=order, return_stats=True)
            return inverse_data_transform(data_cfg, x), stats

    for order in (2, 3):
        kernels.reset_launch_counts()
        out, stats = adaptive(order)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check_map(out, f"adaptive {order}")
        calls = stats["nfe"] + 1  # the loop's model calls and the final denoise
        check_launches(counts, path_launches(cfg, nfe=calls), f"adaptive order {order}")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out2, stats2 = adaptive(order)
        ev[1].record()
        torch.cuda.synchronize()
        assert stats2 == stats and torch.equal(out2, out), (stats, stats2)
        log(f"[entry] adaptive DPM-Solver++ order {order} (atol 0.0078, rtol 0.05), AV bf16 "
            f"B={B}: NFE {stats['nfe']} + 1 final denoise, {stats['accepted']} accepted and "
            f"{stats['rejected']} rejected steps; launches = path_launches(nfe={calls}); map "
            f"min {float(out.min()):.4f} max {float(out.max()):.4f}; "
            f"{ev[0].elapsed_time(ev[1]):.1f} ms per run on {kind} [{smi}]")

    # model_wrapper (an x0 network) through dpm_solver_sample at NFE 2
    ns = dpm_solver.DiscreteVPSchedule(schedule.betas.double().cpu().numpy())
    with torch.no_grad():
        ref = sample_saliency(model, schedule, dpm_sampling(2), data_cfg, rgb, audio,
                              noise=noise)
        feats, aud = encoded(model)
        eps = dpm_solver.model_wrapper(lambda x, t, c: model.denoise(x, t, feats, aud), ns,
                                       model_type="x_start")
        wrapped = inverse_data_transform(data_cfg, dpm_solver.dpm_solver_sample(
            schedule, None, noise.clone(), sampling=dpm_sampling(2), wrapped_eps_fn=eps))
    check_map(wrapped, "wrapped DPM++")
    d_wrap = float((wrapped - ref).abs().max())
    assert d_wrap <= 3e-2, d_wrap
    log(f"[entry] dpm_solver_sample(wrapped_eps_fn=model_wrapper(x_start)) at NFE 2 vs "
        f"DPM++ NFE 2: max|d| {d_wrap:.3e} (limit 3e-2)")

    # -- 5. the quantised MViT ------------------------------------------
    ddim = SamplingConfig()
    with torch.no_grad():
        fp_map = sample_saliency(model, schedule, ddim, data_cfg, rgb, audio, noise=noise)
        fp_feats = model.encode_visual(rgb)
    models = {"fp": model}
    for mode in ("w8", "w8a8"):
        qcfg = dataclasses.replace(cfg, visual=dataclasses.replace(cfg.visual, mlp_quant=mode))
        qm = VideoSaliencyModel(qcfg).eval()
        qm.load_state_dict(quantize_state_dict(model.state_dict(), qm.state_dict()), strict=True)
        qm.to(dev)
        models[mode] = qm
        kernels.reset_launch_counts()
        with torch.no_grad():
            qmap = sample_saliency(qm, schedule, ddim, data_cfg, rgb, audio, noise=noise)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check_map(qmap, mode)
        check_launches(counts, path_launches(cfg, 1), f"quantised {mode}")
        with torch.no_grad():
            q_feats = qm.encode_visual(rgb)
        rel = []
        for a, f in zip(q_feats, fp_feats):
            a, f = a.float(), f.float()
            rel.append((float((a - f).abs().max() / f.abs().max()),
                        float((a - f).norm() / f.norm())))
        assert all(0.0 < m < QUANT_TOL and 0.0 < l2 < QUANT_TOL for m, l2 in rel), rel
        log(f"[entry] mlp_quant={mode}: MViT pyramid vs fp (max|d|/max|x|, relative L2) "
            + ", ".join(f"({m:.4f}, {l2:.4f})" for m, l2 in rel)
            + f" (limit {QUANT_TOL}); DDIM map vs fp max|d| "
            f"{float((qmap - fp_map).abs().max()):.3e}; launches = phase 3's")
    ms = {k: [] for k in models}
    with torch.no_grad():
        for _ in range(ENTRY_ITERS):
            for name, m in models.items():
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                sample_saliency(m, schedule, ddim, data_cfg, rgb, audio, noise=noise)
                ev[1].record()
                torch.cuda.synchronize()
                ms[name].append(ev[0].elapsed_time(ev[1]))
    log(f"[entry] DDIM NFE 1, AV bf16 B={B}, ms per run in turns ({ENTRY_ITERS} each): "
        + "; ".join(f"{k} " + ", ".join(f"{x:.2f}" for x in v) for k, v in ms.items())
        + f" on {kind} [{smi}]; adaptive and quantised part {time.perf_counter() - t0:.1f} s")


# phase 15: the reference VGGish's FC head (512*4*6 -> 4096 -> 4096 -> 128,
# reference vggish.py:114-123), planted in the reference-format file
VGGISH_HEAD_SHAPES = ((4096, 12288), (4096, 4096), (128, 4096))
REMAT_ITERS = 3  # timed steps per remat setting
# (d): relative L2 of remat's gradients from the plain step's, per
# sub-network. Two plain steps on the card differ by ~9e-3 in visual_net
# (its backward kernels sum in no fixed order) and by < 1e-7 elsewhere; a
# recompute that lost one of MViT's 16 blocks would move visual_net by
# far more. The losses must be equal: the same forward runs.
REMAT_GRAD_RL2 = 3e-2
# (e): the reference's recipe is 4 cards x batch 12 (JAX config.py:250-251,
# the reason `remat` exists), so 12 clips per card
F32_REF_BATCH = 12


def reference_file(sd, cfg, g):
    """A DiffSal best.pth's state_dict from the port's `sd`: `module.`
    prefixes, random off-centre slices in every CvT q projection, and the
    keys the port does not build (VGGish's FC head, AudioAttnNet's patch and
    position embeddings, one outside the model). Returns (file, planted)."""
    planted = {}
    for lid, shape in zip((0, 2, 4), VGGISH_HEAD_SHAPES):
        planted[f"audio_net.embeddings.{lid}.weight"] = torch.randn(shape, generator=g) * 1e-2
        planted[f"audio_net.embeddings.{lid}.bias"] = torch.randn(shape[0], generator=g)
    planted["spatiotemp_net.to_patch_embedding.1.weight"] = torch.randn(512, 512, generator=g)
    planted["spatiotemp_net.to_patch_embedding.1.bias"] = torch.randn(512, generator=g)
    planted["spatiotemp_net.pos_embedding"] = torch.randn(1, 85, 512, generator=g)
    planted["reference_only_counter"] = torch.tensor([3.0])
    ref = {f"module.{k}": v for k, v in sd.items()}
    offcentre = 0
    for k, v in sd.items():
        if k.endswith("conv_proj_q.conv.weight"):  # (C, 1, 3, 3, 3)
            w = v.clone()
            w[:, :, 0] = torch.randn(w[:, :, 0].shape, generator=g)
            w[:, :, 2] = torch.randn(w[:, :, 2].shape, generator=g)
            ref[f"module.{k}"] = w
            offcentre += 1
    assert offcentre == cfg.decoder.mid_num_stages, offcentre
    ref.update({f"module.{k}": v for k, v in planted.items()})
    return ref, planted


def import_phase(dev, kind, smi, schedule, data_cfg, main_map):
    """Phase 15 (a)-(c): the released-checkpoint import at full width (see
    the module docstring)."""
    import os
    import shutil
    import tempfile

    from diff_sal_tpu_torch import cli as port_cli
    from diff_sal_tpu_torch.config import ExperimentConfig, SamplingConfig
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel, build_model
    from diff_sal_tpu_torch.ops import kernels
    from diff_sal_tpu_torch.scripts import import_reference_ckpt
    from diff_sal_tpu_torch.train import convert
    from diff_sal_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    cfg = main_config()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_import_")
    try:
        # -- (a) a reference-format best.pth from phase 3's model ------------
        sd = build_model(cfg, seed=0, device="cpu").state_dict()
        ref, planted = reference_file(sd, cfg, torch.Generator().manual_seed(15))
        path = os.path.join(tmp, "best.pth")
        torch.save({"state_dict": ref, "optim_dict": None, "epoch": 0, "step": 0}, path)
        gib = os.path.getsize(path) / 2**30

        # -- (b) through the entry point, loaded strictly on the card ---------
        out_full = os.path.join(tmp, "full")
        t_imp = time.perf_counter()
        report = import_reference_ckpt.main([path, out_full])
        t_imp = time.perf_counter() - t_imp
        want = {convert.VGGISH_HEAD: sorted(k for k in planted if ".embeddings." in k),
                convert.AUDIO_ATTN_DEAD: sorted(k for k in planted
                                                if k.startswith("spatiotemp_net.")),
                convert.OTHER: ["reference_only_counter"]}
        assert report.dropped == want, report.dropped
        counters = sum(k.endswith("num_batches_tracked") for k in sd)
        assert report.loaded == len(sd) - counters, (report.loaded, len(sd), counters)
        model = VideoSaliencyModel(cfg).eval().to(dev)
        model.load_state_dict(port_cli._best_state_dict(out_full, dev), strict=True)
        g = torch.Generator(device=dev).manual_seed(0)
        (H, W), T = cfg.decoder.img_size, cfg.visual.temporal_size
        rgb = torch.randn(B, T, H, W, 3, generator=g, device=dev) * 0.5
        audio = torch.randn(B, 9, H // 2, W // 2, 1, generator=g, device=dev)
        kernels.reset_launch_counts()
        out = sample_saliency(model, schedule, SamplingConfig(), data_cfg, rgb, audio,
                              generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check_launches(counts, path_launches(cfg, 1), "imported model, DDIM")
        d_map = float((out - main_map).abs().max())
        # the same weights through the same kernels on the same inputs and noise
        assert d_map == 0.0, d_map
        log(f"[import] full: a reference-format best.pth of phase 3's model ({gib:.3f} GiB, "
            f"{len(ref)} tensors: `module.` prefixes, VGGish's FC head, AudioAttnNet's dead "
            f"embeddings, off-centre CvT q slices, one key outside the model) imported in "
            f"{t_imp:.2f} s: {report.loaded} tensors loaded, dropped "
            + json.dumps({r: len(k) for r, k in report.dropped.items()})
            + f" (the planted keys); strict load; DDIM NFE 1 on phase 3's inputs and noise: "
            f"max|d| {d_map:.1e} from phase 3's map (bound 0), launches = path_launches(cfg) "
            f"on {kind} [{smi}]")
        del model, out, ref

        # -- (c) the mvit kind, into a warm start (F8) -------------------------
        visual = {k[len("visual_net."):]: v for k, v in sd.items()
                  if k.startswith("visual_net.")}
        kinetics = {f"backbone.{k}": v for k, v in visual.items()}
        kinetics["cls_head.fc_cls.weight"] = torch.randn(
            400, 768, generator=torch.Generator().manual_seed(16))
        mvit_path = os.path.join(tmp, "kinetics.pth")
        torch.save({"state_dict": kinetics}, mvit_path)
        out_mvit = os.path.join(tmp, "mvit")
        rep_mvit = import_reference_ckpt.main([mvit_path, out_mvit, "--kind", "mvit"])
        assert rep_mvit.dropped == {convert.OUTSIDE_BACKBONE: ["cls_head.fc_cls.weight"]}, \
            rep_mvit.dropped
        t = Trainer(ExperimentConfig(model=cfg), os.path.join(tmp, "av"), 1, device=dev)
        t.init_state(seed=7)
        initial = {k: v.clone() for k, v in t.model.state_dict().items()}
        t.warm_start(port_cli._best_state_dict(out_mvit, dev))
        params = dict(t.model.named_parameters())
        stats = 0
        for k, v in t.model.state_dict().items():
            if k.startswith("visual_net."):
                assert torch.equal(v.cpu(), visual[k[len("visual_net."):]]), k
            else:
                assert torch.equal(v, initial[k]), k
                stats += k not in params
        assert stats == 21, stats  # the decoder's 7 BatchNorms, 3 buffers each
        log(f"[import] mvit: a `backbone.` file with a classifier key: {rep_mvit.loaded} "
            f"tensors loaded, the classifier dropped; warm start of a fresh AV model: "
            f"visual_net equal to the source's, every other entry (the {stats} BatchNorm "
            f"statistics among them, F8) its initial value; import part "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def with_remat(model_cfg, remat: bool):
    """An experiment config of `model_cfg` with MViT's `remat` set."""
    from diff_sal_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(model=dataclasses.replace(
        model_cfg, visual=dataclasses.replace(model_cfg.visual, remat=remat)))


def train_batch(b: int, model_cfg, seed: int, dev):
    """A random AV training batch of `b` clips on `dev`, from `seed`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    (H, W), T = model_cfg.decoder.img_size, model_cfg.visual.temporal_size
    return {"rgb": torch.randn(b, T, H, W, 3, generator=gen, device=dev) * 0.5,
            "salmap": torch.rand(b, H, W, 1, generator=gen, device=dev),
            "audio": torch.randn(b, 9, H // 2, W // 2, 1, generator=gen, device=dev)}


def remat_steps(dev, schedule, tcfg, batch, iters, what):
    """A fresh model's first training step from seed-0 weights (phase 6's
    checks) with the launch counts set to 0 just before it and read just
    after, its gradients (copied to the host, so that they hold no card
    memory in a later run's peak), then `iters` steps timed by CUDA events.
    Returns (loss, counts, gradients, ms, peak GiB, held GiB): the peak of
    `max_memory_allocated` over all of it (the model, Adam's state and the
    steps) and what the card held before the model was built."""
    from diff_sal_tpu_torch.models.diff_model import build_model
    from diff_sal_tpu_torch.ops import kernels
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    m = build_model(tcfg.model, seed=0, device=dev, train=True)
    opt = make_optimizer(m, tcfg.optim, steps_per_epoch=1000, n_epochs=4)
    step = make_train_step(m, schedule, tcfg)
    params = dict(m.named_parameters())
    gen = torch.Generator(device=dev)
    kernels.reset_launch_counts()
    m0 = first_train_step(step, opt, batch, gen.manual_seed(16), params, what,
                          time.perf_counter())
    counts = kernels.launch_counts()
    grads = {n: p.grad.detach().cpu().float() for n, p in params.items()
             if p.grad is not None}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    ev[0].record()
    for i in range(iters):
        met = step(opt, batch, gen)
        ev[i + 1].record()
    torch.cuda.synchronize()
    assert np.isfinite(float(met["total"])), met
    ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    return (float(m0["total"]), counts, grads, ms, torch.cuda.max_memory_allocated() / 2**30,
            held)


def f32_step(dev, schedule, f32, remat: bool):
    """(e)'s step at F32_REF_BATCH, or None where it runs out of memory."""
    import gc

    try:
        return remat_steps(dev, schedule, with_remat(f32, remat),
                           train_batch(F32_REF_BATCH, f32, 18, dev), 1,
                           f"f32 B={F32_REF_BATCH} remat={remat}")
    except torch.cuda.OutOfMemoryError:
        pass
    # the error's frames, and the tensors they held, are gone once its
    # handler has ended
    gc.collect()
    torch.cuda.empty_cache()
    return None


def remat_phase(dev, kind, smi, schedule):
    """Phase 15 (d) and (e): MViT's `remat` at full width (see the module
    docstring)."""
    import gc

    from diff_sal_tpu_torch.config import ModelConfig

    t0 = time.perf_counter()

    # -- (d) bf16, B=4: remat off and on from the same weights and batch ------
    cfg = main_config()
    batch = train_batch(B_TRAIN, cfg, 15, dev)
    # the plain step twice: the card's own run-to-run spread of the
    # gradients, against which remat's is read
    res = {}
    for name, remat in (("off", False), ("on", True), ("off again", False)):
        tcfg = with_remat(cfg, remat)
        res[name] = remat_steps(dev, schedule, tcfg, batch, REMAT_ITERS, f"remat {name}")
        check_launches(res[name][1], path_launches(tcfg.model, train=True),
                       f"bf16 step, remat={remat}")
        gc.collect()
    (l_off, c_off, g_off, ms_off, p_off, h_off), (l_on, c_on, g_on, ms_on, p_on, h_on) = (
        res["off"], res["on"])
    l_again, _, g_again, ms_again, p_again, _ = res["off again"]
    assert l_on == l_off == l_again, (l_off, l_on, l_again)
    assert set(g_on) == set(g_off) == set(g_again), set(g_on) ^ set(g_off)
    stats, worst = grad_agreement(g_on, g_off)
    control, c_worst = grad_agreement(g_again, g_off)
    for what, got in (("remat", stats), ("control", control)):
        for sub, (rl2, _) in got.items():
            assert rl2 <= REMAT_GRAD_RL2, (what, sub, rl2)
    extra = {n: c_on[n] - c_off[n] for n in c_on if c_on[n] != c_off[n]}
    log(f"[remat] AV bf16 B={B_TRAIN} step, remat off / on / off again from the same weights "
        f"and batch: loss {l_off:.6f} / {l_on:.6f} / {l_again:.6f} (bound: equal); gradients "
        f"on vs off (relative L2, cosine) " + json.dumps(stats) + f" worst tensor {worst}; "
        f"off again vs off " + json.dumps(control) + f" worst tensor {c_worst} (bound relative "
        f"L2 {REMAT_GRAD_RL2} per sub-network); launches = path_launches(train=True, remat), "
        f"the recompute's " + json.dumps(extra) + f"; peak {p_off:.2f} / {p_on:.2f} / "
        f"{p_again:.2f} GiB ({h_off:.2f} / {h_on:.2f} held before); ms per step by events off "
        + ", ".join(f"{t:.2f}" for t in ms_off) + " / on " + ", ".join(f"{t:.2f}" for t in ms_on)
        + " / off again " + ", ".join(f"{t:.2f}" for t in ms_again) + f" on {kind} [{smi}]")
    del res, g_off, g_on, g_again, batch
    gc.collect()

    # -- (e) f32 at the reference's per-card batch, with and without remat ----
    f32 = ModelConfig.audio_visual()
    got = f32_step(dev, schedule, f32, True)
    if got is None:
        raise AssertionError(f"the f32 step with remat does not fit at B={F32_REF_BATCH}")
    loss, _, _, ms, peak, held = got
    assert np.isfinite(loss), loss
    del got
    gc.collect()
    # the same batch without remat: what remat saves at this B, and costs
    plain = f32_step(dev, schedule, f32, False)
    if plain is None:
        without = "out of the card's memory"
    else:
        assert plain[0] == loss, (plain[0], loss)
        without = (f"fits: loss equal to remat's, {plain[3][0]:.2f} ms per step, peak "
                   f"{plain[4]:.2f} GiB")
    log(f"[remat] AV f32 step with remat at B={F32_REF_BATCH} (the reference's per-card "
        f"batch): loss {loss:.4f}, {ms[0]:.2f} ms per step by events (after one warm-up step), "
        f"{1000.0 * F32_REF_BATCH / ms[0]:.2f} clips/s, peak {peak:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} ({held:.2f} held "
        f"before); without remat at B={F32_REF_BATCH}: {without} on {kind} [{smi}]; remat "
        f"part {time.perf_counter() - t0:.1f} s")
    del plain
    gc.collect()
    torch.cuda.empty_cache()


# phase 16: data parallelism over torch.distributed. Two ranks share the one
# card through gloo (NCCL refuses two ranks on one device); one rank runs
# over NCCL. The parity config cuts only the decoder's dropout and DropPath
# to 0: each rank draws its own masks, so no mask can be shared with one
# process. Every step runs in f32 and in bf16. The bounds against the plain
# step in f32: the loss 1e-2 relative, the BatchNorm running statistics
# 1e-3 relative L2 per tensor, each sub-network's averaged gradient
# REMAT_GRAD_RL2 relative L2 (two plain steps on the card differ by ~9e-3
# in visual_net). A bf16 step keeps 8 bits, and any change in where it
# rounds moves its gradients far more than that: two ranks run every
# kernel at half the batch, whose plans and cuDNN algorithms round at
# other points (0.10-0.13 relative L2 per sub-network on an H100, 0.11-0.12
# through the plain versions on the CPU), and even one NCCL rank at the
# plain step's batch, where only the statistics' summation order differs
# (sums over the ranks against a mean), moved them 0.045-0.056 on the
# H100 (PERF.md §6). In bf16 the loss keeps its bound and each
# sub-network's gradient its direction, cosine >= LAYOUT_GRAD_COS, as two
# bf16 layouts are held in phase 9; the statistics are printed.
# Evaluation: the scores 1e-3 (absolute, of nss + cc + sim) and the maps
# 3e-2 (bf16 on [0, 1]).
DP_RANKS = 2
DP_EVAL_B = 4          # global; the last row a padded duplicate
DP_ITERS = 3           # timed steps per run
DP_LOSS_RTOL, DP_STATS_RL2, DP_SCORE_TOL, DP_MAP_TOL = 1e-2, 1e-3, 1e-3, 3e-2
DP_TIMEOUT_S = 300     # each launch, as a whole
DP_GROUP_TIMEOUT_S = 240
DP_STEP_SEED, DP_EVAL_SEED = 16, 0
DP_DTYPES = ("bfloat16", "float32")  # the steps of (a) and (c); (b) runs bf16
# (d): the train-av tree, 3 + 3 + 1 training windows (7: not a multiple of
# the ranks' W b = 4) and 3 + 1 test windows (one batch); 2 epochs of the
# AV protocol
DP_CLI_FOLDS = {"train": (("t1", 160), ("t2", 160), ("t3", 40)),
                "test": (("e1", 160), ("e2", 40))}
DP_CLI_EPOCHS = 2


def dp_config(dtype: str = "bfloat16"):
    """The AV experiment at full width in `dtype`, the decoder's dropout
    and DropPath at 0."""
    from diff_sal_tpu_torch.config import ExperimentConfig

    m = main_config()
    return ExperimentConfig(model=dataclasses.replace(
        m, compute_dtype=dtype,
        decoder=dataclasses.replace(m.decoder, dropout=0.0, drop_path_rate=(0.0,) * 4)))


def dp_step_launches(cfg):
    """One training step's launches: the f32 instances in an f32 model."""
    want = f32_launches if cfg.model.compute_dtype == "float32" else path_launches
    return want(cfg.model, train=True)


def dp_eval_batch(cfg, dev):
    """The global eval batch: DP_EVAL_B clips, the last one padding."""
    batch = train_batch(DP_EVAL_B, cfg.model, 21, dev)
    batch["valid"] = (torch.arange(DP_EVAL_B, device=dev) < DP_EVAL_B - 1).float()
    return batch


def bn_stats(model):
    return {n: b.detach().float().cpu().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def state_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for n, t in model.state_dict().items():
        h.update(n.encode())
        h.update(t.detach().reshape(-1).cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def dp_steps(step, opt, batch, what, kw=None):
    """The first step from fresh weights (the draws of DP_STEP_SEED) with
    the launch counts set to 0 just before it and read just after.
    Returns (its metrics, the counts)."""
    from diff_sal_tpu_torch.ops import kernels

    gen = torch.Generator(device=opt.params[0].device).manual_seed(DP_STEP_SEED)
    kernels.reset_launch_counts()
    m0 = step(opt, batch, gen, **(kw or {}))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    m0 = {k: float(v) for k, v in m0.items()}
    assert all(np.isfinite(v) for v in m0.values()), (what, m0)
    return m0, counts


def dp_time(step, opt, batch, kw=None):
    """ms per step of DP_ITERS steps by CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(DP_ITERS + 1)]
    gen = torch.Generator(device=opt.params[0].device).manual_seed(1)
    ev[0].record()
    for i in range(DP_ITERS):
        step(opt, batch, gen, **(kw or {}))
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


def dp_worker(spec_path: str, rank: int) -> int:
    """A rank of (a)-(b) or (c): joins the group, runs the evaluations
    (with `spec["eval"]`) and one training step on its rows in each of
    spec["dtypes"] (the bf16 one then timed), and writes its results under
    spec["out"]."""
    import gc
    import os

    import torch.distributed as dist

    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.models.diff_model import build_model
    from diff_sal_tpu_torch.ops import kernels
    from diff_sal_tpu_torch.parallel import mesh, multihost
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_eval_step, make_train_step

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = spec["world"]
    dev = torch.device(DEVICE)
    dev = torch.device("cuda", 0) if dev.type == "cuda" else dev  # every rank on the one card
    multihost.initialize(init_method=f"tcp://127.0.0.1:{spec['port']}", world_size=world,
                         rank=rank, local_rank=rank, local_world_size=world, device=dev,
                         timeout_s=DP_GROUP_TIMEOUT_S)
    try:
        group = mesh.make_mesh()
        res = {"rank": rank, "backend": dist.get_backend(group)}
        cfg, schedule = dp_config(), make_schedule()
        model = build_model(cfg.model, seed=0, device=dev, train=True)
        if spec["eval"]:
            rows = mesh.shard_batch(dp_eval_batch(cfg, dev), group)
            n = float(rows["valid"].sum())
            for name, c, nfe in (("ddim", cfg, 1),
                                 ("dpm", dataclasses.replace(cfg, sampling=dpm_sampling(2)), 2)):
                step = make_eval_step(model, schedule, c, group)
                kernels.reset_launch_counts()
                with torch.no_grad():
                    scores, pred = step(rows, torch.Generator(device=dev).manual_seed(
                        DP_EVAL_SEED))
                torch.cuda.synchronize()
                check_launches(kernels.launch_counts(), path_launches(cfg.model, nfe),
                               f"rank {rank} {name}")
                res[name] = mesh.reduce_weighted({k: float(v) * n for k, v in scores.items()},
                                                 n, group, dev)
                torch.save(pred.float().cpu(), os.path.join(spec["out"], f"{name}_{rank}.pt"))
        for dtype in spec["dtypes"]:
            cfg = dp_config(dtype)
            if model is None:
                model = build_model(cfg.model, seed=0, device=dev, train=True)
            opt = make_optimizer(model, cfg.optim, steps_per_epoch=1000, n_epochs=4)
            step = make_train_step(model, schedule, cfg, group)
            batch = mesh.shard_batch(train_batch(B_TRAIN, cfg.model, 2, dev), group)
            kw = {"mask_generator": torch.Generator(device=dev).manual_seed(100 + rank)}
            m0, counts = dp_steps(step, opt, batch, f"rank {rank} {dtype}", kw)
            check_launches(counts, dp_step_launches(cfg), f"rank {rank} {dtype} step")
            res[dtype] = {"loss": m0["total"], "grad_norm": m0["grad_norm"],
                          "digest": state_digest(model),
                          "launches": {k: v for k, v in counts.items() if v}}
            if rank == 0:
                torch.save({"grads": {n: p.grad.float().cpu()
                                      for n, p in model.named_parameters()
                                      if p.grad is not None}, "stats": bn_stats(model)},
                           os.path.join(spec["out"], f"rank0_{dtype}.pt"))
            if dtype == "bfloat16":
                res["ms"] = dp_time(step, opt, batch, kw)
            del model, opt, step, batch
            model = None
            gc.collect()
            torch.cuda.empty_cache()
        mesh.barrier(group, dev)
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        multihost.shutdown()
    return 0


def dp_cli_worker(spec_path: str) -> int:
    """(d)'s rank, started by torchrun: `cli.main(["train-av", ...])` with
    the AV protocol cut to DP_CLI_EPOCHS epochs, each step's metrics on
    this rank's rows recorded (a host sync per step) into spec["out"]."""
    import os

    from diff_sal_tpu_torch import cli as port_cli
    from diff_sal_tpu_torch.train import trainer as trainer_mod

    with open(spec_path) as f:
        spec = json.load(f)
    make_cfg, init_state = port_cli._make_cfg, trainer_mod.Trainer.init_state
    steps = []

    def cut(args, audio_visual):
        cfg = make_cfg(args, audio_visual)
        return dataclasses.replace(cfg, training=dataclasses.replace(
            cfg.training, n_epochs_for_av_data=DP_CLI_EPOCHS))

    def recording(self, *a, **kw):
        out = init_state(self, *a, **kw)
        step = self.train_step

        def call(*args, **kws):
            m = step(*args, **kws)
            steps.append({k: float(v) for k, v in m.items()})
            return m

        self.train_step = call
        return out

    port_cli._make_cfg, trainer_mod.Trainer.init_state = cut, recording
    port_cli.main(spec["argv"])
    with open(os.path.join(spec["out"], f"cli_rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(steps, f)
    return 0


def dp_launch(cmds, logs, timeout_s: float, env=None):
    """Start every command (each in a session of its own, its output into
    its log file) and wait for all; a command that fails or outlasts the
    launch's timeout ends the others (their whole process groups) and
    fails the phase."""
    import os
    import signal

    procs = []
    for cmd, path in zip(cmds, logs):
        with open(path, "w") as out:
            procs.append(subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                          env=env, start_new_session=True,
                                          cwd=os.path.dirname(os.path.abspath(__file__))))
    t0, failed = time.perf_counter(), None
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad:
                failed = f"exit code {bad[0].returncode}"
                break
            if time.perf_counter() - t0 > timeout_s:
                failed = f"still running after {timeout_s} s"
                break
            time.sleep(0.2)
        else:
            bad = [p for p in procs if p.returncode != 0]
            failed = f"exit code {bad[0].returncode}" if bad else None
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    if failed:
        for path in logs:
            with open(path) as f:
                log(f"[dp] --- {path} (tail) ---\n" + f.read()[-3000:])
        raise AssertionError(f"data-parallel launch failed: {failed}")
    return time.perf_counter() - t0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_hold_step(what, path, losses, ref, bf16: bool):
    """(a) and (c)'s gates on one step, logged before they are held: the
    loss (the mean over the ranks' rows), and from rank 0's file the
    averaged gradients per sub-network and the BatchNorm statistics,
    against the plain step's. `bf16`: the gradients are held to their
    direction (cosine) and the statistics printed."""
    loss = float(np.mean(losses))
    rel = abs(loss - ref["loss"]) / abs(ref["loss"])
    got = torch.load(path, weights_only=True)
    stats, worst = grad_agreement(got["grads"], ref["grads"])
    bn = max(float((got["stats"][n] - s).norm() / s.norm()) for n, s in ref["stats"].items())
    bound = (f"cosine >= {LAYOUT_GRAD_COS}" if bf16
             else f"relative L2 <= {REMAT_GRAD_RL2}")
    log(f"[dp] {what}: loss {loss:.6f} vs the plain step's {ref['loss']:.6f} (rel {rel:.2e}, "
        f"bound {DP_LOSS_RTOL}); averaged gradients vs the plain step's (relative L2, cosine) "
        + json.dumps(stats) + f" worst tensor {worst} (bound per sub-network: {bound}); "
        f"BatchNorm statistics worst relative L2 {bn:.2e} (bound "
        f"{'none' if bf16 else DP_STATS_RL2})")
    assert rel <= DP_LOSS_RTOL, (what, loss, ref["loss"])
    assert set(got["grads"]) == set(ref["grads"]), set(got["grads"]) ^ set(ref["grads"])
    for sub, (rl2, cos) in stats.items():
        assert cos >= LAYOUT_GRAD_COS if bf16 else rl2 <= REMAT_GRAD_RL2, (
            what, sub, rl2, cos)
    assert bf16 or bn <= DP_STATS_RL2, (what, bn)


def dp_phase(dev, kind, smi, schedule):
    """Phase 16: data parallelism over torch.distributed (see the module
    docstring)."""
    import gc
    import os
    import shutil
    import tempfile

    from diff_sal_tpu_torch.data.synthetic import write_packed_av_tree
    from diff_sal_tpu_torch.models.diff_model import build_model
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_eval_step, make_train_step

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    me = os.path.abspath(__file__)
    try:
        # -- the plain references: one process, the global batches ----------
        ref, ref_eval = {}, {}
        for dtype in DP_DTYPES:
            cfg = dp_config(dtype)
            model = build_model(cfg.model, seed=0, device=dev, train=True)
            if dtype == "bfloat16":
                ev = dp_eval_batch(cfg, dev)
                for name, c in (("ddim", cfg),
                                ("dpm", dataclasses.replace(cfg, sampling=dpm_sampling(2)))):
                    with torch.no_grad():
                        scores, pred = make_eval_step(model, schedule, c)(
                            ev, torch.Generator(device=dev).manual_seed(DP_EVAL_SEED))
                    ref_eval[name] = ({k: float(v) for k, v in scores.items()},
                                      pred.float().cpu())
                del ev
            opt = make_optimizer(model, cfg.optim, steps_per_epoch=1000, n_epochs=4)
            step = make_train_step(model, schedule, cfg)
            batch = train_batch(B_TRAIN, cfg.model, 2, dev)
            m0, _ = dp_steps(step, opt, batch, f"plain {dtype}")
            ref[dtype] = {"loss": m0["total"], "stats": bn_stats(model),
                          "grads": {n: p.grad.float().cpu() for n, p in model.named_parameters()
                                    if p.grad is not None}}
            if dtype == "bfloat16":
                plain_ms = dp_time(step, opt, batch)
            del model, opt, step, batch
            gc.collect()
            torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t0

        # -- (a) and (b): two ranks on the one card through gloo -------------
        runs = {}
        for what, world, with_eval in (("gloo2", DP_RANKS, True), ("nccl1", 1, False)):
            out = os.path.join(tmp, what)
            os.makedirs(out)
            spec = os.path.join(tmp, f"{what}.json")
            with open(spec, "w") as f:
                json.dump({"world": world, "port": free_port(), "eval": with_eval, "out": out,
                           "dtypes": DP_DTYPES}, f)
            secs = dp_launch([[sys.executable, me, "--dp-spec", spec, "--dp-rank", str(r)]
                              for r in range(world)],
                             [os.path.join(tmp, f"{what}_{r}.log") for r in range(world)],
                             DP_TIMEOUT_S)
            res = []
            for r in range(world):
                with open(os.path.join(out, f"rank{r}.json")) as f:
                    res.append(json.load(f))
            runs[what] = (out, res, secs)
        out, res, secs = runs["gloo2"]
        assert [r["backend"] for r in res] == ["gloo"] * DP_RANKS, res
        log(f"[dp] (a) {DP_RANKS} ranks through gloo on the one card, B={B_TRAIN} "
            f"({B_TRAIN // DP_RANKS} rows each), one step from phase 6's weights and batch in "
            f"each of {DP_DTYPES}; each rank's launches = path_launches(train=True) (f32: "
            f"f32_launches) " + json.dumps(res[0]["bfloat16"]["launches"])
            + f"; launch {secs:.1f} s")
        for dtype in DP_DTYPES:
            digests = [r[dtype]["digest"] for r in res]
            assert len(set(digests)) == 1, (dtype, digests)
            dp_hold_step(f"(a) {dtype}, parameters and buffers bitwise equal across the ranks",
                         os.path.join(out, f"rank0_{dtype}.pt"),
                         [r[dtype]["loss"] for r in res], ref[dtype], dtype == "bfloat16")
        for name in ("ddim", "dpm"):
            scores, pred = ref_eval[name]
            rows = [torch.load(os.path.join(out, f"{name}_{r}.pt"), weights_only=True)
                    for r in range(DP_RANKS)]
            d_map = max(float((rows[r] - pred[r::DP_RANKS]).abs().max())
                        for r in range(DP_RANKS))
            d_sc = max(abs(r[name][k] - scores[k]) for r in res for k in scores)
            log(f"[dp] (b) {name} ({'NFE 1' if name == 'ddim' else 'DPM++ 2M NFE 2'}) on the "
                f"{DP_RANKS} ranks, B={DP_EVAL_B} with a padded row: all-reduced scores "
                + json.dumps({k: round(v, 5) for k, v in res[0][name].items()})
                + f" vs one process's, max|d| {d_sc:.2e} (bound {DP_SCORE_TOL}); each rank's "
                f"maps vs its rows of one process's, max|d| {d_map:.2e} (bound {DP_MAP_TOL}); "
                f"launches = path_launches(nfe)")
            assert d_map <= DP_MAP_TOL and d_sc <= DP_SCORE_TOL, (name, d_map, d_sc)
        out, res_c, secs_c = runs["nccl1"]
        assert [r["backend"] for r in res_c] == [
            "nccl" if torch.device(dev).type == "cuda" else "gloo"], res_c
        for dtype in DP_DTYPES:
            dp_hold_step(f"(c) one rank through NCCL, B={B_TRAIN}, {dtype}, launches as (a)'s, "
                         f"launch {secs_c:.1f} s", os.path.join(out, f"rank0_{dtype}.pt"),
                         [res_c[0][dtype]["loss"]], ref[dtype], dtype == "bfloat16")
        fmt = lambda ms: ", ".join(f"{t:.2f}" for t in ms)  # noqa: E731
        log(f"[dp] ms per step by CUDA events ({DP_ITERS} steps after the first): plain "
            f"B={B_TRAIN} {fmt(plain_ms)}; (c) one NCCL rank B={B_TRAIN} {fmt(res_c[0]['ms'])}; "
            f"(a) {DP_RANKS} gloo ranks sharing the card, {B_TRAIN // DP_RANKS} rows each: "
            + "; ".join(f"rank {r['rank']} {fmt(r['ms'])}" for r in res)
            + f" on {kind} [{smi}]")

        # -- (d): train-av under torchrun, two ranks -------------------------
        packed = os.path.join(tmp, "av_packed")
        hw = main_config().decoder.img_size
        config = write_packed_av_tree(packed, hw, DP_CLI_FOLDS, 25.0, seed=17)
        with open(os.path.join(tmp, "dataset.json"), "w") as f:
            json.dump(config, f)
        work = os.path.join(tmp, "cli")
        out = os.path.join(tmp, "cli_out")
        os.makedirs(out)
        spec = os.path.join(tmp, "cli.json")
        with open(spec, "w") as f:
            json.dump({"out": out, "argv": [
                "train-av", "--packed_root", packed, "--dataset_json",
                os.path.join(tmp, "dataset.json"), "--splits", "split1", "--bf16",
                "--batch_size", str(B_TRAIN), "--log_freq", "1", "--workdir", work,
                "--n_threads", "4"]}, f)
        secs_d = dp_launch([[sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node", str(DP_RANKS), me, "--dp-cli", spec]],
                           [os.path.join(tmp, "cli.log")], DP_TIMEOUT_S)
        steps = []
        for r in range(DP_RANKS):
            with open(os.path.join(out, f"cli_rank{r}.json")) as f:
                steps.append(json.load(f))
        # 7 windows: cut to 6, 3 rows a rank, one step of 2 an epoch each
        assert [len(s) for s in steps] == [DP_CLI_EPOCHS] * DP_RANKS, [len(s) for s in steps]
        split = os.path.join(work, "split1")
        with open(os.path.join(split, "split1.log")) as f:
            rows = [line.rstrip("\n").split("\t") for line in f]
        with open(os.path.join(split, "split1_val.log")) as f:
            val_rows = [line.rstrip("\n").split("\t") for line in f]
        # one writer: one header and one row per epoch in each log
        assert len(rows) == len(val_rows) == DP_CLI_EPOCHS + 1, (rows, val_rows)
        assert sorted(os.listdir(os.path.join(split, "weights"))) == sorted(
            [f"{e}.pth" for e in range(DP_CLI_EPOCHS)] + ["best.json"])
        col = rows[0].index("loss")
        logged = [float(r[col]) for r in rows[1:]]
        glob = [float(np.mean([s[e]["total"] for s in steps])) for e in range(DP_CLI_EPOCHS)]
        d_log = max(abs(a - b) / abs(b) for a, b in zip(logged, glob))
        assert d_log <= 1e-6, (logged, glob)
        log(f"[dp] (d) train-av under torchrun, {DP_RANKS} ranks on the one card (gloo), "
            f"default AV config in bf16, B={B_TRAIN}, {DP_CLI_EPOCHS} epochs over 7 training "
            f"windows (cut to 6: one step a rank an epoch): rc 0 in {secs_d:.1f} s; one header "
            f"and {DP_CLI_EPOCHS} rows in each log, checkpoints "
            + json.dumps(sorted(os.listdir(os.path.join(split, "weights"))))
            + f"; logged loss {logged} = the mean of the ranks' own "
            + json.dumps([[round(s[e]['total'], 6) for s in steps] for e in range(DP_CLI_EPOCHS)])
            + f" (max rel {d_log:.1e})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[dp] phase {time.perf_counter() - t0:.1f} s (references {t_ref:.1f} s)")


MODES_ITERS = 3  # timed DDIM runs per model and turn, two turns
MODES_TRAIN_ITERS = 2  # timed steps per model and turn, two turns


def no_cls_config(with_cls_token: bool = False):
    """Phase 17's visual-only model: phase 9's (cls stream) with or without
    MViT's cls token."""
    cfg = visual_config(True)
    return dataclasses.replace(cfg, visual=dataclasses.replace(
        cfg.visual, with_cls_token=with_cls_token))


def ablation_config(audio: bool, hw=(224, 384), dtype: str = "bfloat16"):
    """The random-pyramid ablation (`visual=None`): the decoder alone, or
    with VGGish and AudioAttnNet."""
    from diff_sal_tpu_torch.config import (AudioAttnConfig, ModelConfig, SalUNetConfig,
                                           VGGishConfig)

    return ModelConfig(visual=None, audio=VGGishConfig() if audio else None,
                       spatiotemp=AudioAttnConfig() if audio else None,
                       decoder=SalUNetConfig(img_size=hw), compute_dtype=dtype)


def timed_turns(fns, iters):
    """ms per call of each named thunk by CUDA events, in two turns (each
    thunk `iters` times in a row per turn, the order reversed in the
    second): {name: [ms per turn]}."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = {n: [] for n in fns}
    for names in (list(fns)[::-1], list(fns)):
        for n in names:
            start.record()
            for i in range(iters):
                fns[n](i)
            end.record()
            torch.cuda.synchronize()
            times[n].append(start.elapsed_time(end) / iters)
    return times


def modes_phase(dev, kind, smi, schedule, data_cfg):
    """Phase 17: MViT without its cls token and the random pyramid. (1)
    The visual-only model without MViT's cls token at full width in bf16
    (its attention in plain torch, 5 LayerNorms per block): DDIM NFE 1 at
    B=2 and the training step at B=4, maps, gradients, launches against
    `path_launches`, ms per run and per step, device time and the step's
    peak memory beside the cls-token model on the same weights; (2) the same mode small in f32, the card against the
    CPU (phase 10's bounds); (3) the random-pyramid ablation (`visual=None`)
    at full width in bf16: the pyramid's shapes, dtypes and draws, the
    decoder-only forward at B=2 and its backward at B=4, the AV ablation's
    forward at B=2, launches against `path_launches`; both packages'
    `sample_saliency` and train step raise for it, and the port's do here."""
    from diff_sal_tpu_torch.config import (ExperimentConfig, ModelConfig, MViTConfig,
                                           SalUNetConfig, SamplingConfig)
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import (PYRAMID_DIMS, VideoSaliencyModel,
                                                      build_model)
    from diff_sal_tpu_torch.ops import kernels
    from diff_sal_tpu_torch.train.optim import make_optimizer
    from diff_sal_tpu_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    # -- (1) the visual-only model without its cls token, full width -------
    cfgs = {"no_cls": no_cls_config(False), "cls": no_cls_config(True)}
    models = {"no_cls": build_model(cfgs["no_cls"], seed=40, device=dev)}
    models["cls"] = VideoSaliencyModel(cfgs["cls"]).eval()  # one parameter tree
    models["cls"].load_state_dict(models["no_cls"].state_dict())
    models["cls"].to(dev)
    (H, W), T = cfgs["no_cls"].decoder.img_size, cfgs["no_cls"].visual.temporal_size
    g = torch.Generator(device=dev).manual_seed(41)
    inputs = [(torch.randn(B, T, H, W, 3, generator=g, device=dev) * 0.5,
               torch.randn(B, H, W, 1, generator=g, device=dev)) for _ in range(3)]
    sampling = SamplingConfig()

    def run(what, i=0):
        rgb, noise = inputs[i % len(inputs)]
        return sample_saliency(models[what], schedule, sampling, data_cfg, rgb, noise=noise)

    for what in cfgs:
        run(what)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = run("no_cls")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert tuple(out.shape) == (B, H, W, 1), out.shape
    assert bool(torch.isfinite(out).all()), "no cls token: non-finite map"
    lo, hi, std = float(out.min()), float(out.max()), float(out.std())
    assert 0.0 <= lo and hi <= 1.0 and std > 0.0, (lo, hi, std)
    check_launches(counts, path_launches(cfgs["no_cls"], 1), "no cls token DDIM run")
    log(f"[modes] no cls token: map min {lo:.4f} max {hi:.4f} std {std:.5f}; launches per run "
        + json.dumps({n: k for n, k in counts.items() if k}) + f"; peak memory {peak:.2f} GiB")
    for what, ts in timed_turns({w: functools.partial(run, w) for w in cfgs},
                                MODES_ITERS).items():
        ms = sum(ts) / len(ts)
        log(f"[modes] {what}: {ms:.2f} ms per B={B} DDIM run (turns "
            + ", ".join(f"{t:.2f}" for t in ts) + f"), {1000.0 * B / ms:.2f} clips/s on {kind} "
            f"[{smi}]")

    gen = torch.Generator(device=dev).manual_seed(42)
    batches = [{"rgb": torch.randn(B_TRAIN, T, H, W, 3, generator=gen, device=dev) * 0.5,
                "salmap": torch.rand(B_TRAIN, H, W, 1, generator=gen, device=dev)}
               for _ in range(3)]
    steps = {}
    for what, cfg in cfgs.items():
        m = models[what]
        ecfg = ExperimentConfig(model=cfg)
        opt = make_optimizer(m, ecfg.optim, steps_per_epoch=1000, n_epochs=4)
        step = make_train_step(m, schedule, ecfg)
        steps[what] = (opt, step)
        met = step(opt, batches[0], gen)
        torch.cuda.synchronize()
        loss, gn = float(met["total"]), float(met["grad_norm"])
        assert np.isfinite(loss) and loss > 0 and np.isfinite(gn) and gn > 0, (what, loss, gn)
        params = dict(m.named_parameters())
        off_graph = {n for n, p in params.items() if p.requires_grad and p.grad is None}
        # without the token nothing reads `cls_token`
        assert off_graph == {"visual_net.norm0.weight", "visual_net.norm0.bias"} | (
            {"visual_net.cls_token"} if what == "no_cls" else set()), (what, off_graph)
        assert all(bool(torch.isfinite(p.grad).all()) for p in params.values()
                   if p.grad is not None), what
        for sub in ("visual_net", "decoder_net"):
            assert any(p.grad is not None and float(p.grad.abs().max()) > 0
                       for n, p in params.items() if n.startswith(sub + ".")), (what, sub)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        met = step(opt, batches[1], gen)
        torch.cuda.synchronize()
        tcounts = kernels.launch_counts()
        tpeak = torch.cuda.max_memory_allocated() / 2**30
        assert np.isfinite(float(met["total"])), met
        check_launches(tcounts, path_launches(cfg, train=True), f"{what} train step")
        log(f"[modes] {what} train step: first loss {loss:.4f}, grad_norm {gn:.4f}; launches "
            "per step " + json.dumps({n: k for n, k in tcounts.items() if k})
            + f"; peak memory {tpeak:.2f} GiB")

    def train(what, i):
        opt, step = steps[what]
        return step(opt, batches[i % len(batches)], gen)

    for what, ts in timed_turns({w: functools.partial(train, w) for w in cfgs},
                                MODES_TRAIN_ITERS).items():
        ms = sum(ts) / len(ts)
        log(f"[modes] {what}: {ms:.2f} ms per B={B_TRAIN} step (turns "
            + ", ".join(f"{t:.2f}" for t in ts) + f"), {1000.0 * B_TRAIN / ms:.2f} clips/s on "
            f"{kind} [{smi}]")
    # device time (profiler: every kernel, memcpy and memset) of one run and
    # one step of each model, which the plain attention's logits move
    for what in cfgs:
        run_ms, n_run = device_ms([functools.partial(run, what, 1)])
        step_ms, n_step = device_ms([functools.partial(train, what, 2)])
        log(f"[modes] {what}: device time {run_ms:.3f} ms per DDIM run ({n_run} events), "
            f"{step_ms:.3f} ms per step ({n_step} events) on {kind} [{smi}]")
    del models, steps, batches, inputs
    torch.cuda.empty_cache()
    log(f"[modes] (1) {time.perf_counter() - t0:.1f} s")

    # -- (2) the same mode small, f32, the card against the CPU --------------
    t1 = time.perf_counter()
    hw = (128, 96)
    small = ModelConfig(visual=MViTConfig.tiny(spatial_size=hw, with_cls_token=False),
                        audio=None, spatiotemp=None,
                        decoder=SalUNetConfig(img_size=hw, dropout=0.0,
                                              drop_path_rate=(0.0,) * 4))
    gc = torch.Generator().manual_seed(43)
    rgb, noise = torch.randn(2, 16, *hw, 3, generator=gc), torch.randn(2, *hw, 1, generator=gc)
    cpu_model = build_model(small, seed=44, device="cpu")
    ref = sample_saliency(cpu_model, schedule, sampling, data_cfg, rgb, noise=noise)
    sd = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    card = VideoSaliencyModel(small).eval()
    card.load_state_dict(sd)
    card.to(dev)
    kernels.reset_launch_counts()
    got = sample_saliency(card, schedule, sampling, data_cfg, rgb.to(dev), noise=noise)
    torch.cuda.synchronize()
    c = kernels.launch_counts()
    check_launches(c, f32_launches(small, 1), "f32 no cls token DDIM run")
    err = float((got.cpu() - ref).abs().max())
    assert err <= F32_MAP_TOL, err
    batch = {"rgb": rgb, "salmap": torch.rand(2, *hw, 1, generator=gc)}
    draws = {"deq": torch.randn(2, *hw, 1, generator=gc),
             "noise": torch.randn(2, *hw, 1, generator=gc), "t": torch.tensor(300)}

    def small_step(device):
        m = VideoSaliencyModel(small).train()
        m.load_state_dict(sd)
        m.to(device)
        ecfg = ExperimentConfig(model=small)
        met = make_train_step(m, schedule, ecfg)(make_optimizer(m, ecfg.optim, 10, 2),
                                                 batch, draws=draws)
        return float(met["total"]), {n: p.grad.cpu() for n, p in m.named_parameters()
                                     if p.grad is not None}

    l_cpu, g_cpu = small_step("cpu")
    kernels.reset_launch_counts()
    l_card, g_card = small_step(dev)
    tc = kernels.launch_counts()
    check_launches(tc, f32_launches(small, train=True), "f32 no cls token train step")
    stats, worst = grad_agreement(g_card, g_cpu)
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    log(f"[modes] no cls token f32 small: map card vs CPU max|d| {err:.3e} (limit "
        f"{F32_MAP_TOL}); step loss card {l_card:.6f} CPU {l_cpu:.6f} (rel {loss_err:.3e}); "
        "gradients (relative L2, cosine) " + json.dumps(stats) + f"; worst tensor {worst} "
        f"(limit {F32_GRAD_TOL})")
    assert set(g_card) == set(g_cpu), set(g_card) ^ set(g_cpu)
    assert loss_err <= F32_MAP_TOL and worst[0] <= F32_GRAD_TOL, (loss_err, worst)
    del cpu_model, card
    log(f"[modes] (2) {time.perf_counter() - t1:.1f} s")

    # -- (3) the random-pyramid ablation at full width -----------------------
    t1 = time.perf_counter()
    cfg = ablation_config(False)
    model = build_model(cfg, seed=45, device=dev)
    assert model.visual_net is None
    (H, W) = cfg.decoder.img_size
    want = [(B, T // 2, (H // 4) >> (3 - i), (W // 4) >> (3 - i), c)
            for i, c in enumerate(PYRAMID_DIMS)]
    gen = torch.Generator(device=dev)
    rgb = torch.randn(B, T, H, W, 3, device=dev)
    for x, dtype in ((rgb, torch.float32), (rgb.to(torch.bfloat16), torch.bfloat16),
                     (torch.zeros(B, T, H, W, 3, dtype=torch.uint8, device=dev), torch.float32)):
        pyr = model.encode_visual(x, gen.manual_seed(1))
        assert [tuple(p.shape) for p in pyr] == want, [tuple(p.shape) for p in pyr]
        assert all(p.dtype == dtype and p.device == x.device for p in pyr), (x.dtype, dtype)
    a, a2, b = (model.encode_visual(rgb, gen.manual_seed(seed)) for seed in (1, 1, 2))
    assert all(torch.equal(p, q) for p, q in zip(a, a2))
    assert not any(torch.equal(p, q) for p, q in zip(a, b))
    for fn in (lambda: model.encode_visual(rgb),
               lambda: sample_saliency(model, schedule, sampling, data_cfg, rgb)):
        try:
            fn()
        except ValueError as e:
            assert "generator" in str(e), e
        else:
            raise AssertionError("the random pyramid drew without a generator")
    del a, a2, b, pyr
    log(f"[modes] random pyramid: shapes {want}, the rgb's dtype (f32, bf16; uint8 -> f32), "
        "equal per seed, fresh per seed; no generator raises (encode_visual, sample_saliency)")

    x = torch.randn(B, H, W, 1, device=dev)
    t = torch.tensor([10.0, 700.0], device=dev)
    with torch.no_grad():
        kernels.reset_launch_counts()
        out = model({"rgb": rgb, "input": x}, t, pyramid_generator=gen.manual_seed(3))
        torch.cuda.synchronize()
    c = kernels.launch_counts()
    assert tuple(out.shape) == (B, H, W, 1) and bool(torch.isfinite(out).all()), out.shape
    check_launches(c, path_launches(cfg, 1), "decoder-only ablation forward")
    log("[modes] decoder-only ablation: forward B=2 finite; launches " + json.dumps(
        {n: k for n, k in c.items() if k}))

    model.train()
    ecfg = ExperimentConfig(model=cfg)
    try:
        make_train_step(model, schedule, ecfg)(make_optimizer(model, ecfg.optim, 10, 2),
                                               {"rgb": rgb, "salmap": x.sigmoid()})
    except ValueError as e:
        assert "generator" in str(e), e
    else:
        raise AssertionError("the train step drew a random pyramid without a generator")
    model.zero_grad(set_to_none=True)
    g4 = torch.Generator(device=dev).manual_seed(46)
    rgb4 = torch.randn(B_TRAIN, T, H, W, 3, generator=g4, device=dev)
    x0 = torch.rand(B_TRAIN, H, W, 1, generator=g4, device=dev) * 2 - 1
    xt = torch.randn(B_TRAIN, H, W, 1, generator=g4, device=dev)
    t4 = torch.randint(0, 1000, (B_TRAIN,), generator=g4, device=dev).float()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    pred = model({"rgb": rgb4, "input": xt}, t4, train=True, generator=g4, pyramid_generator=g4)
    loss = torch.mean((pred.float() - x0) ** 2)
    loss.backward()
    torch.cuda.synchronize()
    c = kernels.launch_counts()
    tpeak = torch.cuda.max_memory_allocated() / 2**30
    check_launches(c, path_launches(cfg, train=True), "decoder-only ablation backward")
    params = dict(model.named_parameters())
    mse = float(loss.detach())
    assert np.isfinite(mse), mse
    assert all(bool(torch.isfinite(p.grad).all()) for p in params.values() if p.grad is not None)
    assert any(p.grad is not None and float(p.grad.abs().max()) > 0 for p in params.values())
    log(f"[modes] decoder-only ablation: MSE on x0 {mse:.4f} at B={B_TRAIN}, "
        "gradients finite; launches " + json.dumps({n: k for n, k in c.items() if k})
        + f"; peak memory {tpeak:.2f} GiB")
    del model, pred, loss, params

    cfg = ablation_config(True)
    model = build_model(cfg, seed=47, device=dev)
    audio = torch.randn(B, 9, H // 2, W // 2, 1, device=dev)
    with torch.no_grad():
        kernels.reset_launch_counts()
        out = model({"rgb": rgb, "input": x, "audio": audio}, t,
                    pyramid_generator=gen.manual_seed(4))
        torch.cuda.synchronize()
    c = kernels.launch_counts()
    assert tuple(out.shape) == (B, H, W, 1) and bool(torch.isfinite(out).all()), out.shape
    check_launches(c, path_launches(cfg, 1), "AV ablation forward")
    log("[modes] AV ablation: forward B=2 finite; launches " + json.dumps(
        {n: k for n, k in c.items() if k}))
    del model
    torch.cuda.empty_cache()
    log(f"[modes] (3) {time.perf_counter() - t1:.1f} s; phase {time.perf_counter() - t0:.1f} s")


TP_MESH = (2, 2)         # (data, model): four gloo ranks sharing the one card
TP_ITERS = 3             # timed DDIM runs per rank
TP_MAP_TOL = 3e-2        # the bf16 layout bound of phases 8, 9 and 16
TP_TIMEOUT_S = 300       # the launch, as a whole
TP_GROUP_TIMEOUT_S = 240
TP_STEP = 300            # the backward's timestep


def tp_train_batch(cfg, dev):
    """The backward's global batch (B=2) and its x_T noise."""
    batch = train_batch(B, cfg.model, 18, dev)
    g = torch.Generator(device=dev).manual_seed(19)
    batch["noise"] = torch.randn(batch["salmap"].shape, generator=g, device=dev)
    return batch


def tp_backward(model, cfg, schedule, batch):
    """One bf16 loss backward of the MSE on x0 at TP_STEP in train mode
    (phase 16's config: dropout and DropPath 0), as the training step
    computes it without the optimizer."""
    from diff_sal_tpu_torch.diffusion.schedule import q_sample
    from diff_sal_tpu_torch.train.losses import training_loss

    x0 = batch["salmap"].float()
    t = torch.full((x0.shape[0],), TP_STEP, device=x0.device)
    x_noisy = q_sample(schedule, x0, t.long(), batch["noise"].float())
    pred = model({"rgb": batch["rgb"], "input": x_noisy, "audio": batch["audio"]}, t,
                 train=True)
    loss = training_loss(cfg.loss, pred, x0)["total"]
    loss.backward()
    return float(loss.detach())


def tp_worker(spec_path: str, rank: int) -> int:
    """A rank of phase 18: joins the group on the one card, builds the
    ('data', 'model') mesh, shards phase 3's model and runs DDIM NFE 1 on
    its data row of phase 3's inputs and noise (launches counted in the
    second run, then TP_ITERS timed runs), then one bf16 loss backward on
    its row of the backward's batch; writes its results under
    spec["out"]."""
    import gc
    import hashlib
    import os

    import torch.distributed as dist

    from diff_sal_tpu_torch.config import DataTransformConfig, SamplingConfig
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import build_model
    from diff_sal_tpu_torch.ops import kernels
    from diff_sal_tpu_torch.parallel import mesh, multihost, tensor

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    world = TP_MESH[0] * TP_MESH[1]
    dev = torch.device(DEVICE)
    dev = torch.device("cuda", 0) if dev.type == "cuda" else dev  # every rank on the one card
    multihost.initialize(init_method=f"tcp://127.0.0.1:{spec['port']}", world_size=world,
                         rank=rank, local_rank=rank, local_world_size=world, device=dev,
                         timeout_s=TP_GROUP_TIMEOUT_S)
    try:
        dmesh = mesh.make_device_mesh(*TP_MESH, device_type=dev.type)
        data = dmesh.get_group("data")
        d = dmesh.get_coordinate()[0]
        res = {"rank": rank, "backend": dist.get_backend(), "coord": list(dmesh.get_coordinate())}
        cfg, schedule = main_config(), make_schedule()
        model = tensor.shard_model(build_model(cfg, seed=0, device=dev), dmesh)
        res["local_bytes"] = tensor.local_bytes(model)
        res["sharded"] = sum(tensor.is_sharded(p) for p in model.parameters())
        # phase 3's inputs and x_T (its run(0)), this data rank's row
        g = torch.Generator(device=dev).manual_seed(0)
        (H, W), T = cfg.decoder.img_size, cfg.visual.temporal_size
        rgb = torch.randn(B, T, H, W, 3, generator=g, device=dev) * 0.5
        audio = torch.randn(B, 9, H // 2, W // 2, 1, generator=g, device=dev)
        noise = torch.randn((B, H, W, 1), generator=torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        rows = [t[d::TP_MESH[0]] for t in (rgb, audio, noise)]

        def run():
            with torch.no_grad():
                return sample_saliency(model, schedule, SamplingConfig(), DataTransformConfig(),
                                       rows[0], rows[1], noise=rows[2])

        run()  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        res["launches"] = kernels.launch_counts()
        torch.save(out.float().cpu(), os.path.join(spec["out"], f"map_{rank}.pt"))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(TP_ITERS + 1)]
        ev[0].record()
        for i in range(TP_ITERS):
            run()
            ev[i + 1].record()
        torch.cuda.synchronize()
        res["ms"] = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # -- (d): one bf16 loss backward on this rank's row ----------------------
        tcfg = dp_config("bfloat16")
        model = tensor.shard_model(build_model(tcfg.model, seed=0, device=dev, train=True),
                                   dmesh)
        model.set_stats_group(data)
        batch = {k: v[d::TP_MESH[0]] for k, v in tp_train_batch(tcfg, dev).items()}
        torch.cuda.reset_peak_memory_stats()
        res["loss"] = tp_backward(model, tcfg, schedule, batch)
        mesh.average_gradients(list(model.parameters()), data)
        with torch.no_grad():
            grads = {n: tensor.full(p.grad).float().cpu() for n, p in model.named_parameters()
                     if p.grad is not None}
        torch.cuda.synchronize()
        res["backward_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        digest = hashlib.sha256()
        for n in sorted(grads):
            if not tensor.is_sharded(model.get_parameter(n)):
                digest.update(n.encode() + grads[n].numpy().tobytes())
        res["replicated_digest"] = digest.hexdigest()
        if rank == 0:
            torch.save(grads, os.path.join(spec["out"], "grads_0.pt"))
        mesh.barrier(dist.group.WORLD)
        res["seconds"] = time.perf_counter() - t_start
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        multihost.shutdown()
    return 0


def tp_phase(dev, kind, smi, schedule, data_cfg, main_map):
    """Phase 18: tensor parallelism (see the module docstring)."""
    import gc
    import os
    import shutil
    import tempfile

    from diff_sal_tpu_torch.config import SamplingConfig
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import build_model
    from diff_sal_tpu_torch.parallel import tensor

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    world = TP_MESH[0] * TP_MESH[1]
    try:
        # -- the one-process references: ms per DDIM run, the backward ------
        cfg = main_config()
        model = build_model(cfg, seed=0, device=dev)
        whole = sum(t.numel() * t.element_size() for t in model.state_dict().values())
        axes = tensor.tensor_parallel_axes(model, TP_MESH[1])
        sd = model.state_dict()
        sharded_bytes = sum(sd[n].numel() * sd[n].element_size()
                            for n, a in axes.items() if a is not None)
        predicted = whole - sharded_bytes + sharded_bytes // TP_MESH[1]
        g = torch.Generator(device=dev).manual_seed(0)
        (H, W), T = cfg.decoder.img_size, cfg.visual.temporal_size
        rgb = torch.randn(B, T, H, W, 3, generator=g, device=dev) * 0.5
        audio = torch.randn(B, 9, H // 2, W // 2, 1, generator=g, device=dev)
        sampling = SamplingConfig()

        def run(i=0):
            with torch.no_grad():
                return sample_saliency(model, schedule, sampling, data_cfg, rgb, audio,
                                       generator=torch.Generator(device=dev).manual_seed(i))

        run()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(TP_ITERS + 1)]
        ev[0].record()
        for i in range(TP_ITERS):
            run(i)
            ev[i + 1].record()
        torch.cuda.synchronize()
        plain_ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        del model, sd
        tcfg = dp_config("bfloat16")
        model = build_model(tcfg.model, seed=0, device=dev, train=True)
        ref_loss = tp_backward(model, tcfg, schedule, tp_train_batch(tcfg, dev))
        ref = {n: p.grad.float().cpu() for n, p in model.named_parameters()
               if p.grad is not None}
        del model
        gc.collect()
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t0

        # -- the four ranks ----------------------------------------------------
        spec = os.path.join(tmp, "tp.json")
        with open(spec, "w") as f:
            json.dump({"port": free_port(), "out": tmp}, f)
        me = os.path.abspath(__file__)
        secs = dp_launch([[sys.executable, me, "--tp-spec", spec, "--tp-rank", str(r)]
                          for r in range(world)],
                         [os.path.join(tmp, f"tp_{r}.log") for r in range(world)], TP_TIMEOUT_S)
        res = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
        assert [r["backend"] for r in res] == ["gloo"] * world, res
        assert [tuple(r["coord"]) for r in res] == [
            (r // TP_MESH[1], r % TP_MESH[1]) for r in range(world)], res
        # (a) the maps: data rank d's row of phase 3's map (each model rank
        # computes the same row)
        ref_map = main_map.float().cpu()
        d_map = 0.0
        for r in range(world):
            got = torch.load(os.path.join(tmp, f"map_{r}.pt"), weights_only=True)
            d = r // TP_MESH[1]
            assert tuple(got.shape) == (1, H, W, 1) and bool(torch.isfinite(got).all()), r
            d_map = max(d_map, float((got - ref_map[d::TP_MESH[0]]).abs().max()))
        log(f"[tp] {TP_MESH[0]} x {TP_MESH[1]} ('data', 'model') mesh: {world} gloo ranks on "
            f"the one card, phase 3's model and inputs, {res[0]['sharded']} parameters sharded "
            f"on 'model' by JAX's rule (min_dim 256); (a) DDIM NFE 1, one row per data rank: "
            f"maps vs phase 3's rows max|d| {d_map:.3e} (bound {TP_MAP_TOL}); launch "
            f"{secs:.1f} s")
        assert d_map <= TP_MAP_TOL, d_map
        # (b) every rank launches K1-K4 as one process does per run
        want = path_launches(cfg, 1)
        for r in res:
            check_launches(r["launches"], want, f"tp rank {r['rank']}")
        log("[tp] (b) launches per run on every rank = path_launches(cfg, 1) "
            + json.dumps({k: v for k, v in res[0]["launches"].items() if v}))
        # (c) each rank's parameters and buffers
        mib = [r["local_bytes"] / 2**20 for r in res]
        log(f"[tp] (c) parameters and buffers per rank {', '.join(f'{m:.2f}' for m in mib)} "
            f"MiB (the rule's prediction {predicted / 2**20:.2f}) against {whole / 2**20:.2f} "
            f"MiB whole")
        assert all(r["local_bytes"] == predicted for r in res), (mib, predicted)
        # (d) the backward against one process
        got = torch.load(os.path.join(tmp, "grads_0.pt"), weights_only=True)
        assert set(got) == set(ref), set(got) ^ set(ref)
        stats, worst = grad_agreement(got, ref)
        losses = [r["loss"] for r in res]
        columns = {m: {res[d * TP_MESH[1] + m]["replicated_digest"] for d in range(TP_MESH[0])}
                   for m in range(TP_MESH[1])}
        rows_equal = len({r["replicated_digest"] for r in res}) == 1
        log(f"[tp] (d) one bf16 loss backward at B={B} (a row per data rank): losses "
            + json.dumps([round(x, 6) for x in losses]) + f" (one process {ref_loss:.6f}, "
            f"the mean over data ranks is its loss); gathered gradients vs one process's "
            f"(relative L2, cosine) " + json.dumps(stats) + f" worst tensor {worst} (bound "
            f"per sub-network: cosine >= {LAYOUT_GRAD_COS}); replicated gradients bitwise "
            f"equal down each model column {all(len(c) == 1 for c in columns.values())}, "
            f"across all ranks {rows_equal}; backward peak "
            + ", ".join(f"{r['backward_peak_gib']:.2f}" for r in res) + " GiB per rank")
        for sub, (_, cos) in stats.items():
            assert cos >= LAYOUT_GRAD_COS, (sub, cos)
        assert all(len(c) == 1 for c in columns.values()), columns
        fmt = lambda ms: ", ".join(f"{t:.2f}" for t in ms)  # noqa: E731
        log(f"[tp] ms per DDIM run by CUDA events ({TP_ITERS} runs after a warm-up; a record, "
            f"not a claim: gloo moves every gather through host memory): one process B={B} "
            f"{fmt(plain_ms)}; each rank B=1 " + "; ".join(
                f"rank {r['rank']} {fmt(r['ms'])}" for r in res)
            + f"; rank seconds " + ", ".join(f"{r['seconds']:.1f}" for r in res)
            + f" on {kind} [{smi}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[tp] phase {time.perf_counter() - t0:.1f} s (references {t_ref:.1f} s)")


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
                         "training step in each layout, each attention kernel's "
                         "recorded calls by CUDA kernel, and one epoch of the "
                         "trainer's fit")
    # phase 16's own processes: a rank of (a)-(c), and (d)'s torchrun rank;
    # phase 18's ranks
    ap.add_argument("--dp-spec", help=argparse.SUPPRESS)
    ap.add_argument("--dp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp-cli", help=argparse.SUPPRESS)
    ap.add_argument("--tp-spec", help=argparse.SUPPRESS)
    ap.add_argument("--tp-rank", type=int, help=argparse.SUPPRESS)
    cli = ap.parse_args()
    if cli.tp_spec is not None:
        return tp_worker(cli.tp_spec, cli.tp_rank)
    if cli.dp_spec is not None:
        return dp_worker(cli.dp_spec, cli.dp_rank)
    if cli.dp_cli is not None:
        return dp_cli_worker(cli.dp_cli)

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
    main_map = out.clone()  # phase 15 reads it back from an imported checkpoint
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

    # -- phase 13: the trainer from a packed tree to checkpoints -------------
    trainer_phase(dev, kind, smi, profile=cli.profile)

    # -- phase 14: the entry points ------------------------------------------
    entry_phase(dev, kind, smi, schedule, data_cfg)

    # -- phase 15: the released-checkpoint import and MViT's remat -----------
    t0 = time.perf_counter()
    import_phase(dev, kind, smi, schedule, data_cfg, main_map)
    remat_phase(dev, kind, smi, schedule)
    log(f"[import + remat] phase {time.perf_counter() - t0:.1f} s")

    # -- phase 16: data parallelism over torch.distributed -------------------
    dp_phase(dev, kind, smi, schedule)

    # -- phase 17: MViT without its cls token, the random-pyramid ablation ---
    modes_phase(dev, kind, smi, schedule, data_cfg)

    # -- phase 18: tensor parallelism on a ('data', 'model') mesh -------------
    tp_phase(dev, kind, smi, schedule, data_cfg, main_map)

    log("[device time] profiler sessions " + json.dumps(DEVICE_MS_TALLY))
    log(f"[total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
