"""Drive the PyTorch port's main path on one NVIDIA GPU and hold each of its
hand-written kernels against its plain PyTorch version.

    python3 chip_smoke.py [--iters N] [--profile]

Phases (each prints its wall time; any failure raises and exits non-zero):
  1. require CUDA and print the card's name and power limit (nvidia-smi);
  2. build the four kernels from `diff_sal_tpu_torch/csrc/` (one nvcc per
     source, all started together; cached by source hash in
     `diff_sal_tpu_torch/_build/`);
  3. main path at full width: `ModelConfig.audio_visual()` (MViTv2-small at
     224x384x16, VGGish, AudioAttnNet, SalUNet) in bf16 from seeded random
     weights, B=2, `sample_saliency` with DDIM NFE=1; checks the (B,224,384,1)
     map is finite, in [0, 1] and not constant; counts each kernel's launches
     in one run (counts set to 0 just before it, read just after) and
     records every kernel call's inputs; times the path with CUDA events on
     rotating inputs and prints clips/s;
  4. each kernel against its plain version on exactly the recorded inputs
     (working dtype, stated tolerance), with the kernel, the plain version,
     the one PyTorch call that computes the same function where there is
     one, and the least time the card could take (bytes over 3.35 TB/s or
     operations over the peak rate of their type, whichever is larger);
  5. the whole port at a small size: bf16 through the kernels on the card
     against f32 through the plain versions on the CPU;
then prints the `kernels` JSON line, the nvidia-smi line and, last, the
result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM
BF16_TENSOR_FLOPS = 989e12      # dense bf16 tensor cores
F32_FLOPS = 67e12               # f32 outside the tensor cores
B = 2
DEVICE = "cuda"
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 0.0)}  # (atol, rtol)
# bf16: kernel and plain version round the same f32 values at other points
# and may differ by one bf16 ulp of the output, which atol + rtol*|x| covers.


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
        return obj.detach().clone()
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
    """(bytes, operations, peak rate of those operations) one call must
    at least move and compute."""
    if kernel == "bias_attention":
        q, k, v, rel, (kt, kh, kw_), H = args[:6]
        Bq, Lq, HD = q.shape
        Lk = k.shape[1]
        nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + rel.numel() * 2
        return nbytes, 4.0 * Bq * Lq * Lk * HD, BF16_TENSOR_FLOPS
    if kernel == "layer_norm":
        x, w, b = args[:3]
        C = x.shape[-1]
        return 2 * x.numel() * x.element_size() + 2 * C * 4, 8.0 * x.numel(), F32_FLOPS
    if kernel == "block_tail":
        skip, attn, lw, lb, w1, b1, w2, b2 = args[:8]
        R, C = skip.shape
        Hd = w1.shape[0]
        nbytes = 3 * R * C * 2 + 2 * C * Hd * 2 + (3 * C + Hd) * 4
        return nbytes, 4.0 * R * C * Hd, BF16_TENSOR_FLOPS
    if kernel == "bilinear_resize_sum":
        xs, (H, W) = args[:2]
        out = xs[0].shape[0] * H * W * xs[0].shape[-1]
        nbytes = sum(x.numel() for x in xs) * xs[0].element_size() + out * xs[0].element_size()
        return nbytes, 8.0 * len(xs) * out, F32_FLOPS
    raise KeyError(kernel)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10, help="timed main-path iterations")
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler table of one main-path run")
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

    from diff_sal_tpu_torch.config import (AudioAttnConfig, DataTransformConfig, ModelConfig,
                                           MViTConfig, SalUNetConfig, SamplingConfig,
                                           VGGishConfig)
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.inference import sample_saliency
    from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel, build_model
    from diff_sal_tpu_torch.ops import attention, kernels, layernorm, mlp, resize

    # -- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    secs = kernels.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s " + json.dumps(secs))
    for k in kernels.registry().values():
        for line in k.build_log.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[ptxas {k.name}] {line.strip()}")

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
    }
    for r in recorders.values():
        r.on = True
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
    missing = [n for n, c in counts.items() if c == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
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
    }
    F = torch.nn.functional

    def library(name, args, kw):
        if name == "layer_norm":
            x, w, b = args[:3]
            eps = args[3] if len(args) > 3 else kw.get("eps", 1e-6)
            w, b = w.to(x.dtype), b.to(x.dtype)
            return lambda: F.layer_norm(x, (x.shape[-1],), w, b, eps)
        if name == "bias_attention":
            q, k, v, rel, (kt, kh, kw_), H, scale = args[:7]
            Bq, Lq, HD = q.shape
            D = HD // H
            r = rel.float()
            bias = (r[..., :kt, None, None] + r[..., None, kt:kt + kh, None]
                    + r[..., None, None, kt + kh:]).reshape(Bq, Lq, H, -1)
            bias = F.pad(bias, (1, 0)).permute(0, 2, 1, 3).to(q.dtype).contiguous()
            q4, k4, v4 = (t.reshape(Bq, -1, H, D).transpose(1, 2) for t in (q, k, v))
            return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias,
                                                          scale=scale)
        return None

    rows = []
    for name, rec in recorders.items():
        assert rec.calls, name
        err = kern_ms = plain_ms = lib_ms = 0.0
        t_bytes = t_ops = 0.0
        has_lib = False
        for args, kw in rec.calls:
            got = recorders[name].fn(*args, **kw)
            ref = plain[name](*args, **kw)
            torch.cuda.synchronize()
            atol, rtol = TOL[ref.dtype]
            diff = (got.float() - ref.float()).abs()
            bad = diff > atol + rtol * ref.float().abs()
            assert not bool(bad.any()), (
                f"{name}: kernel disagrees with its plain version at shape "
                f"{tuple(got.shape)}: max|d| {float(diff.max()):.3e}")
            err = max(err, float(diff.max()))
            kern_ms += cuda_ms(lambda: recorders[name].fn(*args, **kw))
            plain_ms += cuda_ms(lambda: plain[name](*args, **kw), reps=3, warmup=1)
            lib = library(name, args, kw)
            if lib is not None:
                has_lib = True
                lib_ms += cuda_ms(lib)
            nbytes, ops, peak = bound_terms(name, args, kw)
            t_bytes += nbytes / HBM_BYTES_PER_S * 1e3
            t_ops += ops / peak * 1e3
        kern = kernels.registry()[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"diff_sal_tpu_torch/csrc/{kern.source}",
            "replaces": kern.replaces.split()[0],
            "launches": counts[kern.name],
            "max_abs_err": err,
            "ms": kern_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms if has_lib else None,
        })
        log(f"[kernel {name}] {len(rec.calls)} calls per run: kernel {kern_ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, library {lib_ms if has_lib else None}, "
            f"bound {max(t_bytes, t_ops):.3f} ms (bytes {t_bytes:.3f}, ops {t_ops:.3f}), "
            f"max|d| {err:.3e}")
    for rec in recorders.values():
        rec.calls.clear()
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

    log(f"[total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
