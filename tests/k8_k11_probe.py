"""What bounds K8 (the fused decoder head) and K11 (the attention pool) on
the card, at the shapes of the full-width AV model's DPM++ run, B=2. Not a
test (pytest collects only test_*.py); run it from the repository root on
a machine with a CUDA device and nvcc (~2 min):

    PYTHONPATH=. python3 tests/k8_k11_probe.py

- K8 bf16 at the head's shape (four task maps at 7x12 .. 56x96 summed to
  112x192, C = 768, O = 96), two calls (one run at NFE 2): the device time
  of the kernel and of copies built from edited versions of
  `csrc/resize_conv.cu` under the git-ignored `_build/`: its products
  switched off (the producers' gather alone), its gather switched off (the
  products, the TMA loads and the patch copies alone), and its producers
  writing one copy of each halo pixel in place of the three dx-shifted ones
  (their store traffic as it would be if A came from registers by
  ldmatrix; the consumers then read stale copies, so only the time means
  anything);
- K8 f32 on the same shape in f32: the distance from the plain version
  computed in f64 of the kernel, of the plain version in f32 (one cuDNN
  conv2d, TF32 off) and of the conv as nine shifted f32 matrix products;
- K11: for each pool call shape of the run (x a column slice of the qkv
  output, as MViT pools it), the device time at every walk length (planes
  per thread, 1..8) with the plan's strip, the plan's own pick, and the
  run's total (each shape times its calls per run) for the plan's walks,
  for the walks that keep two 128-thread CTAs on each of 132 SMs where the
  shape allows, and for the fastest walk of each shape;
- K11's tiled pool weight (`MultiScaleAttention._pool_weight`): the host
  time of the run's 30 pool weights built afresh against taken from the
  per-module cache, and the device time of the builds.

Device time is the profiler's (`chip_smoke.device_ms`). Prints one JSON line
per part and the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import statistics
import time
from collections import Counter

import torch

import chip_smoke
from diff_sal_tpu_torch.config import ModelConfig
from diff_sal_tpu_torch.models.mvit import MultiScaleAttention, MViT, block_plan
from diff_sal_tpu_torch.ops import kernels as K
from diff_sal_tpu_torch.ops import pool, resize

HEAD = [(7, 12), (14, 24), (28, 48), (56, 96)]


def head_args(dtype, seed: int = 864, C: int = 768, O: int = 96):
    g = torch.Generator().manual_seed(seed)
    xs = [(torch.randn((2, h, w, C), generator=g) * 0.5).to("cuda", dtype) for h, w in HEAD]
    k = (torch.randn((3, 3, C, O), generator=g) * (9 * C) ** -0.5 * 2).to("cuda", dtype)
    b = (torch.randn((O,), generator=g) * 0.1).to("cuda", torch.float32)
    return xs, (112, 192), k, b


# edits of csrc/resize_conv.cu: (text, replacement), each text found once
K8_VARIANTS = {
    "products_off": ("wgmma_ss<NP>(acc[h],", "if (a.n < 0) wgmma_ss<NP>(acc[h],"),
    "gather_off": ("for (int i = 0; i < a.n; ++i) {\n        const Patch pi",
                   "for (int i = 0; i < 0; ++i) {\n        const Patch pi"),
    "one_store_per_pixel": ("for (int dx = 0; dx < 3; ++dx) {\n          const int col = hx - dx;",
                            "for (int dx = 0; dx < 1; ++dx) {\n          const int col = hx - dx;"),
}


def k8_parts() -> dict:
    src = (K.CSRC_DIR / "resize_conv.cu").read_text()
    xs, hw, k, b = head_args(torch.bfloat16)

    def run():
        return resize.resize_sum_conv_relu(xs, hw, k, b)
    out = {"kernel": chip_smoke.device_ms([run, run])[0]}
    kern0, csrc0 = resize.CONV_KERNEL, K.CSRC_DIR
    kern0.fn()
    var = K.BUILD_DIR / "variants"
    var.mkdir(parents=True, exist_ok=True)
    for h in ("hopper.cuh", "tf32.cuh"):
        shutil.copy(csrc0 / h, var / h)
    try:
        # the wrapper launches resize.CONV_KERNEL, built from K.CSRC_DIR
        K.CSRC_DIR = var
        for name, (old, new) in K8_VARIANTS.items():
            assert src.count(old) == 1, name
            (var / f"resize_conv_{name}.cu").write_text(src.replace(old, new))
            resize.CONV_KERNEL = K.Kernel(f"resize_conv_relu_{name}", f"resize_conv_{name}.cu",
                                          kern0.entry, kern0.argtypes, kern0.replaces)
            out[name] = chip_smoke.device_ms([run, run])[0]
    finally:
        resize.CONV_KERNEL, K.CSRC_DIR = kern0, csrc0
    return {"k8_bf16_ms_per_two_calls": out}


def nine_products(xs, out_hw, kernel, bias):
    """The plain version's function with the 3x3 conv as nine shifted
    matrix products in x's dtype, as the TPU kernel contracts it."""
    a = resize.bilinear_resize_sum_plain(xs, out_hw)
    B, H, W, C = a.shape
    ap = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
    y = sum(ap[:, dy:dy + H, dx:dx + W].reshape(-1, C) @ kernel[dy, dx]
            for dy in range(3) for dx in range(3))
    return torch.relu(y.reshape(B, H, W, -1) + bias.to(y.dtype))


def k8_f32_accuracy() -> dict:
    xs, hw, k, b = head_args(torch.float32)
    with torch.no_grad():
        ref = resize.resize_sum_conv_relu_plain([x.double() for x in xs], hw, k.double(),
                                                b.double())
        got = {"kernel": resize.resize_sum_conv_relu(xs, hw, k, b),
               "plain_one_cudnn_conv2d": resize.resize_sum_conv_relu_plain(xs, hw, k, b),
               "nine_shifted_f32_products": nine_products(xs, hw, k, b)}
    out = {n: float((t.double() - ref).abs().max()) for n, t in got.items()}
    return {"k8_f32_max_abs_from_f64": {**out, "max_abs_out": float(ref.abs().max())}}


def pool_calls():
    """Every pool of the full-width AV model's MViT as K11 takes it, with
    its calls per run: (B, T, H, W), column range of qkv, stride."""
    calls = Counter()
    for p in block_plan(ModelConfig.audio_visual().visual):
        C, (T, H, W) = p["out_dims"], p["in_size"]
        if p["stride_q"] == p["stride_kv"]:
            calls[((2, T, H, W), C, 0, 3 * C, p["stride_q"])] += 1
        else:
            calls[((2, T, H, W), C, 0, C, p["stride_q"])] += 1
            calls[((2, T, H, W), C, C, 3 * C, p["stride_kv"])] += 1
    return calls


def two_cta_walk(B, T, H, W, C, sh, sw) -> int:
    """The walk that halves until two CTAs sit on each SM (or one plane)."""
    tb = T
    while tb > 1 and _ctas(B, T, H, W, C, sh, sw, tb) < 2 * pool.NUM_SMS:
        tb = -(-tb // 2)
    return tb


def _ctas(B, T, H, W, C, sh, sw, tb) -> int:
    p = pool.pool_plan(B, T, H, W, C, sh, sw)
    rows = p.threads // p.t_blocks
    return -(-rows * -(-T // tb) // pool.POOL_THREADS)


def k11_walks() -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    out, totals = {}, {"plan": 0.0, "two_ctas_per_sm": 0.0, "fastest": 0.0}
    for ((B, T, H, W), C, lo, hi, (_, sh, sw)), n in sorted(pool_calls().items()):
        qkv = torch.randn(B, T, H, W, 3 * C, generator=g, device="cuda").bfloat16()
        x = qkv[..., lo:hi]
        w = torch.randn(3, 3, 3, hi - lo, generator=g, device="cuda") * 0.3
        Ho, Wo = (H - 1) // sh + 1, (W - 1) // sw + 1
        y = torch.empty(B, T, Ho, Wo, hi - lo, dtype=torch.bfloat16, device="cuda")
        ref = pool.pool_plain(x, w, (1, sh, sw))
        plan = pool.pool_plan(B, T, H, W, hi - lo, sh, sw)
        row = {"calls_per_run": n, "plan": [plan.strip, plan.t_block]}
        us = {}
        for tb in (1, 2, 4, 8):
            def f(tb=tb):
                pool.KERNEL.launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, T, H, W,
                                   hi - lo, x.stride(3), Ho, Wo, sh, sw, plan.strip, tb, 1,
                                   K.stream())
            f()
            torch.cuda.synchronize()
            assert torch.equal(y, ref), ((B, T, H, W), hi - lo, sh, tb)
            us[tb] = chip_smoke.device_ms([f])[0] * 1e3
            row[f"us_walk{tb}"] = us[tb]
        two = two_cta_walk(B, T, H, W, hi - lo, sh, sw)
        row["two_ctas_per_sm_walk"] = two
        totals["plan"] += n * us[plan.t_block]
        totals["two_ctas_per_sm"] += n * us[two]
        totals["fastest"] += n * min(us.values())
        out[f"{(B, T, H, W)} C{hi - lo} s{sh} pixel stride {3 * C}"] = row
    return {"k11_us_per_call_by_walk": out, "k11_us_per_run": totals}


def pool_weight_cache(device="cuda", reps: int = 20) -> dict:
    """Host ms of the run's 30 K11 pool weights built afresh and taken
    from the cache (median of `reps`), and the builds' device ms."""
    cfg = ModelConfig.audio_visual().visual
    model = MViT(dataclasses.replace(cfg, pool_mode="pallas")).to(device).eval()
    attns = [m for m in model.modules() if isinstance(m, MultiScaleAttention)]
    parts = [(m, ps) for m in attns
             for ps in (("qkv",) if m.stride_q == m.stride_kv else ("q", "kv"))]

    def weights(fresh: bool):
        for m, ps in parts:
            if fresh:
                m._pool_weights.clear()
            m._pool_weight(ps)

    def host_ms(fresh: bool):
        times = []
        with torch.no_grad():
            for _ in range(reps):
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                weights(fresh)
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), min(times), max(times)
    with torch.no_grad():
        weights(True)
    built, cached = host_ms(True), host_ms(False)
    out = {"weights_per_run": len(parts),
           "host_ms_built": built, "host_ms_cached": cached}
    if device == "cuda":
        with torch.no_grad():
            out["device_ms_built"] = chip_smoke.device_ms([lambda: weights(True)])[0]
    return {"k11_pool_weight_per_run (median, min, max)": out}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k8_k11_probe: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(k8_parts()), flush=True)
    print(json.dumps(k8_f32_accuracy()), flush=True)
    print(json.dumps(k11_walks()), flush=True)
    print(json.dumps(pool_weight_cache()), flush=True)
    print(chip_smoke.nvidia_smi_line())


if __name__ == "__main__":
    main()
