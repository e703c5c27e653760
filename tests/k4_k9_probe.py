"""What bounds K4 (the decoder's multi-scale resize-sum) and K9 (the
conv-at-low-res head) on the card, at the decoder's shapes, B=2: four task
maps at 7x12 .. 56x96 summed to 112x192, C = 768 for K4, O = 96 for K9. Not
a test (pytest collects only test_*.py); run it from the repository root on
a machine with a CUDA device and nvcc (~3 min):

    PYTHONPATH=. python3 tests/k4_k9_probe.py [--parent DIR] [--baseline DIR]

- both kernels against their plain versions at the decoder's shapes;
- the device time of one call (K4) or of the two calls of a DPM++ NFE 2
  run (K9: its gather kernel alone, on u_i computed beforehand, and with
  its cuBLAS products) at the plan's geometry and at every band height
  and channel chunk the entry takes, in bf16 and f32, each launched
  through the entry with that geometry;
- at the plans' geometry (bf16), copies of `csrc/separable.cuh` under the
  git-ignored `_build/` built with the column pass unrolled over the
  inputs, with one row-pass item in flight per thread, with strips of two
  output columns, each against the kernel's own bits;
- the same with the column pass switched off (the
  setup and the row pass alone), the row pass switched off (the setup and
  the column pass, on stale shared memory: only the time means anything),
  and both (the setup alone);
- with `--parent DIR` (the `diff_sal_tpu_torch/csrc` of an earlier tree,
  whose K4 and K9 entries take no plan), that tree's K4 and K9 kernels
  built from DIR and timed on the same inputs;
- with `--baseline DIR` (a csrc directory holding another version of
  these entries, same arguments), that version against this one at the
  plans' geometry, in turns;
- the ptxas lines (registers, spills) of both sources.

Device time is the profiler's (`chip_smoke.device_ms`). Prints one JSON line
per part and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
from pathlib import Path

import torch

import chip_smoke
from diff_sal_tpu_torch.ops import kernels as K
from diff_sal_tpu_torch.ops import resize

MAPS = ((7, 12), (14, 24), (28, 48), (56, 96))
OUT = (112, 192)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def args_for(dtype, seed: int = 12, C: int = 768, O: int = 96):
    g = torch.Generator().manual_seed(seed)
    xs = [(torch.randn((2, h, w, C), generator=g) * 0.5).to("cuda", dtype) for h, w in MAPS]
    k = (torch.randn((3, 3, C, O), generator=g) * (9 * C) ** -0.5 * 2).to("cuda", dtype)
    b = (torch.randn((O,), generator=g) * 0.1).to("cuda", torch.float32)
    return xs, k, b


def _pad(vals, fill):
    return list(vals) + [fill] * (resize.MAX_INPUTS - len(vals))


def _ctas(B, bh, cc, tw, C):
    units = -(-OUT[0] // bh) * -(-C // cc) * -(-OUT[1] // tw) * B
    return min(units, resize.SEP_CTAS_PER_SM * resize.NUM_SMS)


def k4_launcher(xs, bh, cc, tw, kern=None):
    """K4's entry at an explicit geometry; None where the entry refuses it."""
    kern = kern or resize.KERNEL
    B, C, dt = xs[0].shape[0], xs[0].shape[-1], xs[0].dtype
    H, W = OUT
    shapes = tuple((x.shape[1], x.shape[2]) for x in xs)
    a_idx, a_wts = resize._tap_arrays(shapes, OUT)
    cols = max(1, sum(resize._spans(a_idx, a_wts, 1, H, W, tw)))
    if resize.sep_smem(len(xs), 1, bh, tw, cols, cc, 4) > resize.SMEM_MAX:
        return None
    ctas = _ctas(B, bh, cc, tw, C)
    idx, wts = resize._tap_tables(shapes, OUT, xs[0].device)
    out = torch.empty((B, H, W, C), dtype=dt, device=xs[0].device)

    def run():
        kern.launch(*_pad([x.data_ptr() for x in xs], None), idx.data_ptr(), wts.data_ptr(),
                    out.data_ptr(), *_pad([s[0] for s in shapes], 0),
                    *_pad([s[1] for s in shapes], 0), len(xs), B, H, W, C, bh, cc, tw, cols, ctas,
                    int(dt == torch.bfloat16), K.stream())
        return out
    return run


def k9_launcher(us, b, O, bh, cc, tw, kern=None):
    """K9's gather kernel alone on u_i computed beforehand, at an explicit
    geometry; None where the entry refuses it."""
    kern = kern or resize.PHASE_KERNEL
    B, dt = us[0].shape[0], us[0].dtype
    H, W = OUT
    shapes = tuple((u.shape[1], u.shape[2]) for u in us)
    a_idx, a_wts = resize._phase_arrays(shapes, OUT, dt)
    cols = max(1, sum(resize._spans(a_idx, a_wts, 3, H, W, tw)))
    mid = 2 if dt == torch.bfloat16 else 4
    if resize.sep_smem(len(us), 3, bh, tw, cols, cc, mid) > resize.SMEM_MAX:
        return None
    ctas = _ctas(B, bh, cc, tw, O)
    idx, wts = resize._phase_tables(shapes, OUT, dt, us[0].device)
    out = torch.empty((B, H, W, O), dtype=dt, device=us[0].device)

    def run():
        kern.launch(*_pad([u.data_ptr() for u in us], None), idx.data_ptr(), wts.data_ptr(),
                    b.data_ptr(), out.data_ptr(), *_pad([s[0] for s in shapes], 0),
                    *_pad([s[1] for s in shapes], 0), len(us), B, H, W, O, bh, cc, tw, cols, ctas,
                    int(dt == torch.bfloat16), K.stream())
        return out
    return run


def check() -> dict:
    out = {}
    for name, dt in DTYPES.items():
        xs, k, b = args_for(dt)
        with torch.no_grad():
            d4 = (resize.bilinear_resize_sum(xs, OUT).float()
                  - resize.bilinear_resize_sum_plain(xs, OUT).float()).abs().max()
            d9 = (resize.resize_sum_conv_relu_phase(xs, OUT, k, b).float()
                  - resize.resize_sum_conv_relu_lowres(xs, OUT, k, b).float()).abs().max()
        out[name] = {"k4_max_abs": float(d4), "k9_max_abs": float(d9)}
    return {"max_abs_vs_plain": out}


def sweep() -> dict:
    out = {}
    for name, dt in DTYPES.items():
        xs, k, b = args_for(dt)
        p4 = resize.resize_plan(2, *OUT, 768, MAPS, dt)
        p9 = resize.phase_plan(2, *OUT, MAPS, 96, dt)
        kf = resize._head_matrix(k, dt)
        us = [torch.matmul(x.reshape(-1, 768), kf).reshape(2, x.shape[1], x.shape[2], 864)
              for x in xs]
        res4, res9 = {}, {}
        for bh in resize.SEP_BANDS:
            for cc in (32, 64, 128):
                run = k4_launcher(xs, bh, cc, OUT[1])
                if run is not None:
                    res4[f"bh{bh}_cc{cc}"] = chip_smoke.device_ms([run])[0]
            for cc in (8, 16, 32, 48):
                run = k9_launcher(us, b, 96, bh, cc, OUT[1])
                if run is not None:
                    res9[f"bh{bh}_cc{cc}"] = chip_smoke.device_ms([run, run])[0]
        with torch.no_grad():
            k9_full = chip_smoke.device_ms(
                [lambda: resize.resize_sum_conv_relu_phase(xs, OUT, k, b)] * 2)[0]
            products = chip_smoke.device_ms(
                [lambda: [torch.matmul(x.reshape(-1, 768), kf) for x in xs]] * 2)[0]
        out[name] = {
            "k4_plan": [p4.bh, p4.cc, p4.tw, p4.ctas], "k4_ms_per_call": res4,
            "k9_plan": [p9.bh, p9.cc, p9.tw, p9.ctas], "k9_gather_ms_per_two_calls": res9,
            "k9_with_products_ms_per_two_calls": k9_full,
            "k9_products_alone_ms_per_two_calls": products,
        }
    return {"sweep": out}


# edits of csrc/separable.cuh: (text, replacement), each text found once
PHASES_OFF = {
    "column_pass_off": ("for (int it = tid; it < pairs * strips * Gc; it += THREADS) {",
                        "for (int it = tid; it < 0 * pairs * strips * Gc; it += THREADS) {"),
    "row_pass_off": ("const int items = first[n];", "const int items = 0 * first[n];"),
}


def build_variants(variants: dict) -> dict:
    """K4's and K9's kernels built from copies of csrc/ whose separable.cuh
    carries each variant's edits, all nvcc runs started together; returns
    {(variant, kernel name): Kernel}."""
    src = (K.CSRC_DIR / "separable.cuh").read_text()
    csrc0, kerns, started = K.CSRC_DIR, {}, []
    try:
        for name, edits in variants.items():
            d = K.BUILD_DIR / "variants" / name
            d.mkdir(parents=True, exist_ok=True)
            text = src
            for old, new in edits:
                assert text.count(old) == 1, (name, old)
                text = text.replace(old, new)
            (d / "separable.cuh").write_text(text)
            for f in ("resize.cu", "resize_phase.cu"):
                shutil.copy(csrc0 / f, d / f)
            K.CSRC_DIR = d
            for base in (resize.KERNEL, resize.PHASE_KERNEL):
                k = K.Kernel(f"{base.name}_{name}", base.source, base.entry, base.argtypes, "")
                started.append((k, d, *k.start_build()))
                kerns[name, base.name] = k
        for k, d, proc, lib in started:
            K.CSRC_DIR = d
            k.finish_build(proc, lib)
            k.fn()
            if "Used" in k.build_log:
                used = sorted({ln.split("Used")[1].split(",")[0].strip()
                               for ln in k.build_log.splitlines() if "Used" in ln})
                print(f"[variant {k.name}] registers {used}", flush=True)
    finally:
        K.CSRC_DIR = csrc0
    return kerns


# variants of csrc/separable.cuh: the column pass unrolled over the inputs
# (their windows' loads interleaved), one row-pass item in flight per thread
# in place of two, strips of two output columns in place of four
VARIANTS = {
    "base": (),
    "unroll_inputs": (("      for (int i = 0; i < n; ++i) {\n"
                       "        const int end = off[i] + span[i];",
                       "#pragma unroll\n      for (int i = 0; i < MAX_INPUTS; ++i) {\n"
                       "        if (i >= n) break;\n        const int end = off[i] + span[i];"),),
    "one_item": (("constexpr int IPT = NS == 1 ? 2 : 1;", "constexpr int IPT = 1;"),),
    "strip_2": (("constexpr int STRIP = 4;", "constexpr int STRIP = 2;"),),
}


def variants() -> dict:
    """K4's and K9's gather (bf16) built as each variant, at the decoder
    plans' geometry; each against the kernel's own output (the same bits
    expected)."""
    kerns = build_variants(VARIANTS)
    xs, k, b = args_for(torch.bfloat16)
    kf = resize._head_matrix(k, torch.bfloat16)
    us = [torch.matmul(x.reshape(-1, 768), kf).reshape(2, x.shape[1], x.shape[2], 864) for x in xs]
    p4 = resize.resize_plan(2, *OUT, 768, MAPS, torch.bfloat16)
    p9 = resize.phase_plan(2, *OUT, MAPS, 96, torch.bfloat16)
    out = {}
    for name in VARIANTS:
        run4 = k4_launcher(xs, p4.bh, p4.cc, p4.tw, kerns[name, resize.KERNEL.name])
        run9 = k9_launcher(us, b, 96, p9.bh, p9.cc, p9.tw, kerns[name, resize.PHASE_KERNEL.name])
        ref4 = k4_launcher(xs, p4.bh, p4.cc, p4.tw)()
        ref9 = k9_launcher(us, b, 96, p9.bh, p9.cc, p9.tw)()
        ref4, ref9 = ref4.clone(), ref9.clone()
        same = bool(torch.equal(run4(), ref4)) and bool(torch.equal(run9(), ref9))
        out[name] = {"k4_ms_per_call": chip_smoke.device_ms([run4])[0],
                     "k9_gather_ms_per_call": chip_smoke.device_ms([run9])[0], "same_bits": same}
    return {"variants_bf16": out}


def phases() -> dict:
    """K4's and K9's gather at the plan's geometry (bf16) built with a pass
    switched off, beside the whole kernel."""
    edits = {name: (edit,) for name, edit in PHASES_OFF.items()}
    edits["setup_only"] = tuple(PHASES_OFF.values())
    kerns = build_variants(edits)
    xs, k, b = args_for(torch.bfloat16)
    p4 = resize.resize_plan(2, *OUT, 768, MAPS, torch.bfloat16)
    p9 = resize.phase_plan(2, *OUT, MAPS, 96, torch.bfloat16)
    kf = resize._head_matrix(k, torch.bfloat16)
    us = [torch.matmul(x.reshape(-1, 768), kf).reshape(2, x.shape[1], x.shape[2], 864) for x in xs]
    out = {"k4_ms_per_call": {"whole": chip_smoke.device_ms(
               [k4_launcher(xs, p4.bh, p4.cc, p4.tw)])[0]},
           "k9_gather_ms_per_call": {"whole": chip_smoke.device_ms(
               [k9_launcher(us, b, 96, p9.bh, p9.cc, p9.tw)])[0]}}
    for name in edits:
        run4 = k4_launcher(xs, p4.bh, p4.cc, p4.tw, kerns[name, resize.KERNEL.name])
        run9 = k9_launcher(us, b, 96, p9.bh, p9.cc, p9.tw, kerns[name, resize.PHASE_KERNEL.name])
        out["k4_ms_per_call"][name] = chip_smoke.device_ms([run4])[0]
        out["k9_gather_ms_per_call"][name] = chip_smoke.device_ms([run9])[0]
    return {"phases_bf16": out}


class _Parent(K.Kernel):
    """A kernel of another tree's csrc directory."""

    def __init__(self, root: Path, *args):
        super().__init__(*args)
        self.root = root

    @property
    def source_path(self) -> Path:
        return self.root / self.source

    def library_path(self) -> Path:
        # the root's own headers, not this tree's, and a name of its own
        digest = hashlib.sha256(self.source_path.read_bytes())
        for header in sorted(self.root.glob("*.cuh")):
            digest.update(header.read_bytes())
        return K.BUILD_DIR / f"{self.name}-{digest.hexdigest()[:16]}.so"


def baseline(root: Path) -> dict:
    """Another version of this tree's K4 and K9 (the same entries, from the
    csrc directory `root`) against this one at the decoder plans' geometry,
    in turns: baseline, this, this, baseline."""
    k4 = _Parent(root, "baseline_resize_sum", "resize.cu", "dsal_resize_sum",
                 resize.KERNEL.argtypes, "")
    k9 = _Parent(root, "baseline_phase_head", "resize_phase.cu", "dsal_resize_phase_head",
                 resize.PHASE_KERNEL.argtypes, "")
    out = {}
    for name, dt in DTYPES.items():
        xs, k, b = args_for(dt)
        p4 = resize.resize_plan(2, *OUT, 768, MAPS, dt)
        p9 = resize.phase_plan(2, *OUT, MAPS, 96, dt)
        kf = resize._head_matrix(k, dt)
        us = [torch.matmul(x.reshape(-1, 768), kf).reshape(2, x.shape[1], x.shape[2], 864)
              for x in xs]
        runs = {"baseline": (k4_launcher(xs, p4.bh, p4.cc, p4.tw, k4),
                             k9_launcher(us, b, 96, p9.bh, p9.cc, p9.tw, k9)),
                "this": (k4_launcher(xs, p4.bh, p4.cc, p4.tw),
                         k9_launcher(us, b, 96, p9.bh, p9.cc, p9.tw))}
        same = all(bool(torch.equal(runs["baseline"][j]().clone(), runs["this"][j]()))
                   for j in range(2))
        res = {"k4_ms_per_call": {}, "k9_gather_ms_per_call": {}, "same_bits": same}
        for turn in ("baseline", "this", "this", "baseline"):
            r4, r9 = runs[turn]
            res["k4_ms_per_call"].setdefault(turn, []).append(chip_smoke.device_ms([r4])[0])
            res["k9_gather_ms_per_call"].setdefault(turn, []).append(chip_smoke.device_ms([r9])[0])
        out[name] = res
    return {"baseline": out}


def parent(root: Path) -> dict:
    """The earlier tree's K4 (one thread per output pixel and 8 channels)
    and K9 (a gather per output pixel), on the same inputs."""
    k4 = _Parent(root, "parent_resize_sum", "resize.cu", "dsal_resize_sum",
                 [K.P] * 7 + [K.I] * 14 + [K.P], "")
    k9 = _Parent(root, "parent_phase_head", "resize_phase.cu", "dsal_resize_phase_head",
                 [K.P] * 8 + [K.I] * 14 + [K.P], "")
    out = {}
    for name, dt in DTYPES.items():
        xs, k, b = args_for(dt)
        H, W = OUT
        shapes = tuple((x.shape[1], x.shape[2]) for x in xs)
        hs, ws = _pad([s[0] for s in shapes], 0), _pad([s[1] for s in shapes], 0)
        bf = int(dt == torch.bfloat16)
        idx, wts = resize._tap_tables(shapes, OUT, xs[0].device)
        o4 = torch.empty((2, H, W, 768), dtype=dt, device="cuda")

        def run4():
            k4.launch(*_pad([x.data_ptr() for x in xs], None), idx.data_ptr(), wts.data_ptr(),
                      o4.data_ptr(), *hs, *ws, 4, 2, H, W, 768, bf, K.stream())
        kf = resize._head_matrix(k, dt)
        pidx, pwts = resize._phase_tables(shapes, OUT, dt, xs[0].device)
        o9 = torch.empty((2, H, W, 96), dtype=dt, device="cuda")

        def run9():
            us = [torch.matmul(x.reshape(-1, 768), kf) for x in xs]
            k9.launch(*_pad([u.data_ptr() for u in us], None), pidx.data_ptr(), pwts.data_ptr(),
                      b.data_ptr(), o9.data_ptr(), *hs, *ws, 4, 2, H, W, 96, bf, K.stream())
        run4()
        run9()
        with torch.no_grad():
            d4 = (o4.float() - resize.bilinear_resize_sum(xs, OUT).float()).abs().max()
            d9 = (o9.float() - resize.resize_sum_conv_relu_phase(xs, OUT, k, b).float()).abs().max()
        out[name] = {"k4_ms_per_call": chip_smoke.device_ms([run4])[0],
                     "k9_with_products_ms_per_two_calls": chip_smoke.device_ms([run9, run9])[0],
                     "max_abs_parent_vs_change": [float(d4), float(d9)]}
    return {"parent": out}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="csrc directory of an earlier tree to time beside this one")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="csrc directory of another version of these entries to time beside "
                         "this one")
    cli = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.nvidia_smi_line(), flush=True)
    resize.KERNEL.fn()
    resize.PHASE_KERNEL.fn()
    for kern in (resize.KERNEL, resize.PHASE_KERNEL):
        for line in kern.build_log.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"[ptxas {kern.source}] {line.strip()}", flush=True)
    parts = [check]
    if cli.baseline:
        parts.append(lambda: baseline(cli.baseline))
    parts += [variants, sweep, phases]
    if cli.parent:
        parts.append(lambda: parent(cli.parent))
    for part in parts:
        print(json.dumps(part()), flush=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
