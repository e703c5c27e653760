"""Per-call time of the LayerNorm (K2 forward, K6 backward) and block-tail
(K3) wrappers at one small shape each, by CUDA events around back-to-back
calls. At these shapes a call's device time is a few microseconds, so the
number is mostly the wrapper's host time: its checks, allocations and the
launch.

    PYTHONPATH=<checkout root> python3 diff_sal_tpu_torch/wrapper_time.py

times the wrappers of the checkout that PYTHONPATH names (the script
reaches them only through their public names), so two versions can be
compared on one card in one session. Prints one JSON
line: the module files, the card, and the median over `--repeats` of
each wrapper's ms per call.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch


def per_call_ms(fn, calls: int, repeats: int) -> float:
    """Median over `repeats` of the event time of `calls` back-to-back
    calls, divided by `calls`."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=7)
    cli = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("wrapper_time: needs a CUDA card")
    from diff_sal_tpu_torch.ops import layernorm, mlp

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    C = 768
    x, dy = randn(2, C), randn(2, C)       # an MViT cls row at stage 3, B = 2
    w, b = randn(C, dtype=torch.float32), randn(C, dtype=torch.float32)
    R, Hd = 840, 2 * C                     # decoder stage 0's rows, B = 2
    tail = (randn(R, C), randn(R, C), w, b, randn(Hd, C) * 0.03, randn(Hd, dtype=torch.float32),
            randn(C, Hd) * 0.03, b)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    with torch.no_grad():
        result = {
            "layernorm_module": layernorm.__file__,
            "mlp_module": mlp.__file__,
            "card": smi.strip().splitlines()[0] if smi.strip() else torch.cuda.get_device_name(0),
            "calls": cli.calls,
            "repeats": cli.repeats,
            "layer_norm_fwd (2, 768) ms": per_call_ms(
                lambda: layernorm.layer_norm_fwd(x, w, b), cli.calls, cli.repeats),
            "layer_norm_bwd (2, 768) ms": per_call_ms(
                lambda: layernorm.layer_norm_bwd(x, dy, w), cli.calls, cli.repeats),
            "block_tail (840, 768) ms": per_call_ms(
                lambda: mlp.block_tail(*tail), cli.calls, cli.repeats),
        }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
