#!/usr/bin/env python3
"""Benchmark of `diff_sal_tpu_torch` (DiffSal's PyTorch / CUDA port) on
NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cell (`BENCHMARK.json`'s
`workloads`, `portbench/workloads/<name>.json`) names a configuration
(`configs/`) and a traffic mix (`traffic/`), whose kind's loop is
`kinds/<kind>.py`. The run builds the port's
model on the card with weights drawn from the seed, warms up the cell's
shapes, measures for `--seconds`, and then compares what the window
produced with the plain float32 reference of `portbench/reference/`.
With `--trace 1` it reports the cell's per-layer metrics (`metrics/`)
instead of its end-to-end ones, from the same window and a profiled
slice after it.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device[, breakdown], and last `checks`, each compared
number with its limit; the last lines of standard error repeat the
checks. Without a card, with fewer cards than the cell asks for, with a
chip count that its traffic kind does not launch, or with JAX loaded by
the time the window closes, it prints no result and exits with 1."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# a library that loads JAX on its own (transformers) is kept from it
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "diff_sal_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: `diff_sal_tpu_torch` is not `diff_sal_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.core import spec

    cell = spec.workload(args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    chips = spec.kind(traffic["kind"]).CHIPS
    if cell["chips"] not in chips:
        print(f"portbench: the cell asks for {cell['chips']} chip(s); traffic kind "
              f"{traffic['kind']!r} launches {chips}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    return report(cell, cfg, traffic, args, T_START)


def report(cell, cfg, traffic, args, t_start) -> int:
    """Run the cell and print its result; 1 with no result if JAX came in."""
    import torch

    from portbench.core import spec

    out = spec.kind(traffic["kind"]).run(cfg, traffic, args.seed, args.seconds,
                                         bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 1
    if args.trace:
        metrics = {}
        for m in spec.per_layer(cell["name"]):
            value = spec.reader(m["name"]).read(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in spec.end_to_end(cell["name"])}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in out["e2e"].items() if k in units}
    from portbench.core import check

    limits = cell["limits"]
    correct = check.verdict(out["numbers"], limits)
    checks = {k: {"value": out["numbers"][k], "limit": lim} for k, lim in limits.items()}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0) if
              torch.cuda.is_available() else "none", "count": cell["chips"],
              "memory_peak_bytes": int(out["peak"])}
    result = {"correct": correct, "attempted": out["ctx"].items, "failed": 0 if correct else
              out["ctx"].items, "metrics": metrics, "device": device}
    sl = out["ctx"].slice
    if sl is not None:
        device.update(busy_s=sl.busy_s, window_s=sl.window_s)
        result["breakdown"] = {"device_ops": [[k, v] for k, v in sl.top_ops],
                               "idle_gaps": [[k, v] for k, v in sl.top_gaps]}
    result["card"] = card_line()
    result["notes"] = dict(out["extra"], readings={k: v for k, v in out["numbers"].items()
                                                   if k not in limits})
    result["checks"] = checks
    print(json.dumps(result))
    sys.stdout.flush()
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
