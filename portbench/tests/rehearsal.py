"""A run of a cell on the CPU at a tiny size: the harness's whole path
(set-up, window, reference, result line) with the card's calls stubbed,
the kernels' plain versions in their place, MViT cut to 7 blocks and the
clips to 64x96 (128x96 with audio: VGGish's grid has to meet the
decoder's coarsest), two clips a batch.

    python portbench/tests/rehearsal.py av_ddim_b30 [--dtype bfloat16] [--trace]
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import sys
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from portbench import run as run_mod  # noqa: E402
from portbench.core import port, session, spec  # noqa: E402

CUDA_STUBS = {"synchronize": lambda *a, **k: None, "reset_peak_memory_stats": lambda *a, **k: None,
              "empty_cache": lambda *a, **k: None, "_sleep": lambda *a, **k: None,
              "get_device_name": lambda *a, **k: "cpu rehearsal"}


def tiny(cfg: dict, dtype: str) -> dict:
    cfg = copy.deepcopy(cfg)
    m = cfg["model"]
    hw = [128, 96] if m.get("audio") else [64, 96]
    m["visual"].update(num_layers=7, downscale_indices=[1, 3, 5], spatial_size=hw)
    m["decoder"]["img_size"] = hw
    m["compute_dtype"] = dtype
    return cfg


@contextlib.contextmanager
def on_cpu():
    """The harness on the CPU: no kernel build, no card calls, a profiler
    of the host alone."""
    saved = {k: getattr(torch.cuda, k) for k in CUDA_STUBS}
    saved_build, saved_dev = port.build_kernels, session.DEVICE
    saved_profile = torch.profiler.profile
    cpu_only = torch.profiler.ProfilerActivity.CPU
    try:
        for k, v in CUDA_STUBS.items():
            setattr(torch.cuda, k, v)
        port.build_kernels = lambda: {}
        session.DEVICE = "cpu"
        torch.profiler.profile = lambda activities=None, **kw: saved_profile(
            activities=[cpu_only], **kw)
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.cuda, k, v)
        port.build_kernels, session.DEVICE = saved_build, saved_dev
        torch.profiler.profile = saved_profile


def pair(config: str, traffic: str, limits: dict) -> dict:
    """A cell that BENCHMARK.json does not hold: a configuration and a
    traffic mix of their files, judged by the limits given."""
    return {"name": f"{config}.{traffic}", "config": config, "traffic": traffic, "chips": 1,
            "limits": limits}


def run_cell(cell_name, dtype: str = "float32", trace_on: bool = False,
             seconds: float = 2.0, seed: int = 2 ** 31 + 12345) -> dict:
    """The cell's result line (parsed) from a tiny run on the CPU; the cell
    is a name in BENCHMARK.json or a `pair`."""
    cell = spec.workload(cell_name) if isinstance(cell_name, str) else cell_name
    cfg = tiny(spec.config(cell["config"]), dtype)
    traffic = dict(spec.traffic(cell["traffic"]), batch=2)
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=int(trace_on))
    buf = io.StringIO()
    with on_cpu(), contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        rc = run_mod.report(cell, cfg, traffic, args, time.perf_counter())
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("workload")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--trace", action="store_true")
    a = ap.parse_args()
    torch.set_num_threads(4)
    print(json.dumps(run_cell(a.workload, a.dtype, a.trace)))
