"""What the traffic kinds (`kinds/<kind>.py`) share: the device, the
set-up of a cell's model, weights and batches, the checked first
training steps, the peak of device memory, and readings of the host
around the window.

A kind's module defines `CHIPS`, the chip counts it launches, and
`run(cfg, traffic, seed, seconds, traced, t_start)`, which returns
{"e2e": {name: value}, "ctx": what the readers take, "numbers": the
compared numbers, "peak": bytes, "extra": notes}."""

from __future__ import annotations

import os
import resource
from typing import Dict

import numpy as np
import torch

from portbench.core import data, port

DEVICE = "cuda"


def p95(values) -> float:
    return float(np.percentile(np.asarray(values), 95))


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def peak() -> int:
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0


def reset_peak():
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def setup(cfg, traffic, seed, train):
    model_cfg = cfg["model"]
    port.build_kernels()
    weights = data.draw_weights(model_cfg, seed, DEVICE)
    model = port.build_model(model_cfg, weights, DEVICE, train)
    batches = data.draw_batches(model_cfg, traffic, seed, DEVICE)
    return model, weights, batches


def _cpu_mhz():
    """The mean clock of the host's cores as the kernel reports it, or None."""
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
    except OSError:
        return None
    return sum(mhz) / len(mhz) if mhz else None


def host_reading() -> Dict:
    """What the host was like: its cores' clock, its load, and this
    process's context switches so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_mhz": _cpu_mhz(), "load1": os.getloadavg()[0],
            "cores": len(os.sched_getaffinity(0)), "nivcsw": ru.ru_nivcsw, "nvcsw": ru.ru_nvcsw}


def host_notes(before: Dict, after: Dict) -> Dict:
    """The host over the window: clock before and after, load after, and
    the process's involuntary and voluntary context switches in it."""
    return {"cpu_mhz": [before["cpu_mhz"], after["cpu_mhz"]], "load1": after["load1"],
            "cores": after["cores"], "nivcsw": after["nivcsw"] - before["nivcsw"],
            "nvcsw": after["nvcsw"] - before["nvcsw"]}


def checked_steps(model, step, opt, names, w0, batches, gen, k):
    """The first k steps through the window's own call: (each step's loss,
    the first step's gradient as the optimizer got it, before its clip,
    worked out from Adam's first moment and the returned global norm; the
    parameters' change after the k steps), on the host, by name."""
    losses, g1 = [], None
    for i in range(k):
        metrics = step(batches[i % len(batches)], gen)
        losses.append(metrics["total"])
        if i == 0:
            clip = opt.cfg.grad_clip
            scale = max(1.0, float(metrics["grad_norm"]) / clip) if clip else 1.0
            g1 = {nm: (m * (scale / (1.0 - opt.cfg.beta1))).cpu() for nm, m in zip(names, opt.mu)}
    params = dict(model.named_parameters())
    change = {nm: params[nm].detach().cpu() - w0[nm] for nm in names}
    return [float(x) for x in losses], g1, change
