"""Traffic kind `train`: one rank's training steps on one chip, back to
back through the step that `make_train_step` returns, with no all-reduce.
Set-up drives the first `checked_steps` of them (the ones the reference
follows); the window runs on from there and ends in
`torch.cuda.synchronize()`. The steps rotate over the cell's seeded
batches, held on the card."""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from portbench.core import check, flops, port, session, spec, trace

CHIPS = (1,)


def run(cfg, traffic, seed, seconds, traced, t_start):
    model, weights, batches = session.setup(cfg, traffic, seed, train=True)
    names = port.trainable_names(model)
    w0 = {n: weights[n].cpu() for n in names}
    del weights
    hooks = port.Hooks(model)
    step, opt = port.trainer(model, cfg["model"], traffic["optim"])
    gen = torch.Generator(device=session.DEVICE).manual_seed(spec.subseed(seed, "steps"))
    n = len(batches)
    losses, g1, change = session.checked_steps(model, step, opt, names, w0, batches, gen,
                                               traffic["checked_steps"])
    del w0
    session.sync()
    setup_peak = session.peak()
    session.reset_peak()
    hooks.counts = {k: 0 for k in hooks.counts}
    done = traffic["checked_steps"]
    disp = []
    setup_s = time.perf_counter() - t_start
    host0 = session.host_reading()
    t0 = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        step(batches[(done + i) % n], gen)
        disp.append(time.perf_counter() - a)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    session.sync()
    window_s = time.perf_counter() - t0
    host = session.host_notes(host0, session.host_reading())
    window_peak = session.peak()
    e2e = {"train_step_ms": window_s / i * 1e3, "setup_s": setup_s}
    ctx = SimpleNamespace(kind="train", items=i, batch=traffic["batch"], window_s=window_s,
                          dispatch_s=disp, latency_s=None, model_calls=dict(hooks.counts),
                          window_peak_bytes=window_peak, flops_per_item=None, slice=None)
    if traced:
        ctx.flops_per_item = flops.count(cfg["model"], traffic)
        k = traffic["trace_steps"]

        def run_slice():
            for j in range(k):
                step(batches[j % n], gen)
        ctx.slice = trace.profile(run_slice, k, hooks)
    hooks.remove()
    del model, opt, step, hooks
    gc.collect()
    torch.cuda.empty_cache()
    ref_losses, ref_g1, ref_change = check.reference_steps(cfg["model"], traffic, seed,
                                                           session.DEVICE, batches)
    numbers, notes = check.step_numbers(losses, g1, change, ref_losses,
                                        {k: v.cpu() for k, v in ref_g1.items()},
                                        {k: v.cpu() for k, v in ref_change.items()})
    notes.update(losses=losses, ref_losses=ref_losses, host=host)
    return {"e2e": e2e, "ctx": ctx, "numbers": numbers,
            "peak": max(setup_peak, window_peak), "extra": notes}
