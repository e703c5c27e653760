"""Traffic kind `infer`: a closed loop of one client on one chip. Each
batch goes through the port's `sample_saliency` and its maps are copied
to the host before the next batch goes out. A batch's latency runs from
the entry call to its maps on the host; its dispatch time from the entry
call to the call's return. The loop rotates over the cell's seeded
batches, held on the card."""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from portbench.core import check, data, flops, port, session, trace

CHIPS = (1,)


def run(cfg, traffic, seed, seconds, traced, t_start):
    model, weights, batches = session.setup(cfg, traffic, seed, train=False)
    del weights
    hooks = port.Hooks(model)
    call = port.sampler(model, traffic["sampler"])
    for _ in range(2):  # every shape of the cell, twice
        for b in batches:
            call(b).to("cpu")
    session.sync()
    setup_peak = session.peak()
    session.reset_peak()
    hooks.counts = {k: 0 for k in hooks.counts}
    keep = data.kept_iterations(seed)
    kept, last = {}, []
    lat, disp = [], []
    n = len(batches)
    setup_s = time.perf_counter() - t_start
    host0 = session.host_reading()
    w0 = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        out = call(batches[i % n])
        t1 = time.perf_counter()
        maps = out.to("cpu")
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        disp.append(t1 - t0)
        if i in keep:
            kept[i] = maps
        last = (last + [(i, maps)])[-n:]
        i += 1
        if t2 - w0 >= seconds:
            break
    window_s = t2 - w0
    host = session.host_notes(host0, session.host_reading())
    window_peak = session.peak()
    calls = dict(hooks.counts)
    kept.update(dict(last))
    B = traffic["batch"]
    e2e = {"infer_clips_per_s": i * B / window_s, "infer_p95_ms": session.p95(lat) * 1e3,
           "setup_s": setup_s}
    ctx = SimpleNamespace(kind="infer", items=i, batch=B, window_s=window_s,
                          dispatch_s=disp, latency_s=lat, model_calls=calls,
                          window_peak_bytes=window_peak, flops_per_item=None, slice=None)
    if traced:
        ctx.flops_per_item = flops.count(cfg["model"], traffic)
        k = traffic["trace_batches"]

        def run_slice():
            for j in range(k):
                call(batches[j % n]).to("cpu")
        ctx.slice = trace.profile(run_slice, k, hooks)
    hooks.remove()
    del model, call, hooks, out
    gc.collect()
    torch.cuda.empty_cache()
    refs = check.reference_maps(cfg["model"], traffic, seed, session.DEVICE, batches)
    numbers = check.map_numbers(kept, refs)
    return {"e2e": e2e, "ctx": ctx, "numbers": numbers,
            "peak": max(setup_peak, window_peak),
            "extra": {"compared_batches": len(kept), "host": host}}
