"""The traced slice: a few batches or steps after the window, profiled
twice, reduced to what the per-layer readers take.

1. The device alone (`ProfilerActivity.CUDA`, little host overhead): the
   slice lies between two marker kernels (`torch.cuda._sleep` spins),
   each waited for; its length, the device's busy time in it (the union
   of the device events' intervals, so that kernels on two streams count
   once) and the top device operations.
2. Host and device, with the benchmark's ranges on (`pb.<method>` around
   the model's entry points, `pb.k.<kernel>#<i>` around each kernel
   wrapper call): the device time charged to each range, and the longest
   idle gaps named by what the host was doing. Each range appears on the
   device's timeline too (the profiler's user annotations, spanning the
   device work its host code launched); a device operation is charged to
   every span that holds it. A range with no span is charged, through
   the launch's correlation id, the device operations its thread
   launched inside it.

On the card the tracer now and then loses the first device events of a
session, so each pass starts with a prologue for it to lose: ~1 ms of
spinning and eight short spins, waited for (after
`chip_smoke.py:device_events`)."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

PROLOGUE_SPINS = 8
MARK = "spin"


def busy_s(intervals) -> float:
    """Seconds in which at least one interval (start, end in us) runs."""
    busy, stop = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > stop:
            busy += b - max(a, stop)
            stop = b
    return busy / 1e6


def gaps(intervals, start: float, end: float):
    """The idle gaps (start, end in us) between the union of intervals,
    inside [start, end]."""
    out, stop = [], start
    for a, b in sorted(intervals):
        if a > stop:
            out.append((stop, min(a, end)))
        stop = max(stop, b)
    if stop < end:
        out.append((stop, end))
    return [(a, b) for a, b in out if b > a]


def _device(events):
    from torch.autograd import DeviceType

    return sorted((e for e in events if e.device_type == DeviceType.CUDA
                   and e.time_range.start >= 0), key=lambda e: e.time_range.start)


class Slice:
    """What the profiled slice holds, in a form the readers take."""

    def __init__(self, device_events, host_events, items: int, bounds: List[float]):
        self.items, self.bounds = items, bounds
        self._device_pass(device_events)
        self._host_pass(host_events)

    def _device_pass(self, events):
        dev = _device(events)
        marks = [e for e in dev if MARK in e.name]
        work = [e for e in dev if MARK not in e.name]
        first = work[0].time_range.start if work else 0.0
        before = [m.time_range.end for m in marks if m.time_range.end <= first]
        after = [m.time_range.start for m in marks if m.time_range.start >= first]
        # without its markers (none traced on the CPU) the slice is its work's span
        self.start = max(before) if before else first
        self.end = (after[-1] if after else
                    max((e.time_range.end for e in work), default=first))
        inside = [e for e in work if self.start <= e.time_range.start < self.end]
        ivals = [(e.time_range.start, e.time_range.end) for e in inside]
        self.window_s = (self.end - self.start) / 1e6
        self.busy_s = busy_s(ivals)
        self.device_total_s = sum(b - a for a, b in ivals) / 1e6
        ops = defaultdict(float)
        for e in inside:
            ops[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        self.top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]

    def _host_pass(self, events):
        from torch.autograd import DeviceType

        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        sl = [e for e in cpu if e.name == "pb.slice"]
        if not sl:
            raise RuntimeError("the traced slice's range is missing from the profile")
        start, end = sl[0].time_range.start, sl[0].time_range.end
        dev = [e for e in _device(events) if start <= e.time_range.start <= end]
        spans = [e for e in dev if e.name.startswith("pb.")]
        dev = [e for e in dev if not e.name.startswith("pb.")]
        ivals = [(e.time_range.start, e.time_range.end) for e in dev]
        starts = [a for a, _ in ivals]
        # device seconds per range name (`pb.k.<kernel>#<i>` per call)
        self.range_s: Dict[str, float] = defaultdict(float)
        for sp in spans:
            a, b = sp.time_range.start, sp.time_range.end
            for j in range(bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)):
                if ivals[j][1] <= b:
                    self.range_s[sp.name] += (ivals[j][1] - ivals[j][0]) / 1e6
        spanned = {sp.name for sp in spans}
        unspanned = defaultdict(list)
        for e in cpu:
            if e.name.startswith("pb.") and e.name not in spanned:
                unspanned[e.thread].append(e)
        if unspanned:
            launches = {e.id: e for e in cpu if e.name.startswith("cu")}
            for d in dev:
                launch = launches.get(d.id)
                if launch is None:
                    continue
                for r in unspanned.get(launch.thread, ()):
                    if r.time_range.start <= launch.time_range.start <= r.time_range.end:
                        self.range_s[r.name] += (d.time_range.end - d.time_range.start) / 1e6
        main = [e for e in cpu if e.thread == sl[0].thread and e.name != "pb.slice"]
        idle = defaultdict(float)
        longest = sorted(gaps(ivals, start, end), key=lambda g: g[0] - g[1])[:50]
        for a, b in longest:
            inner = [e for e in main if e.time_range.start <= a < e.time_range.end]
            name = (min(inner, key=lambda e: e.time_range.end - e.time_range.start).name
                    if inner else "host outside any operation")
            idle[name] += (b - a) / 1e6
        self.top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]

    def seconds(self, prefix: str) -> float:
        """Device seconds of the ranges whose name starts with `prefix`."""
        return sum(v for k, v in self.range_s.items() if k.startswith(prefix))

    def kernel_calls(self):
        """[(kernel, device seconds, bound seconds)] of each traced wrapper
        call."""
        out = []
        for name, s in self.range_s.items():
            if name.startswith("pb.k."):
                kernel, i = name[len("pb.k."):].split("#")
                out.append((kernel, s, self.bounds[int(i)]))
        return out


def _prologue():
    time.sleep(0.2)
    torch.cuda._sleep(2_000_000)
    for _ in range(PROLOGUE_SPINS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def profile(run: Callable[[], None], items: int, hooks) -> Slice:
    """Profile `run` (the slice's batches or steps) in the two passes."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    with prof_ctx(activities=[ProfilerActivity.CUDA]) as device_pass:
        _prologue()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    hooks.bounds.clear()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as host_pass:
        _prologue()
        hooks.trace = True
        with torch.profiler.record_function("pb.slice"):
            run()
            torch.cuda.synchronize()
        hooks.trace = False
    return Slice(device_pass.events(), host_pass.events(), items, list(hooks.bounds))
