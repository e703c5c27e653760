"""The share of the measured window in which the device ran nothing: one
minus the device's busy time per batch over the window's time per
batch. The busy time is the union of the device events' intervals
in the traced slice's device pass (profiled with the device's activity
alone), per batch; the time per batch is the untraced window's. So
the profiler's host cost, which stretches the slice where the host
paces the loop, does not read as idle time (the driver's busy_s /
window_s, of the slice itself, does)."""

UNIT = "%"


def read(ctx):
    sl = ctx.slice
    if ctx.kind != "infer" or sl is None or sl.busy_s <= 0 or not ctx.items:
        return None
    return 100.0 * (1.0 - (sl.busy_s / sl.items) / (ctx.window_s / ctx.items))
