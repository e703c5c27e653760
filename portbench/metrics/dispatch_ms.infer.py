"""The host's time from the entry call to its return, before anything
waits for the device: what eager launches cost per batch or step. The
median over the traced run's window."""

import statistics

UNIT = "ms"


def read(ctx):
    if ctx.kind != "infer" or not ctx.dispatch_s:
        return None
    return 1e3 * statistics.median(ctx.dispatch_s)
