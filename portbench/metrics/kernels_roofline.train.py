"""The port's hand-written kernels' share of their roofline: the sum of
each traced wrapper call's bound (`core/roofline.py`: the larger of its
bytes at 3.35 TB/s and its operations at their peak) over the sum of the
device time charged to those calls in the traced slice."""

UNIT = "%"


def read(ctx):
    sl = ctx.slice
    if ctx.kind != "train" or sl is None:
        return None
    calls = sl.kernel_calls()
    device = sum(s for _, s, _ in calls)
    if not calls or device <= 0:
        return None
    return 100.0 * sum(b for _, _, b in calls) / device
