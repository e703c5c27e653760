"""The share of the device's time in the traced slice that went to the
port's kernel wrappers; the rest is libraries (cuBLAS, cuDNN) and glue
(copies, elementwise kernels). Summed device time on both sides."""

UNIT = "%"


def read(ctx):
    sl = ctx.slice
    if ctx.kind != "train" or sl is None or sl.device_total_s <= 0:
        return None
    calls = sl.kernel_calls()
    if not calls:
        return None
    return 100.0 * sum(s for _, s, _ in calls) / sl.device_total_s
