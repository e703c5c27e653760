"""The whole window's model operations over its time, as a share of one
H100's dense bf16 peak (989 TFLOP/s, NVIDIA's SXM data sheet; the card's
power limit is printed beside every result). The operations are the
benchmark's own count of its reference model (`core/flops.py`), the same
work whatever the port runs. Read from the traced run's window."""

PEAK_FLOPS = 989e12
UNIT = "%"


def read(ctx):
    if ctx.kind != "train" or not ctx.flops_per_item:
        return None
    return 100.0 * ctx.flops_per_item * ctx.items / ctx.window_s / PEAK_FLOPS
