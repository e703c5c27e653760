"""The device memory allocated at the peak of the window
(`torch.cuda.max_memory_allocated` after a reset at its start), GiB."""

UNIT = "GiB"


def read(ctx):
    if ctx.kind != "infer" or not ctx.window_peak_bytes:
        return None
    return ctx.window_peak_bytes / 2 ** 30
