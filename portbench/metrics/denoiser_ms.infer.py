"""Device ms per call of the model's `denoise` (the SalUNet) in the
traced slice."""

UNIT = "ms"


def read(ctx):
    sl = ctx.slice
    if ctx.kind != "infer" or sl is None:
        return None
    s = sl.seconds("pb.denoise")
    calls = ctx.model_calls["denoise"] / ctx.items * sl.items
    return 1e3 * s / calls if s > 0 and calls else None
