"""Device ms per step charged to the model's forward inside the training
step, in the traced slice; the rest of the step is the loss, the
backward and the optimizer."""

UNIT = "ms"


def read(ctx):
    sl = ctx.slice
    if ctx.kind != "train" or sl is None:
        return None
    s = sl.seconds("pb.forward")
    return 1e3 * s / sl.items if s > 0 else None
