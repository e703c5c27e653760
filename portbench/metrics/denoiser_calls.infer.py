"""Calls of the model's `denoise` per batch in the window: the sampler's
number of function evaluations, counted by the benchmark's wrapper."""

UNIT = "calls"


def read(ctx):
    if ctx.kind != "infer" or not ctx.items:
        return None
    return ctx.model_calls["denoise"] / ctx.items
