"""Device ms per batch charged to the model's `encode_visual` and
`encode_audio` (MViT; VGGish and AudioAttnNet) in the traced slice."""

UNIT = "ms"


def read(ctx):
    sl = ctx.slice
    if ctx.kind != "infer" or sl is None:
        return None
    s = sl.seconds("pb.encode_visual") + sl.seconds("pb.encode_audio")
    return 1e3 * s / sl.items if s > 0 else None
