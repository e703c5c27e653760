"""The yardstick of the kernels: the published peaks of one H100 SXM and,
for each kernel wrapper of the port, the bytes it must move and the
operations it must compute, worked out from the call's shapes (a frozen
copy of `chip_smoke.py:bound_terms`). A call's bound is the least time
the card could take for it: the larger of its bytes at the memory's rate
and its operations at their units' rates. Each input is read once and
each output written once."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, HBM3
BF16_TENSOR_FLOPS = 989e12       # dense bf16 on the tensor cores
F32_FLOPS = 67e12                # f32 outside the tensor cores
SPLIT_TF32_FLOPS = 495e12 / 3    # f32 products at f32's accuracy: three TF32 products


def _pool_touched(n: int, s: int) -> int:
    """How many of n input rows a 3-tap window at stride s, padding 1, reads."""
    return len({o * s + k for o in range((n - 1) // s + 1) for k in (-1, 0, 1)} & set(range(n)))


def bound_terms(kernel: str, args):
    """(bytes, [(operations, peak rate of their kind), ...]) of one call."""
    e = args[0].element_size() if hasattr(args[0], "element_size") else 2
    mm_peak = BF16_TENSOR_FLOPS if e == 2 else SPLIT_TF32_FLOPS
    if kernel == "bias_attention":
        q, k, v, rel = args[:4]
        Bq, Lq, HD = q.shape
        nbytes = (2 * q.numel() + 2 * k.numel() + rel.numel()) * e
        return nbytes, [(4.0 * Bq * Lq * k.shape[1] * HD, mm_peak)]
    if kernel == "bias_attention_bwd":
        q, k, v, rel, g, _, H = args[:7]
        Bq, Lq, HD = q.shape
        nbytes = e * (3 * q.numel() + 4 * k.numel() + 2 * rel.numel()) + 4 * Bq * H * Lq
        return nbytes, [(10.0 * Bq * Lq * k.shape[1] * HD, mm_peak)]
    if kernel == "layer_norm":
        x = args[0]
        C = x.shape[-1]
        return 2 * x.numel() * x.element_size() + 2 * C * 4, [(8.0 * x.numel(), F32_FLOPS)]
    if kernel == "layer_norm_bwd":
        x, g, w = args[:3]
        return (3 * x.numel() * x.element_size() + 3 * w.numel() * 4,
                [(12.0 * x.numel(), F32_FLOPS)])
    if kernel == "block_tail":
        skip, attn, lw, lb, w1 = args[:5]
        R, C = skip.shape
        Hd = w1.shape[0]
        nbytes = 3 * R * C * e + 2 * C * Hd * e + (3 * C + Hd) * 4
        return nbytes, [(4.0 * R * C * Hd, mm_peak)]
    if kernel == "bilinear_resize_sum":
        xs, (H, W) = args[:2]
        es = xs[0].element_size()
        out = xs[0].shape[0] * H * W * xs[0].shape[-1]
        return (sum(x.numel() for x in xs) * es + out * es, [(8.0 * len(xs) * out, F32_FLOPS)])
    if kernel == "bilinear_resize_add":
        acc, x = args[:2]
        return (2 * acc.numel() * acc.element_size() + x.numel() * x.element_size(),
                [(8.0 * acc.numel(), F32_FLOPS)])
    if kernel == "cvt_attention":
        q, k = args[:2]
        Bt, L, C = q.shape
        return e * (2 * q.numel() + 2 * k.numel()), [(4.0 * Bt * L * k.shape[1] * C, mm_peak)]
    if kernel == "fused_bias_attention":
        q, k, v, rt, rh, rw = args[:6]
        BH, Lq, D = q.shape
        nbytes = e * (2 * q.numel() + 2 * k.numel()) + 4 * (rt.numel() + rh.numel() + rw.numel())
        return nbytes, [(4.0 * BH * Lq * k.shape[1] * D, mm_peak)]
    if kernel == "fused_bias_attention_bwd":
        q, k, v, rt, rh, rw = args[:6]
        BH, Lq, D = q.shape
        nbytes = (e * (3 * q.numel() + 4 * k.numel()) + 8 * (rt.numel() + rh.numel() + rw.numel())
                  + 4 * BH * Lq)
        return nbytes, [(10.0 * BH * Lq * k.shape[1] * D, mm_peak)]
    if kernel == "depthwise_pool3d":
        x, w, (_, sh, sw) = args[:3]
        B, T, H, W, C = x.shape
        out = B * T * ((H - 1) // sh + 1) * ((W - 1) // sw + 1) * C
        touched = B * T * _pool_touched(H, sh) * _pool_touched(W, sw) * C
        return (touched + out) * x.element_size() + w.numel() * 4, [(54.0 * out, F32_FLOPS)]
    if kernel == "resize_conv_relu":
        xs, (H, W), kern = args[:3]
        B, C, O = xs[0].shape[0], xs[0].shape[-1], kern.shape[-1]
        es = xs[0].element_size()
        nbytes = (sum(x.numel() for x in xs) + kern.numel() + B * H * W * O) * es + O * 4
        return nbytes, [(2.0 * B * H * W * 9 * C * O,
                         BF16_TENSOR_FLOPS if es == 2 else SPLIT_TF32_FLOPS),
                        (8.0 * len(xs) * B * H * W * C, F32_FLOPS)]
    raise KeyError(kernel)


def bound_seconds(kernel: str, args) -> float:
    nbytes, ops = bound_terms(kernel, args)
    return max(nbytes / HBM_BYTES_PER_S, sum(n / peak for n, peak in ops))
