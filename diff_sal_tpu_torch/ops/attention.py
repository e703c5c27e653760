"""Kernels K1 and K5: pooled attention with the decomposed (T, H, W)
rel-pos bias and residual pooling, for MViT's spatial query rows, and its
backward.

K1 replaces the TPU kernel `diff_sal_tpu/ops/attention.py:601
fused_bias_attention_v2` (body `_attn_v2_kernel` :477). Per head:

    out = softmax(q k^T * scale + bias) v  (+ q when `residual`)
    bias[l, j] = rel_t[l, t(j)] + rel_h[l, h(j)] + rel_w[l, w(j)]  for j >= 1

with (t, h, w) = unravel(j - 1) over the (kt, kh, kw) key grid and zero
bias for key 0, the cls token. Layouts as in the JAX package: q (B, Lq,
H*D) holds the spatial rows only, k and v (B, Lk, H*D) carry cls at row 0,
Lk = 1 + kt*kh*kw. rel is (B, Lq, H, kt + kh + kw), unpadded (the TPU pads
each head to 128 lanes).

On the H100 the work is dominated by the two products (4*Lq*Lk*D flops
per head; Lq = 43008, Lk = 673 at block 0, Lk = 2689 at block 1), well
above the bytes of q, k, v, rel and out, so it is bound by operations.
The kernel (`csrc/attention.cu`) is a flash-style forward: one CTA per
(batch, head, 64 query rows); K/V tiles of 64 keys stream through shared
memory; S = Q K^T and O += P V run on the tensor cores (WMMA, bf16 in,
f32 accumulation); the softmax is online in f32, the bias comes from
index math on each key's (t, h, w) and key columns past Lk are masked.
The (Lq, Lk) score matrix never reaches device memory. head_dim is 96
at every MViT stage: it is a multiple of 16, so no padding is needed.

K5 replaces the TPU kernel `diff_sal_tpu/ops/attention.py:761 _fba2_bwd`
(body `_attn_v2_bwd_kernel` :697): dq, dk, dv and drel of K1 from the
output gradient g. It recomputes the probabilities (the score matrix is
never stored) and is bound by operations: five (Lq, Lk, D) products per
head, ~10*Lq*Lk*D flops. The kernel (`csrc/attention_bwd.cu`) has two
parts. A q-major kernel, one CTA per (batch, head, 64 query rows), walks
the key tiles three times: the row logsumexp, then delta = rowsum(dp * p),
then ds, accumulating dq in WMMA fragments and drel as a product of ds
with the tile's one-hot (key -> t, h, w) matrix, as the TPU kernel does
(ds as bf16 hi + lo parts, f32 accumulation); it writes dq and drel once
and leaves logsumexp and delta for the second part. A k-major kernel, one CTA per (batch, head, 64 keys, q split),
walks its split of the query tiles and accumulates dk and dv in
registers; the splits (enough CTAs to fill the card where Lk is small)
go to an f32 workspace and a third small kernel sums them in a fixed
order, so no atomics touch device memory and results are deterministic.

`bias_attention` is differentiable: on either device it is an autograd
Function whose forward is K1 (plain on the CPU) and whose backward is K5
(plain on the CPU).

K7 replaces the TPU kernel `diff_sal_tpu/ops/attention.py:893
cvt_cross_attention` (body `_cvt_attn_kernel` :841): the SalUNet
decoder's CvT cross-attention softmax(q k^T * scale) v per head, q (Bt, L,
C) with L up to 5376 and k, v (Bt, S, C) pooled to S = 18 keys, scale =
C^-1/2 (the reference's full-dim quirk). It runs at eval with
`SalUNetConfig.fused_attn`. With so few keys it is bound by the bytes of q
and out (4 S flops per q element). The kernel (`csrc/cvt_attention.cu`)
stages 64 query rows and one head's k and v of one batch item in shared
memory, computes the scores on the tensor cores (bf16 WMMA, f32
accumulation), takes the softmax in f32 with a row max, rounds p to bf16
and runs p v on the tensor cores with f32 accumulation; the (L, S) scores
never reach device memory. K7 is eval-only, in the JAX package and here:
`cvt_cross_attention` raises when grad mode is on and an input requires
grad.
"""

from __future__ import annotations

from typing import Tuple

import torch

from diff_sal_tpu_torch.ops import kernels as K

KERNEL = K.Kernel(
    "bias_attention", "attention.cu", "dsal_bias_attention",
    [K.P] * 5 + [K.I] * 8 + [K.F, K.I, K.P],
    replaces="diff_sal_tpu/ops/attention.py:601 fused_bias_attention_v2 "
             "(_attn_v2_kernel :477)",
)
BWD_KERNEL = K.Kernel(
    "bias_attention_bwd", "attention_bwd.cu", "dsal_bias_attention_bwd",
    [K.P] * 12 + [K.I] * 9 + [K.F, K.F, K.I, K.P],
    replaces="diff_sal_tpu/ops/attention.py:761 _fba2_bwd "
             "(_attn_v2_bwd_kernel :697)",
)

HEAD_DIMS = (64, 96, 128)
MAX_REL = 256
MAX_REL_BWD = 128
CVT_KERNEL = K.Kernel(
    "cvt_attention", "cvt_attention.cu", "dsal_cvt_attention",
    [K.P] * 4 + [K.I] * 5 + [K.F, K.P],
    replaces="diff_sal_tpu/ops/attention.py:893 cvt_cross_attention "
             "(_cvt_attn_kernel :841)",
)

BWD_BLOCK = 64        # rows per CTA and keys per tile of K5
BWD_TARGET_CTAS = 264  # two waves of 132 SMs for the k-major part of K5


def _shapes(q, k, rel, k_shape, num_heads):
    B, Lq, HD = q.shape
    H = num_heads
    D = HD // H
    kt, kh, kw = k_shape
    if H * D != HD or k.shape[1] != 1 + kt * kh * kw:
        raise ValueError(f"bias_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"heads {H}, k_shape {k_shape}")
    if tuple(rel.shape) != (B, Lq, H, kt + kh + kw):
        raise ValueError(f"bias_attention: rel {tuple(rel.shape)} != "
                         f"{(B, Lq, H, kt + kh + kw)}")
    return B, Lq, H, D, k.shape[1]


def _probs(q, k, rel, k_shape, H, scale):
    """Softmax probabilities (B, H, Lq, Lk) of the biased scores in the
    accumulation dtype, q*scale rounded in q's dtype first."""
    B, Lq, _, D, Lk = _shapes(q, k, rel, k_shape, H)
    kt, kh, kw = k_shape
    f = K.acc_dtype(q.dtype)
    qs = q.reshape(B, Lq, H, D) * torch.tensor(scale, dtype=q.dtype)
    scores = torch.einsum("blhd,bkhd->bhlk", qs.to(f), k.reshape(B, Lk, H, D).to(f))
    r = rel.to(f)
    bias = (r[..., :kt, None, None] + r[..., None, kt:kt + kh, None]
            + r[..., None, None, kt + kh:]).reshape(B, Lq, H, kt * kh * kw)
    bias = torch.nn.functional.pad(bias, (1, 0))  # zero bias for the cls key
    return torch.softmax(scores + bias.permute(0, 2, 1, 3), dim=-1)


def bias_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel: torch.Tensor, k_shape: Tuple[int, int, int],
                         num_heads: int, scale: float,
                         residual: bool = True) -> torch.Tensor:
    """K1's plain version: materialized f32 scores, the bias broadcast from
    rel, softmax, probabilities rounded to the input dtype before the
    product with v, f32 accumulation, residual added before the final
    rounding."""
    B, Lq, H, D, Lk = _shapes(q, k, rel, k_shape, num_heads)
    f = K.acc_dtype(q.dtype)
    probs = _probs(q, k, rel, k_shape, H, scale)
    out = torch.einsum("bhlk,bkhd->blhd", probs.to(q.dtype).to(f),
                       v.reshape(B, Lk, H, D).to(f)).reshape(B, Lq, H * D)
    if residual:
        out = out + q.to(f)
    return out.to(q.dtype)


def bias_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             rel: torch.Tensor, g: torch.Tensor,
                             k_shape: Tuple[int, int, int], num_heads: int,
                             scale: float, residual: bool = True):
    """K5's plain version: (dq, dk, dv, drel) of K1 for the output gradient
    g, rounding where the TPU kernel rounds: probabilities recomputed in
    f32, p rounded to q's dtype for dv, ds = p * (dp - rowsum(dp * p)) in
    f32 and rounded for dq and dk, f32 accumulation, dq scaled by `scale`
    (plus g when `residual`), drel = ds summed over the keys sharing each
    t, h and w (the cls key left out) in f32; every output in its input's
    dtype."""
    B, Lq, H, D, Lk = _shapes(q, k, rel, k_shape, num_heads)
    kt, kh, kw = k_shape
    dt, f = q.dtype, K.acc_dtype(q.dtype)
    p = _probs(q, k, rel, k_shape, H, scale)
    g4 = g.reshape(B, Lq, H, D).to(f)
    k4 = k.reshape(B, Lk, H, D).to(f)
    dv = torch.einsum("bhlk,blhd->bkhd", p.to(dt).to(f), g4)
    dp = torch.einsum("blhd,bkhd->bhlk", g4, v.reshape(B, Lk, H, D).to(f))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds_lo = ds.to(dt).to(f)
    dq = torch.einsum("bhlk,bkhd->blhd", ds_lo, k4) * scale
    if residual:
        dq = dq + g4
    dk = torch.einsum("bhlk,blhd->bkhd", ds_lo, q.reshape(B, Lq, H, D).to(f)) * scale
    d5 = ds[..., 1:].reshape(B, H, Lq, kt, kh, kw)
    drel = torch.cat([d5.sum((4, 5)), d5.sum((3, 5)), d5.sum((3, 4))], dim=-1)
    return (dq.reshape(B, Lq, H * D).to(dt), dk.reshape(B, Lk, H * D).to(k.dtype),
            dv.reshape(B, Lk, H * D).to(v.dtype), drel.permute(0, 2, 1, 3).to(rel.dtype))


def _check_cuda_inputs(name, q, k, v, rel, k_shape, num_heads, max_rel, extra=()):
    B, Lq, H, D, Lk = _shapes(q, k, rel, k_shape, num_heads)
    kt, kh, kw = k_shape
    for what, t in (("q", q), ("k", k), ("v", v), ("rel", rel)) + tuple(extra):
        K.check(t.dtype == torch.bfloat16, f"{name}: {what} must be bf16, got {t.dtype}")
        K.check(t.device == q.device and t.is_contiguous() and t.data_ptr() % 16 == 0,
                f"{name}: {what} must be contiguous, 16-byte aligned, on {q.device}")
    K.check(tuple(v.shape) == tuple(k.shape), f"{name}: v shape != k shape")
    K.check(k.shape[0] == B, f"{name}: batch mismatch")
    K.check(D in HEAD_DIMS, f"{name}: head_dim {D} not in {HEAD_DIMS}")
    K.check(kt + kh + kw <= max_rel, f"{name}: kt+kh+kw > {max_rel}")
    return B, Lq, H, D, Lk


def bias_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       rel: torch.Tensor, k_shape: Tuple[int, int, int],
                       num_heads: int, scale: float,
                       residual: bool = True) -> torch.Tensor:
    """Kernel K1 on CUDA (bf16 only), the plain version on the CPU; no
    autograd."""
    if q.device.type == "cpu":
        return bias_attention_plain(q, k, v, rel, k_shape, num_heads, scale, residual)
    K.require_cuda(q, "bias_attention")
    B, Lq, H, D, Lk = _check_cuda_inputs("bias_attention", q, k, v, rel, k_shape,
                                         num_heads, MAX_REL)
    kt, kh, kw = k_shape
    out = torch.empty_like(q)
    # q * scale is rounded in q's dtype, with the scale itself in that dtype,
    # as the TPU kernel computes it
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), out.data_ptr(),
        B, Lq, Lk, H, D, kt, kh, kw, scale_q, int(residual), K.stream(),
    )
    return out


def bwd_splits(B: int, H: int, Lq: int, Lk: int) -> int:
    """Number of query splits of K5's k-major part: enough CTAs for two
    waves on the card, at most one query tile per split."""
    ctas = B * H * -(-Lk // BWD_BLOCK)
    return max(1, min(-(-BWD_TARGET_CTAS // ctas), -(-Lq // BWD_BLOCK)))


def bias_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       rel: torch.Tensor, g: torch.Tensor,
                       k_shape: Tuple[int, int, int], num_heads: int,
                       scale: float, residual: bool = True):
    """(dq, dk, dv, drel) of K1: kernel K5 on CUDA (bf16 only), the plain
    version on the CPU."""
    if q.device.type == "cpu":
        return bias_attention_bwd_plain(q, k, v, rel, g, k_shape, num_heads, scale, residual)
    K.require_cuda(q, "bias_attention_bwd")
    B, Lq, H, D, Lk = _check_cuda_inputs("bias_attention_bwd", q, k, v, rel, k_shape,
                                         num_heads, MAX_REL_BWD, (("g", g),))
    K.check(tuple(g.shape) == tuple(q.shape), "bias_attention_bwd: g shape != q shape")
    kt, kh, kw = k_shape
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, drel = torch.empty_like(q), torch.empty_like(rel)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((B, H, Lq), **f32)
    delta = torch.empty((B, H, Lq), **f32)
    splits = bwd_splits(B, H, Lq, Lk)
    work = torch.empty((2, splits) + tuple(k.shape), **f32)
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    BWD_KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), drel.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), work.data_ptr(),
        B, Lq, Lk, H, D, kt, kh, kw, splits, scale_q, float(scale), int(residual),
        K.stream(),
    )
    return dq, dk, dv, drel


class _BiasAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel, k_shape, num_heads, scale, residual):
        ctx.save_for_backward(q, k, v, rel)
        ctx.args = (k_shape, num_heads, scale, residual)
        return bias_attention_fwd(q, k, v, rel, k_shape, num_heads, scale, residual)

    @staticmethod
    def backward(ctx, g):
        q, k, v, rel = ctx.saved_tensors
        grads = bias_attention_bwd(q, k, v, rel, g.contiguous(), *ctx.args)
        return grads + (None, None, None, None)


def bias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   rel: torch.Tensor, k_shape: Tuple[int, int, int],
                   num_heads: int, scale: float,
                   residual: bool = True) -> torch.Tensor:
    """K1 forward, K5 backward (plain versions on the CPU): the autograd
    Function records its backward whenever an input requires grad."""
    return _BiasAttention.apply(q, k, v, rel, tuple(k_shape), num_heads, scale, residual)


def reference_cvt_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_heads: int, scale: float) -> torch.Tensor:
    """K7's plain version (the einsum path of JAX `reference_cvt_attention`,
    attention.py:881), rounding as the TPU kernel does: f32 scores times
    the scale, softmax in f32, p rounded to v's dtype, f32 accumulation,
    one rounding to q's dtype."""
    Bt, L, C = q.shape
    hd = C // num_heads
    f = K.acc_dtype(q.dtype)
    s = torch.einsum("blhd,bthd->bhlt", q.reshape(Bt, L, num_heads, hd).to(f),
                     k.reshape(Bt, -1, num_heads, hd).to(f)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype).to(f)
    out = torch.einsum("bhlt,bthd->blhd", p, v.reshape(Bt, -1, num_heads, hd).to(f))
    return out.reshape(Bt, L, C).to(q.dtype)


def cvt_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v per head for q (Bt, L, C) and k, v (Bt, S,
    C): kernel K7 on CUDA (bf16), the plain version on the CPU. Eval only.
    The C entry refuses, and `launch` raises on, what its tiles do not hold:
    S outside 1..128, head_dim not a multiple of 16, or k and v beyond one
    CTA's shared memory."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("cvt_cross_attention (kernel K7) is eval-only and has no "
                           "backward; call it under torch.no_grad() or take the einsum path")
    if q.device.type == "cpu":
        return reference_cvt_attention(q, k, v, num_heads, scale)
    K.require_cuda(q, "cvt_cross_attention")
    Bt, L, C = q.shape
    S = k.shape[1]
    K.check(tuple(k.shape) == (Bt, S, C) and tuple(v.shape) == (Bt, S, C),
            f"cvt_cross_attention: k {tuple(k.shape)}, v {tuple(v.shape)} for q "
            f"{tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        K.check(t.dtype == torch.bfloat16, f"cvt_cross_attention: {name} must be bf16, "
                                           f"got {t.dtype}")
        K.check(t.device == q.device and t.is_contiguous() and t.data_ptr() % 16 == 0,
                f"cvt_cross_attention: {name} must be contiguous, 16-byte aligned, on "
                f"{q.device}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    CVT_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), Bt, L, S, C,
                      num_heads, float(scale), K.stream())
    return out
