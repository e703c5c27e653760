"""Kernel K1: pooled attention with the decomposed (T, H, W) rel-pos bias
and residual pooling, for MViT's spatial query rows.

Replaces the TPU kernel `diff_sal_tpu/ops/attention.py:601
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

HEAD_DIMS = (64, 96, 128)
MAX_REL = 256


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


def bias_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rel: torch.Tensor, k_shape: Tuple[int, int, int],
                         num_heads: int, scale: float,
                         residual: bool = True) -> torch.Tensor:
    """K1's plain version: materialized f32 scores, the bias broadcast from
    rel, softmax, probabilities rounded to the input dtype before the
    product with v, f32 accumulation, residual added before the final
    rounding."""
    B, Lq, H, D, Lk = _shapes(q, k, rel, k_shape, num_heads)
    kt, kh, kw = k_shape
    qs = q.reshape(B, Lq, H, D) * torch.tensor(scale, dtype=q.dtype)
    scores = torch.einsum("blhd,bkhd->bhlk", qs.float(),
                          k.reshape(B, Lk, H, D).float())
    r = rel.float()
    bias = (r[..., :kt, None, None] + r[..., None, kt:kt + kh, None]
            + r[..., None, None, kt + kh:]).reshape(B, Lq, H, kt * kh * kw)
    bias = torch.nn.functional.pad(bias, (1, 0))  # zero bias for the cls key
    probs = torch.softmax(scores + bias.permute(0, 2, 1, 3), dim=-1)
    out = torch.einsum("bhlk,bkhd->blhd", probs.to(q.dtype).float(),
                       v.reshape(B, Lk, H, D).float()).reshape(B, Lq, H * D)
    if residual:
        out = out + q.float()
    return out.to(q.dtype)


def bias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   rel: torch.Tensor, k_shape: Tuple[int, int, int],
                   num_heads: int, scale: float,
                   residual: bool = True) -> torch.Tensor:
    """Kernel K1 on CUDA (bf16 only), the plain version on the CPU."""
    if q.device.type == "cpu":
        return bias_attention_plain(q, k, v, rel, k_shape, num_heads, scale, residual)
    K.require_cuda(q, "bias_attention")
    B, Lq, H, D, Lk = _shapes(q, k, rel, k_shape, num_heads)
    kt, kh, kw = k_shape
    for name, t in (("q", q), ("k", k), ("v", v), ("rel", rel)):
        K.check(t.dtype == torch.bfloat16, f"bias_attention: {name} must be bf16, got {t.dtype}")
        K.check(t.device == q.device and t.is_contiguous() and t.data_ptr() % 16 == 0,
                f"bias_attention: {name} must be contiguous, 16-byte aligned, on {q.device}")
    K.check(tuple(v.shape) == tuple(k.shape), "bias_attention: v shape != k shape")
    K.check(k.shape[0] == B, "bias_attention: batch mismatch")
    K.check(D in HEAD_DIMS, f"bias_attention: head_dim {D} not in {HEAD_DIMS}")
    K.check(kt + kh + kw <= MAX_REL, f"bias_attention: kt+kh+kw > {MAX_REL}")
    out = torch.empty_like(q)
    # q * scale is rounded in q's dtype, with the scale itself in that dtype,
    # as the TPU kernel computes it
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(), out.data_ptr(),
        B, Lq, Lk, H, D, kt, kh, kw, scale_q, int(residual), K.stream(),
    )
    return out
