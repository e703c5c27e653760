"""Decomposed relative-position embeddings of MViTv2 pooled attention
(reference `models/mvit.py:331-401`; JAX package `ops/rel_pos.py`).

The learned (L, C) tables are linearly resized to length 2*max(q, k) - 1
with the half-pixel matrix of `ops/resize.py` (torch's
`F.interpolate(mode='linear', align_corners=False)`) and gathered at static (q, k) relative
coordinates; `add_decomposed_rel_pos` adds the resulting bias to full
attention logits, as MViT without its cls token does (JAX's einsum path,
`models/mvit.py:838-851`). MViT's cls-token layouts do not materialize
that bias: they hand the per-axis terms to kernel K1 or K12
(`ops/attention.py`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from diff_sal_tpu_torch.ops.kernels import acc_dtype
from diff_sal_tpu_torch.ops.resize import _linear_weights


@functools.lru_cache(maxsize=None)
def _rel_coords(q_size: int, k_size: int) -> np.ndarray:
    """(q, k) index grid into the resized table; coordinates are scaled by
    the long/short ratio when q and k sizes differ (reference mvit.py:359-366)."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    q_coords = np.arange(q_size)[:, None] * q_ratio
    k_coords = np.arange(k_size)[None, :] * k_ratio
    rel = (q_coords - k_coords) + (k_size - 1) * k_ratio
    return rel.astype(np.int64)  # truncation == torch .long() on non-negatives


def resize_rel_pos(rel_pos: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """(q_size, k_size, C) table from a learned (L, C) table, in f32."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    table = rel_pos.to(acc_dtype(rel_pos.dtype))
    if table.shape[0] != max_rel_dist:
        m = torch.from_numpy(_linear_weights(table.shape[0], max_rel_dist)).to(table)
        table = m @ table
    coords = torch.from_numpy(_rel_coords(q_size, k_size)).to(table.device)
    return table[coords]


def rel_pos_terms(q: torch.Tensor, q_shape, k_shape, rel_pos_t, rel_pos_h,
                  rel_pos_w) -> torch.Tensor:
    """Per-axis bias terms of the spatial query rows.

    q: (B, qt*qh*qw, heads, C) in the compute dtype. Returns (B, Lq, heads,
    kt + kh + kw) = [q.Rt | q.Rh | q.Rw], the rel layout kernel K1 takes."""
    B, _, H, C = q.shape
    qt, qh, qw = q_shape
    kt, kh, kw = k_shape
    dt = q.dtype
    r_q = q.reshape(B, qt, qh, qw, H, C)
    rt = torch.einsum("bthwnc,tkc->bthwnk", r_q, resize_rel_pos(rel_pos_t, qt, kt).to(dt))
    rh = torch.einsum("bthwnc,hkc->bthwnk", r_q, resize_rel_pos(rel_pos_h, qh, kh).to(dt))
    rw = torch.einsum("bthwnc,wkc->bthwnk", r_q, resize_rel_pos(rel_pos_w, qw, kw).to(dt))
    return torch.cat([rt, rh, rw], dim=-1).reshape(B, qt * qh * qw, H, kt + kh + kw)


def rel_pos_parts(q: torch.Tensor, q_shape, k_shape, rel_pos_t, rel_pos_h, rel_pos_w):
    """The bias terms of the token-concat layout (JAX `mvit.py:824-830`,
    the `contract` of kernel K12's caller): q (N, qt*qh*qw, C) the spatial
    query rows of N = batch*heads. Returns rel_t (N, 1 + Lq, kt), rel_h
    (.., kh), rel_w (.., kw) in f32 (f64 for f64 q), each with a zero row 0
    for the cls query: the einsum of the compute-dtype q with the f32
    tables promotes, as in JAX."""
    N, Lq, C = q.shape
    terms = rel_pos_terms(q.to(acc_dtype(q.dtype)).reshape(N, Lq, 1, C), q_shape, k_shape,
                          rel_pos_t, rel_pos_h, rel_pos_w)
    terms = torch.nn.functional.pad(terms.reshape(N, Lq, -1), (0, 0, 1, 0))
    return [t.contiguous() for t in terms.split(tuple(k_shape), dim=-1)]


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor, q_shape, k_shape,
                           rel_pos_t, rel_pos_h, rel_pos_w,
                           with_cls_token: bool = True) -> torch.Tensor:
    """Add the decomposed bias to logits attn (B, heads, Lq, Lk), q (B,
    heads, Lq, C); cls rows and columns (index 0) get no bias. Types
    follow JAX: the compute-dtype q meets the f32 tables (f64 for f64
    ones) and the bias is in f32; without a cls token bf16 logits promote
    to f32 with it, with one they keep their dtype."""
    sp = 1 if with_cls_token else 0
    qt, qh, qw = q_shape
    kt, kh, kw = k_shape
    B, H, _, C = q.shape
    Rt = resize_rel_pos(rel_pos_t, qt, kt)
    Rh = resize_rel_pos(rel_pos_h, qh, kh)
    Rw = resize_rel_pos(rel_pos_w, qw, kw)
    f = torch.promote_types(q.dtype, Rt.dtype)
    r_q = q[:, :, sp:].reshape(B, H, qt, qh, qw, C).to(f)
    rel_t = torch.einsum("bythwc,tkc->bythwk", r_q, Rt.to(f))
    rel_h = torch.einsum("bythwc,hkc->bythwk", r_q, Rh.to(f))
    rel_w = torch.einsum("bythwc,wkc->bythwk", r_q, Rw.to(f))
    bias = (rel_t[..., :, None, None] + rel_h[..., None, :, None]
            + rel_w[..., None, None, :]).reshape(B, H, qt * qh * qw, kt * kh * kw)
    if not sp:
        return attn + bias
    attn = attn.clone()
    attn[:, :, sp:, sp:] += bias.to(attn.dtype)  # JAX's `.at[].add` keeps attn's dtype
    return attn
