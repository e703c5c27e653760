"""Static-shape resizes, and kernel K4: the decoder's multi-scale
bilinear resize-and-sum.

Bilinear interpolation uses the half-pixel rule of
`torch.nn.functional.interpolate(mode='bilinear', align_corners=False)`
with edge clamp, written as one dense (out, in) matrix per axis
(`_linear_weights`, a copy of the JAX package's `ops/resize.py:23`).

K4 `bilinear_resize_sum(xs, out_hw)` = sum_i bilinear_resize(x_i, out_hw)
replaces the TPU kernel `diff_sal_tpu/ops/resize.py:235
bilinear_resize_sum` (body `_resize_sum_kernel` :206). On the H100 it is
bound by the bytes it writes: the (B, 112, 192, 768) output is ~2.5x
the four small inputs together, and it does ~16 multiply-adds per output
element. The kernel (`csrc/resize.cu`) is a gather pass: one thread per
(output pixel, 8 channels) reads the 2x2 taps of each input with 16-byte
loads, sums in f32 and writes the output once. Tap rows, columns and
weights come from the same `_linear_weights` rule (lo, hi, 1-frac, frac),
so it matches the matrix form to rounding.

K4 is differentiable: an autograd Function whose backward is plain math,
as in the JAX package (`op_bwd`, resize.py:310): d x_i = Ah_i^T g Aw_i^T in
f32, cast to x_i's dtype. The TPU has no kernel there, so neither does the
port.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from diff_sal_tpu_torch.ops import kernels as K

KERNEL = K.Kernel(
    "bilinear_resize_sum", "resize.cu", "dsal_resize_sum",
    [K.P] * 4 + [K.P, K.P, K.P] + [K.I] * 4 + [K.I] * 4 + [K.I] * 6 + [K.P],
    replaces="diff_sal_tpu/ops/resize.py:235 bilinear_resize_sum "
             "(_resize_sum_kernel :206)",
)

MAX_INPUTS = 4


def _taps(in_size: int, out_size: int):
    """(lo, hi, w_lo, w_hi) of the half-pixel rule, float64 coordinates."""
    scale = in_size / out_size
    coords = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    coords = np.clip(coords, 0.0, in_size - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = coords - lo
    return lo, hi, (1.0 - frac).astype(np.float32), frac.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out, in) interpolation matrix, half-pixel centres, edge clamp."""
    lo, hi, wl, wh = _taps(in_size, out_size)
    w = np.zeros((out_size, in_size), dtype=np.float32)
    w[np.arange(out_size), lo] += wl
    w[np.arange(out_size), hi] += wh
    return w


def _matrix(in_size: int, out_size: int, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(_linear_weights(in_size, out_size)).to(device, dtype)


def bilinear_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the (H, W) axes of a (..., H, W, C) tensor; f32
    math, dtype preserved."""
    out_h, out_w = out_hw
    in_h, in_w = x.shape[-3], x.shape[-2]
    lead = x.shape[:-3]
    f = K.acc_dtype(x.dtype)
    xf = x.to(f).reshape((-1,) + tuple(x.shape[-3:]))
    if in_h != out_h:
        xf = torch.einsum("oh,bhwc->bowc", _matrix(in_h, out_h, x.device, f), xf)
    if in_w != out_w:
        xf = torch.einsum("ow,bhwc->bhoc", _matrix(in_w, out_w, x.device, f), xf)
    return xf.reshape(tuple(lead) + (out_h, out_w, x.shape[-1])).to(x.dtype)


def linear_resize_1d(x: torch.Tensor, out_size: int, axis: int = 0) -> torch.Tensor:
    """1-D half-pixel linear resize along `axis`."""
    axis = axis % x.ndim
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    w = _matrix(in_size, out_size, x.device)
    y = torch.tensordot(w, x.float(), dims=([1], [axis]))
    return torch.movedim(y, 0, axis).to(x.dtype)


def nearest_upsample(x: torch.Tensor, factor: int, h_axis: int = -3,
                     w_axis: int = -2) -> torch.Tensor:
    """Integer-factor nearest upsample (a repeat along both axes)."""
    if factor == 1:
        return x
    x = torch.repeat_interleave(x, factor, dim=h_axis % x.ndim)
    return torch.repeat_interleave(x, factor, dim=w_axis % x.ndim)


def bilinear_resize_sum_plain(xs: Sequence[torch.Tensor],
                              out_hw: Tuple[int, int]) -> torch.Tensor:
    """K4's plain version: the f32 sum of the resized maps, cast once."""
    acc = None
    for x in xs:
        r = bilinear_resize(x.to(K.acc_dtype(x.dtype)), out_hw)
        acc = r if acc is None else acc + r
    return acc.to(xs[0].dtype)


@functools.lru_cache(maxsize=None)
def _tap_tables(shapes: Tuple[Tuple[int, int], ...], out_hw, device):
    """Per input i: int32 [lo | hi] and f32 [w_lo | w_hi] rows of length
    H + W (rows first, then columns), stacked to (n, 2, H + W)."""
    H, W = out_hw
    idx = np.zeros((len(shapes), 2, H + W), np.int32)
    wts = np.zeros((len(shapes), 2, H + W), np.float32)
    for i, (h, w) in enumerate(shapes):
        for off, (a, b) in ((0, (h, H)), (H, (w, W))):
            lo, hi, wl, wh = _taps(a, b)
            idx[i, 0, off:off + b], idx[i, 1, off:off + b] = lo, hi
            wts[i, 0, off:off + b], wts[i, 1, off:off + b] = wl, wh
    return (torch.from_numpy(idx).to(device), torch.from_numpy(wts).to(device))


def bilinear_resize_sum_fwd(xs: Sequence[torch.Tensor],
                            out_hw: Tuple[int, int]) -> torch.Tensor:
    """Kernel K4 on CUDA, the plain version on the CPU; no autograd."""
    xs = list(xs)
    if xs[0].device.type == "cpu":
        return bilinear_resize_sum_plain(xs, out_hw)
    K.require_cuda(xs[0], "bilinear_resize_sum")
    B, _, _, C = xs[0].shape
    dt = xs[0].dtype
    K.check(1 <= len(xs) <= MAX_INPUTS, f"resize_sum takes 1..{MAX_INPUTS} inputs")
    K.check(dt in (torch.bfloat16, torch.float32), f"resize_sum dtype {dt}")
    vec = 8 if dt == torch.bfloat16 else 4
    K.check(C % vec == 0, f"resize_sum needs C % {vec} == 0, got {C}")
    for x in xs:
        K.check(x.dim() == 4 and x.shape[0] == B and x.shape[3] == C
                and x.dtype == dt and x.device == xs[0].device
                and x.is_contiguous() and x.data_ptr() % 16 == 0,
                "resize_sum inputs: (B,h,w,C) contiguous, 16-byte aligned, one dtype")
    H, W = out_hw
    shapes = tuple((x.shape[1], x.shape[2]) for x in xs)
    idx, wts = _tap_tables(shapes, (H, W), xs[0].device)
    out = torch.empty((B, H, W, C), dtype=dt, device=xs[0].device)
    ptrs = [x.data_ptr() for x in xs] + [None] * (MAX_INPUTS - len(xs))
    hs = [s[0] for s in shapes] + [0] * (MAX_INPUTS - len(xs))
    ws = [s[1] for s in shapes] + [0] * (MAX_INPUTS - len(xs))
    KERNEL.launch(
        *ptrs, idx.data_ptr(), wts.data_ptr(), out.data_ptr(), *hs, *ws,
        len(xs), B, H, W, C, int(dt == torch.bfloat16), K.stream(),
    )
    return out


def bilinear_resize_sum_bwd(g: torch.Tensor, shapes, dtypes):
    """d x_i = Ah_i^T g Aw_i^T in f32, cast to x_i's dtype (JAX `op_bwd`)."""
    f = K.acc_dtype(g.dtype)
    H, W = g.shape[1], g.shape[2]
    return tuple(
        torch.einsum("ow,bhoc->bhwc", _matrix(w, W, g.device, f),
                     torch.einsum("oh,bowc->bhwc", _matrix(h, H, g.device, f), g.to(f))).to(dt)
        for (h, w), dt in zip(shapes, dtypes))


class _ResizeSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out_hw, *xs):
        ctx.shapes = [(x.shape[1], x.shape[2]) for x in xs]
        ctx.dtypes = [x.dtype for x in xs]
        return bilinear_resize_sum_fwd(xs, out_hw)

    @staticmethod
    def backward(ctx, g):
        return (None,) + bilinear_resize_sum_bwd(g, ctx.shapes, ctx.dtypes)


def bilinear_resize_sum(xs: Sequence[torch.Tensor],
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """sum_i bilinear_resize(x_i, out_hw) for n <= 4 channel-last maps
    (B, h_i, w_i, C) of one dtype: K4 forward (plain on the CPU), plain
    backward."""
    return _ResizeSum.apply(tuple(out_hw), *xs)
