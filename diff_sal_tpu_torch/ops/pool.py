"""Kernel K11: MViT's depthwise 3x3x3 attention pool on the channel-last
layout.

`depthwise_pool3d(x, w, stride)` = the depthwise Conv3d of x (B, T, H, W,
C) with per-channel weights w (3, 3, 3, C), padding 1 and stride (1, sh,
sw), computed in f32 and rounded once to x's dtype. It replaces the TPU
kernel `diff_sal_tpu/ops/pool.py:217 depthwise_pool3d` (body `_pool_kernel`
:75), which MViT runs with `MViTConfig.pool_mode="pallas"`.

On the H100 the pool is bound by bytes (27 multiply-adds per output
element against one read of the input pixels some tap touches and one
write of out). The kernel (`csrc/pool.cu`) gives a thread a strip of
outputs along W and two channels and walks the temporal planes once, as
the TPU kernel walks T with its ring: each input plane is loaded once per
strip (the next plane's loads in flight while this one's products run)
and added to the three outputs it feeds in three rolling f32
accumulators; adjacent outputs share their column taps in registers, and
the 27 weights of the thread's channels stay in registers. `pool_plan`
picks the strip length and how many output planes a thread walks from the
call's shape, so that the small strided calls still reach every SM. It
reads x in place, with its pixels any multiple of 16 bytes apart, so the
q or kv columns of the qkv projection's output need no copy; the cuDNN
route (`models/layers.py:conv3d`) copies them to NCDHW first. The TPU
kernel needs C % 128 == 0 for its lanes; this one takes any C that is a
multiple of 8 (bf16) or 4 (f32), such as the port's unpadded head_dim of
96.

K11 is differentiable: an autograd Function whose backward is plain
math, the depthwise conv3d VJP in x's dtype with the weights cast to it,
as the JAX package's `_pool_bwd` (pool.py:229) takes XLA's conv VJP. The
TPU has no backward kernel there, so neither does the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from diff_sal_tpu_torch.ops import kernels as K

KERNEL = K.Kernel(
    "depthwise_pool3d", "pool.cu", "dsal_depthwise_pool3d",
    [K.P] * 3 + [K.I] * 13 + [K.P],
    replaces="diff_sal_tpu/ops/pool.py:217 depthwise_pool3d (_pool_kernel :75)",
)


NUM_SMS = 132  # H100 SXM
POOL_THREADS = 128  # per CTA, as csrc/pool.cu's THREADS
POOL_V = 2  # channels per thread


def _out_size(n: int, s: int) -> int:
    # kernel 3, padding 1, stride s
    return (n - 1) // s + 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class PoolPlan:
    """K11's launch geometry: `strip` outputs along W and `t_block` output
    planes per thread (POOL_V channels each), `strips` x `t_blocks` x Ho x
    B x C / POOL_V threads in `ctas` CTAs of POOL_THREADS."""
    strip: int
    t_block: int
    strips: int
    t_blocks: int
    threads: int
    ctas: int


def pool_plan(B: int, T: int, H: int, W: int, C: int, sh: int, sw: int) -> PoolPlan:
    """The K11 geometry for x (B, T, H, W, C) at stride (1, sh, sw): strips
    of 4 outputs where column strides let neighbours share taps (sw <= 2),
    else 1; each thread walks all T, the walk halved while the grid leaves
    an SM without a CTA."""
    if min(B, T, H, W, sh, sw) < 1 or C < POOL_V or C % POOL_V:
        raise ValueError(f"depthwise_pool3d: no plan for x {(B, T, H, W, C)} "
                         f"stride (1, {sh}, {sw})")
    Ho, Wo = _out_size(H, sh), _out_size(W, sw)
    strip = 4 if sw <= 2 else 1
    strips = _cdiv(Wo, strip)
    rows = B * Ho * strips * (C // POOL_V)  # threads per plane block
    t_block = T
    while t_block > 1 and _cdiv(rows * _cdiv(T, t_block), POOL_THREADS) < NUM_SMS:
        t_block = _cdiv(t_block, 2)
    t_blocks = _cdiv(T, t_block)
    return PoolPlan(strip, t_block, strips, t_blocks, rows * t_blocks,
                    _cdiv(rows * t_blocks, POOL_THREADS))


def _ncdhw_weight(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(3, 3, 3, C) -> the grouped conv's (C, 1, 3, 3, 3)."""
    return w.to(dt).permute(3, 0, 1, 2)[:, None].contiguous()


def pool_plain(x: torch.Tensor, w: torch.Tensor,
               stride: Tuple[int, int, int]) -> torch.Tensor:
    """K11's plain version: the depthwise conv in f32 (f64 for f64 inputs)
    with f32 weights, rounded once to x's dtype."""
    f = K.acc_dtype(x.dtype)
    xc = x.to(f).permute(0, 4, 1, 2, 3).contiguous()
    y = F.conv3d(xc, _ncdhw_weight(w, f), None, tuple(stride), 1, 1, x.shape[-1])
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def pool_bwd(x: torch.Tensor, w: torch.Tensor, stride: Tuple[int, int, int],
             g: torch.Tensor):
    """(dx, dw) of the pool: the depthwise conv3d VJP in x's dtype with w
    cast to it (JAX `_pool_bwd`); dw returned in w's dtype."""
    d = x.dtype
    with torch.enable_grad():
        xc = x.detach().permute(0, 4, 1, 2, 3).contiguous().requires_grad_()
        wc = _ncdhw_weight(w.detach(), d).requires_grad_()
        y = F.conv3d(xc, wc, None, tuple(stride), 1, 1, x.shape[-1])
        dx, dw = torch.autograd.grad(y, (xc, wc), g.to(d).permute(0, 4, 1, 2, 3))
    return dx.permute(0, 2, 3, 4, 1), dw[:, 0].permute(1, 2, 3, 0).to(w.dtype)


def pool_fwd(x: torch.Tensor, w: torch.Tensor,
             stride: Tuple[int, int, int]) -> torch.Tensor:
    """Kernel K11 on CUDA, the plain version on the CPU; no autograd."""
    K.refuse_dtensor("depthwise_pool3d", x, w)
    if x.device.type == "cpu":
        return pool_plain(x, w, stride)
    K.require_cuda(x, "depthwise_pool3d")
    st, sh, sw = stride
    K.check(x.dim() == 5, f"depthwise_pool3d: x must be (B, T, H, W, C), got {tuple(x.shape)}")
    B, T, H, W, C = x.shape
    dt = x.dtype
    K.check(dt in (torch.bfloat16, torch.float32), f"depthwise_pool3d: dtype {dt}")
    K.check(st == 1 and sh >= 1 and sw >= 1,
            f"depthwise_pool3d: stride {tuple(stride)}; the temporal stride must be 1")
    K.check(tuple(w.shape) == (3, 3, 3, C) and w.dtype == torch.float32
            and w.is_contiguous() and w.device == x.device and w.data_ptr() % 16 == 0,
            f"depthwise_pool3d: w must be (3, 3, 3, {C}) f32, contiguous, 16-byte aligned, "
            f"on {x.device}")
    vec = 8 if dt == torch.bfloat16 else 4
    ps = x.stride(3)
    K.check(x.stride(4) == 1 and x.stride(2) == W * ps and x.stride(1) == H * W * ps
            and x.stride(0) == T * H * W * ps and ps >= C,
            f"depthwise_pool3d: x's pixels must be equally spaced rows of C channels, "
            f"strides {x.stride()}")
    K.check(C % vec == 0 and ps % vec == 0 and x.data_ptr() % 16 == 0,
            f"depthwise_pool3d: needs C and the pixel stride % {vec} == 0 and 16-byte "
            f"alignment (C={C}, pixel stride {ps})")
    Ho, Wo = _out_size(H, sh), _out_size(W, sw)
    out = torch.empty((B, T, Ho, Wo, C), dtype=dt, device=x.device)
    if out.numel() == 0:
        return out
    plan = pool_plan(B, T, H, W, C, sh, sw)
    KERNEL.launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, T, H, W, C, ps, Ho, Wo,
                  sh, sw, plan.strip, plan.t_block, int(dt == torch.bfloat16), K.stream())
    return out


class _Pool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return pool_fwd(x, w, stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = pool_bwd(x, w, ctx.stride, g)
        return dx, dw, None


def depthwise_pool3d(x: torch.Tensor, w: torch.Tensor,
                     stride: Tuple[int, int, int]) -> torch.Tensor:
    """Depthwise 3x3x3 pool, padding 1, of x (B, T, H, W, C) with f32
    weights w (3, 3, 3, C) and stride (1, sh, sw): K11 forward (plain on
    the CPU), plain backward."""
    return _Pool.apply(x, w, tuple(stride))
