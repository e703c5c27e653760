"""Kernels K2 and K6: row LayerNorm over the last axis with f32
statistics, and its backward.

K2 replaces the TPU kernel `diff_sal_tpu/ops/layernorm.py:134
fused_layernorm` (body `_ln_kernel` :39). The function: mean and E[x^2]
in f32, var = E[x^2] - mean^2 clamped at 0, rsqrt(var + eps), then scale
and bias, output in the input dtype. `real_dim` normalizes over the first
`real_dim` channels of a zero-padded axis and keeps the padded channels at
zero.

On the H100 it is bound by bytes: one read and one write of the rows
against ~8 flops per element. The kernel (`csrc/layernorm.cu`) gives each
row to one warp: every lane keeps its channels in registers (C <= 1024,
so a row is read from device memory once), the two sums reduce with warp
shuffles, and the normalized row is written once. Lane-strided access is
coalesced across the warp; C = 96 needs no padding because lanes past the
row end are masked.

K6 replaces the TPU kernel `diff_sal_tpu/ops/layernorm.py:283 _ln_bwd`
(body `_ln_bwd_kernel` :233): dx with the row statistics recomputed, and
the f32 sums d_weight = sum_rows g * y and d_bias = sum_rows g. It is
bound by bytes too (read x and g, write dx). The kernel
(`csrc/layernorm_bwd.cu`) keeps K2's warp-per-row shape: the row of x and
of g stay in registers, dx is written once, and each warp keeps running
per-channel sums of g * y and g in registers over the rows it visits. A
CTA adds its warps' sums in shared memory and writes one (C,) partial row;
a second small kernel adds the partial rows in a fixed order. No atomics,
so the parameter gradients do not depend on scheduling. CUDA rather than
Triton, to keep the route of the other kernels (nvcc -> shared library ->
ctypes, built in seconds).

`layer_norm` is differentiable: on either device it is an autograd
Function whose forward is K2 (plain on the CPU) and whose backward is K6
(plain on the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch

from diff_sal_tpu_torch.ops import kernels as K

KERNEL = K.Kernel(
    "layer_norm", "layernorm.cu", "dsal_layernorm",
    [K.P, K.P, K.P, K.P, K.I, K.I, K.I, K.F, K.I, K.P],
    replaces="diff_sal_tpu/ops/layernorm.py:134 fused_layernorm (_ln_kernel :39)",
)
BWD_KERNEL = K.Kernel(
    "layer_norm_bwd", "layernorm_bwd.cu", "dsal_layernorm_bwd",
    [K.P] * 7 + [K.I] * 4 + [K.F, K.I, K.P],
    replaces="diff_sal_tpu/ops/layernorm.py:283 _ln_bwd (_ln_bwd_kernel :233)",
)

MAX_C = 1024
BWD_ROWS_PER_CTA = 8    # one warp per row
BWD_MAX_CTAS = 132 * 4  # grid of K6's row pass (four CTAs per SM)


def _padded(p: torch.Tensor, C: int) -> torch.Tensor:
    p = p.to(K.acc_dtype(p.dtype))
    if p.shape[0] < C:
        p = torch.nn.functional.pad(p, (0, C - p.shape[0]))
    return p


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6, real_dim: Optional[int] = None) -> torch.Tensor:
    """K2's plain version."""
    C = x.shape[-1]
    w, b = _padded(weight, C), _padded(bias, C)
    c_real = real_dim or C
    xf = x.to(K.acc_dtype(x.dtype))
    mean = xf.sum(-1, keepdim=True) / c_real
    var = ((xf * xf).sum(-1, keepdim=True) / c_real - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if real_dim is not None and real_dim < C:
        lane = torch.arange(C, device=x.device)
        y = torch.where(lane < real_dim, y, torch.zeros((), device=x.device))
    return (y * w.to(xf.dtype) + b.to(xf.dtype)).to(x.dtype)


def layer_norm_bwd_plain(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
                         eps: float = 1e-6, real_dim: Optional[int] = None):
    """K6's plain version: (dx, dweight, dbias) as the TPU kernel computes
    them. Row statistics in f32; with real_dim < C the pad lanes of dx get
    the mean coupling dmean / c_real (not 0), as in the JAX package; dx in
    x's dtype; dweight and dbias are f32 sums over rows at the parameter's
    length."""
    C = x.shape[-1]
    n_param = weight.shape[0]
    c_real = real_dim or C
    f = K.acc_dtype(x.dtype)
    xf = x.reshape(-1, C).to(f)
    gf = g.reshape(-1, C).to(f)
    s = _padded(weight, C).to(f)
    mask = (torch.arange(C, device=x.device) < c_real).to(f)
    mean = xf.sum(-1, keepdim=True) / c_real
    var = ((xf * xf).sum(-1, keepdim=True) / c_real - mean * mean).clamp_min(0.0)
    r = torch.rsqrt(var + eps)
    u = xf - mean
    y = u * r * mask
    dy = gf * s * mask
    sum_dy = dy.sum(-1, keepdim=True)
    dvar = -0.5 * (r * r * r) * (dy * u).sum(-1, keepdim=True)
    dmean = -r * sum_dy - 2.0 * mean * dvar
    dx = dy * r + (2.0 / c_real) * xf * dvar + dmean / c_real
    return (dx.reshape(x.shape).to(x.dtype), (gf * y).sum(0)[:n_param],
            gf.sum(0)[:n_param])


def _check_rows(name: str, x: torch.Tensor, real_dim):
    C = x.shape[-1]
    K.check(x.dtype in (torch.bfloat16, torch.float32), f"{name} dtype {x.dtype}")
    K.check(C <= MAX_C, f"{name} needs C <= {MAX_C}, got {C}")
    K.check(x.is_contiguous(), f"{name} input must be contiguous")
    K.check(real_dim is None or 0 < real_dim <= C, f"real_dim {real_dim} vs C {C}")
    return x.numel() // C, C


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6, real_dim: Optional[int] = None) -> torch.Tensor:
    """Kernel K2 on CUDA, the plain version on the CPU; no autograd."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, real_dim)
    K.require_cuda(x, "layer_norm")
    R, C = _check_rows("layer_norm", x, real_dim)
    w = _padded(weight, C).contiguous()
    b = _padded(bias, C).contiguous()
    out = torch.empty_like(x)
    if R == 0:
        return out
    KERNEL.launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), R, C, real_dim or C,
        float(eps), int(x.dtype == torch.bfloat16), K.stream(),
    )
    return out


def bwd_ctas(R: int) -> int:
    """CTAs of K6's row pass: one row per warp, at most BWD_MAX_CTAS."""
    return max(1, min(-(-R // BWD_ROWS_PER_CTA), BWD_MAX_CTAS))


def layer_norm_bwd(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6, real_dim: Optional[int] = None):
    """(dx, dweight, dbias) of `layer_norm`: kernel K6 on CUDA, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, g, weight, eps, real_dim)
    K.require_cuda(x, "layer_norm_bwd")
    R, C = _check_rows("layer_norm_bwd", x, real_dim)
    K.check(g.shape == x.shape and g.dtype == x.dtype and g.is_contiguous(),
            "layer_norm_bwd: g must be contiguous, of x's shape and dtype")
    n_param = weight.shape[0]
    w = _padded(weight, C).contiguous()
    dx = torch.empty_like(x)
    ctas = bwd_ctas(R)
    partial = torch.empty((2, ctas, C), dtype=torch.float32, device=x.device)
    dwb = torch.empty((2, C), dtype=torch.float32, device=x.device)
    if R == 0:
        return dx, torch.zeros(n_param, device=x.device), torch.zeros(n_param, device=x.device)
    BWD_KERNEL.launch(
        x.data_ptr(), g.data_ptr(), w.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        dwb[0].data_ptr(), dwb[1].data_ptr(), R, C, real_dim or C, ctas, float(eps),
        int(x.dtype == torch.bfloat16), K.stream(),
    )
    return dx, dwb[0, :n_param], dwb[1, :n_param]


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, real_dim):
        ctx.save_for_backward(x, weight)
        ctx.args = (eps, real_dim, bias.dtype)
        return layer_norm_fwd(x, weight, bias, eps, real_dim)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        eps, real_dim, bias_dtype = ctx.args
        dx, dw, db = layer_norm_bwd(x, g.contiguous(), weight, eps, real_dim)
        return dx, dw.to(weight.dtype), db.to(bias_dtype), None, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6, real_dim: Optional[int] = None) -> torch.Tensor:
    """LayerNorm over the last axis: K2 forward, K6 backward (plain versions
    on the CPU). weight/bias are (C,) or (real_dim,)."""
    return _LayerNorm.apply(x, weight, bias, eps, real_dim)
