"""Kernel K2: row LayerNorm over the last axis with f32 statistics.

Replaces the TPU kernel `diff_sal_tpu/ops/layernorm.py:134
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

MAX_C = 1024


def _padded(p: torch.Tensor, C: int) -> torch.Tensor:
    p = p.float()
    if p.shape[0] < C:
        p = torch.nn.functional.pad(p, (0, C - p.shape[0]))
    return p


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-6, real_dim: Optional[int] = None) -> torch.Tensor:
    """K2's plain version."""
    C = x.shape[-1]
    w, b = _padded(weight, C), _padded(bias, C)
    c_real = real_dim or C
    xf = x.float()
    mean = xf.sum(-1, keepdim=True) / c_real
    var = ((xf * xf).sum(-1, keepdim=True) / c_real - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if real_dim is not None and real_dim < C:
        lane = torch.arange(C, device=x.device)
        y = torch.where(lane < real_dim, y, torch.zeros((), device=x.device))
    return (y * w + b).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6, real_dim: Optional[int] = None) -> torch.Tensor:
    """LayerNorm over the last axis; kernel K2 on CUDA, the plain version
    on the CPU. weight/bias are (C,) or (real_dim,)."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, real_dim)
    K.require_cuda(x, "layer_norm")
    C = x.shape[-1]
    K.check(x.dtype in (torch.bfloat16, torch.float32), f"layer_norm dtype {x.dtype}")
    K.check(C <= MAX_C, f"layer_norm needs C <= {MAX_C}, got {C}")
    K.check(x.is_contiguous(), "layer_norm input must be contiguous")
    K.check(real_dim is None or 0 < real_dim <= C, f"real_dim {real_dim} vs C {C}")
    w = _padded(weight, C).contiguous()
    b = _padded(bias, C).contiguous()
    out = torch.empty_like(x)
    R = x.numel() // C
    if R == 0:
        return out
    KERNEL.launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), R, C, real_dim or C,
        float(eps), int(x.dtype == torch.bfloat16), K.stream(),
    )
    return out
