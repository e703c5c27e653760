"""Shared building blocks, channel-last (JAX package `models/layers.py`).

Parameters live in float32 under the reference's torch names; the
compute dtype `dt` (None = float32) is applied by explicit casts at each
product, mirroring flax's `dtype=` policy: inputs and weights are cast to
`dt`, the result stays in `dt`. Normalisation statistics are float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from diff_sal_tpu_torch.ops import layernorm as ln_ops
from diff_sal_tpu_torch.ops.mlp import gelu
from diff_sal_tpu_torch.ops import resize as resize_ops

Dtype = Optional[torch.dtype]
Pad = Union[int, Sequence[Tuple[int, int]]]


def _dt(x: torch.Tensor, w: torch.Tensor, dt: Dtype) -> torch.dtype:
    # flax with dtype=None promotes input and (f32) parameter types
    return dt if dt is not None else torch.promote_types(x.dtype, w.dtype)


def dense(x: torch.Tensor, lin: nn.Linear, dt: Dtype = None) -> torch.Tensor:
    d = _dt(x, lin.weight, dt)
    b = None if lin.bias is None else lin.bias.to(d)
    return F.linear(x.to(d), lin.weight.to(d), b)


def _pads(padding: Pad):
    """Symmetric padding for the conv itself, or explicit (lo, hi) pairs
    applied with F.pad first."""
    if isinstance(padding, int):
        return padding, None
    if all(isinstance(p, int) for p in padding):
        return tuple(padding), None
    pairs = [tuple(p) for p in padding]
    if all(lo == hi for lo, hi in pairs):
        return tuple(lo for lo, _ in pairs), None
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return 0, flat


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           dt: Dtype = None, stride=1, padding: Pad = 0, dilation=1,
           groups: int = 1) -> torch.Tensor:
    """Conv over a channel-last (N, H, W, C) input with a torch (O, I/g, kh,
    kw) weight; returns (N, H', W', O)."""
    d = _dt(x, weight, dt)
    pad, explicit = _pads(padding)
    xc = x.to(d).permute(0, 3, 1, 2)
    if explicit is not None:
        xc = F.pad(xc, explicit)
    y = F.conv2d(xc, weight.to(d), None if bias is None else bias.to(d),
                 stride, pad, dilation, groups)
    return y.permute(0, 2, 3, 1)


def conv3d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           dt: Dtype = None, stride=1, padding: Pad = 0,
           groups: int = 1) -> torch.Tensor:
    """Conv over a channel-last (N, T, H, W, C) input with a torch (O, I/g,
    kt, kh, kw) weight; returns (N, T', H', W', O). The input is copied to
    NCDHW first: on the H100, cuDNN runs a grouped (depthwise) conv3d on a
    channels-last view as one small kernel per group, far slower than on
    the contiguous copy (see PERF.md)."""
    d = _dt(x, weight, dt)
    pad, explicit = _pads(padding)
    xc = x.to(d).permute(0, 4, 1, 2, 3).contiguous()
    if explicit is not None:
        xc = F.pad(xc, explicit)
    y = F.conv3d(xc, weight.to(d), None if bias is None else bias.to(d),
                 stride, pad, 1, groups)
    return y.permute(0, 2, 3, 4, 1)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, freq_i = exp(-ln(10000) * i / (half - 1)),
    output [sin | cos] (reference sal_unet.py:15-33)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / (half - 1))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis through kernel K2 (`weight`/`bias`
    named as torch's nn.LayerNorm)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ln_ops.layer_norm(x.contiguous(), self.weight, self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32, eps 1e-6) on channel-last input, f32 statistics,
    output in the input dtype (flax nn.GroupNorm with dtype)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__(groups, channels, eps=eps)

    def forward(self, x: torch.Tensor, dt: Dtype = None) -> torch.Tensor:
        d = dt or x.dtype
        B, C = x.shape[0], x.shape[-1]
        xf = x.float().reshape(B, -1, self.num_groups, C // self.num_groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = xf.var(dim=(1, 3), unbiased=False, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight + self.bias).to(d)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm in eval mode (running statistics) on channel-last input;
    torch's BatchNorm2d names and buffers, f32 math, output in `dt`."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor, dt: Dtype = None) -> torch.Tensor:
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        y = (x.float() - self.running_mean) * a + self.bias
        return y.to(dt or x.dtype)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 on the last axis (dropout is identity at eval)."""

    def __init__(self, dim: int, hidden: int, out: Optional[int] = None,
                 act: str = "tanh"):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)
        self.act = act

    def forward(self, x: torch.Tensor, dt: Dtype = None) -> torch.Tensor:
        return dense(gelu(dense(x, self.fc1, dt), self.act), self.fc2, dt)


class ConvBNRelu(nn.Sequential):
    """3x3 conv + BatchNorm + ReLU (reference common_block.py:33-36; state
    dict keys `0.*` conv and `1.*` BN) over the decoder's multi-scale sum
    of `tasks` resized to `out_hw`, computed by kernel K4."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv2d(cin, cout, 3, padding=1), BatchNorm(cout))

    def forward(self, tasks, out_hw, dt: Dtype = None):
        x = resize_ops.bilinear_resize_sum([t.contiguous() for t in tasks], out_hw)
        conv, bn = self[0], self[1]
        y = conv2d(x, conv.weight, conv.bias, dt, padding=1)
        return torch.relu(bn(y, dt))


class MLPHead(nn.Module):
    """1x1 conv + sigmoid in f32 (reference common_block.py:111-122)."""

    def __init__(self, cin: int, num_classes: int = 1):
        super().__init__()
        self.linear_pred = nn.Conv2d(cin, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.linear_pred
        return torch.sigmoid(conv2d(x.float(), p.weight, p.bias, torch.float32))
