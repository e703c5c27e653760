"""Shared building blocks, channel-last (JAX package `models/layers.py`).

Parameters live in float32 under the reference's torch names; the
compute dtype `dt` (None = float32) is applied by explicit casts at each
product, mirroring flax's `dtype=` policy: inputs and weights are cast to
`dt`, the result stays in `dt`. Normalisation statistics are float32.

Train mode (`train=True` at the call, as flax's `deterministic=False` /
`use_running_average=False`): dropout and DropPath draw their masks from
an explicit `torch.Generator` (or take given masks), BatchNorm uses batch
statistics and updates its running ones as flax does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from diff_sal_tpu_torch.ops import layernorm as ln_ops
from diff_sal_tpu_torch.ops.kernels import acc_dtype
from diff_sal_tpu_torch.ops.mlp import gelu
from diff_sal_tpu_torch.ops.quant import QuantLinear
from diff_sal_tpu_torch.ops import resize as resize_ops
from diff_sal_tpu_torch.parallel import tensor as tp

Dtype = Optional[torch.dtype]
Pad = Union[int, Sequence[Tuple[int, int]]]


def uniform(shape, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """U[0, 1) of `shape` in f32 from `generator` (the default generator if
    None), on x's device."""
    dev = generator.device if generator is not None else x.device
    return torch.rand(shape, generator=generator, device=dev).to(x.device)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flax `nn.Dropout`: where(keep, x / (1 - rate), 0) with keep ~
    Bernoulli(1 - rate) per element (or the given boolean `keep`);
    identity at eval or rate 0."""
    if not train or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    if keep is None:
        keep = uniform(x.shape, x, generator) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, train: bool,
              generator: Optional[torch.Generator] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastic depth on the leading axis, timm semantics (JAX
    `layers.py:50-59`): mask = floor(keep + U) in x's dtype, x / keep *
    mask; `mask` replaces the draw when given. Identity at eval or rate 0."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.floor(keep + uniform(shape, x, generator).to(x.dtype))
    return x / keep * mask


def _dt(x: torch.Tensor, w: torch.Tensor, dt: Dtype) -> torch.dtype:
    # flax with dtype=None promotes input and (f32) parameter types
    return dt if dt is not None else torch.promote_types(x.dtype, w.dtype)


def dense(x: torch.Tensor, lin: nn.Linear, dt: Dtype = None) -> torch.Tensor:
    """flax Dense; a weight sharded on its output features (`parallel/
    tensor.py`) runs as a column-parallel product."""
    d = _dt(x, lin.weight, dt)
    b = None if lin.bias is None else lin.bias.to(d)
    if tp.is_sharded(lin.weight):
        return tp.column_parallel(x.to(d), lin.weight, b,
                                  lambda xi, w, bi: F.linear(xi, w.to(d), bi))
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


def _sharded_conv(conv, x: torch.Tensor, weight, bias: Optional[torch.Tensor],
                  groups: int) -> torch.Tensor:
    """`conv(x, w, b, groups)` with `weight` sharded on its output channels
    (`parallel/tensor.py`): column-parallel, or per channel where the conv
    is depthwise."""
    if groups == 1:
        return tp.column_parallel(x, weight, bias, lambda xi, w, bi: conv(xi, w, bi, 1))
    if groups == weight.shape[0] == x.shape[-1] and weight.shape[1] == 1:
        return tp.depthwise_parallel(x, weight, bias, conv)
    raise ValueError(f"a sharded grouped conv with groups={groups}: only depthwise convs "
                     "are split by channel")


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           dt: Dtype = None, stride=1, padding: Pad = 0, dilation=1,
           groups: int = 1) -> torch.Tensor:
    """Conv over a channel-last (N, H, W, C) input with a torch (O, I/g, kh,
    kw) weight; returns (N, H', W', O)."""
    d = _dt(x, weight, dt)
    pad, explicit = _pads(padding)

    def conv(xi, w, b, g):
        xc = xi.permute(0, 3, 1, 2)
        if explicit is not None:
            xc = F.pad(xc, explicit)
        y = F.conv2d(xc, w.to(d), None if b is None else b.to(d), stride, pad, dilation, g)
        return y.permute(0, 2, 3, 1)
    if tp.is_sharded(weight):
        return _sharded_conv(conv, x.to(d), weight, bias, groups)
    return conv(x.to(d), weight, bias, groups)


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

    def conv(xi, w, b, g):
        xc = xi.permute(0, 4, 1, 2, 3).contiguous()
        if explicit is not None:
            xc = F.pad(xc, explicit)
        y = F.conv3d(xc, w.to(d), None if b is None else b.to(d), stride, pad, 1, g)
        return y.permute(0, 2, 3, 4, 1)
    if tp.is_sharded(weight):
        return _sharded_conv(conv, x.to(d), weight, bias, groups)
    return conv(x.to(d), weight, bias, groups)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, freq_i = exp(-ln(10000) * i / (half - 1)),
    output [sin | cos] (reference sal_unet.py:15-33)."""
    half = dim // 2
    f = acc_dtype(t.dtype)
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=f, device=t.device) / (half - 1))
    args = t.to(f)[:, None] * freqs[None, :]
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
        xf = x.to(acc_dtype(x.dtype)).reshape(B, -1, self.num_groups, C // self.num_groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = xf.var(dim=(1, 3), unbiased=False, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight + self.bias).to(d)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm on channel-last input with torch's BatchNorm2d names and
    buffers, f32 math, output in `dt`. At eval it normalizes with the
    running statistics. With `train=True` it normalizes with the batch's
    mean and biased variance (E[x^2] - mean^2, clamped at 0, as flax's
    fast variance) and updates the running ones as flax does, ra = 0.9 ra
    + 0.1 batch, with the biased variance (torch's own update uses the
    unbiased one, so `F.batch_norm` is not used). `num_batches_tracked` is
    left as loaded.

    With a `stats_group` (set by `VideoSaliencyModel.set_stats_group`)
    the train-mode statistics are the global batch's: each rank's sums of
    x and x^2 and its count, in f32 or wider, are summed over the ranks by
    a differentiable all-reduce (`parallel/mesh.all_reduce_sum`), so every
    rank normalises as JAX's one program over the sharded batch does and
    updates the same running statistics. (`torch.nn.SyncBatchNorm` refuses
    CPU input and updates the running variance with the unbiased
    estimate.)"""

    MOMENTUM = 0.9  # flax's `momentum`: the weight of the running value

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps=eps)
        self.stats_group = None

    def forward(self, x: torch.Tensor, dt: Dtype = None, train: bool = False) -> torch.Tensor:
        xf = x.to(acc_dtype(x.dtype))
        if not train:
            a = self.weight * torch.rsqrt(self.running_var + self.eps)
            return ((xf - self.running_mean) * a + self.bias).to(dt or x.dtype)
        dims = tuple(range(x.ndim - 1))
        if self.stats_group is None:
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
        else:
            mean, var = self._global_stats(xf, dims)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(dt or x.dtype)

    def _global_stats(self, xf: torch.Tensor, dims):
        """(mean, biased variance) over every rank's rows of the batch."""
        from diff_sal_tpu_torch.parallel.mesh import all_reduce_sum

        C = xf.shape[-1]
        count = xf.new_full((1,), xf.numel() // C)
        sums = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]),
                              self.stats_group)
        mean = sums[:C] / sums[2 * C]
        var = (sums[C:2 * C] / sums[2 * C] - mean * mean).clamp_min(0.0)
        return mean, var


class Mlp(nn.Module):
    """fc1 -> GELU -> dropout -> fc2 -> dropout on the last axis (dropout
    only with `train=True`).

    quant: "none" | "w8" | "w8a8", eval-time int8 storage of the fc
    weights (`ops/quant.QuantLinear`, JAX `layers.py:73-100`); the layers
    keep their names fc1 / fc2, their state comes from
    `ops/quant.quantize_state_dict`, and they raise under train mode."""

    def __init__(self, dim: int, hidden: int, out: Optional[int] = None,
                 act: str = "tanh", dropout: float = 0.0, quant: str = "none"):
        super().__init__()
        if quant == "none":
            self.fc1 = nn.Linear(dim, hidden)
            self.fc2 = nn.Linear(hidden, out or dim)
        else:
            self.fc1 = QuantLinear(dim, hidden, quant)
            self.fc2 = QuantLinear(hidden, out or dim, quant)
        self.act = act
        self.dropout = dropout
        self.quant = quant

    def _fc(self, x: torch.Tensor, fc: nn.Module, dt: Dtype) -> torch.Tensor:
        return dense(x, fc, dt) if self.quant == "none" else fc(x, dt)

    def forward(self, x: torch.Tensor, dt: Dtype = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if train and self.quant != "none":
            raise ValueError(f"an Mlp with quant={self.quant!r} is eval-only")
        h = dropout(gelu(self._fc(x, self.fc1, dt), self.act), self.dropout, train, generator)
        return dropout(self._fc(h, self.fc2, dt), self.dropout, train, generator)


class ConvBNRelu(nn.Sequential):
    """3x3 conv + BatchNorm + ReLU (reference common_block.py:33-36; state
    dict keys `0.*` conv and `1.*` BN) over the decoder's multi-scale sum
    of `tasks` resized to `out_hw`, computed by kernel K4.

    At eval two lowerings of the same function fold BatchNorm's running
    statistics into the conv (JAX `layers.py:151-182`): a = scale *
    rsqrt(var + 1e-5), K' = K a, b' = (conv bias - mean) a + BN bias, and
    relu(conv_K'(sum_i resize(task_i)) + b'). `head_lowres` runs it as
    conv-at-low-res through kernel K9 and takes precedence; `fused_head`
    (a module field, which `Decoder` never sets, as in JAX) through kernel
    K8. Parameters are the same on every path."""

    def __init__(self, cin: int, cout: int, head_lowres: bool = False,
                 fused_head: bool = False):
        super().__init__(nn.Conv2d(cin, cout, 3, padding=1), BatchNorm(cout))
        self.head_lowres = head_lowres
        self.fused_head = fused_head

    def folded(self, dt: torch.dtype):
        """The eval-time (K' (3, 3, C, O) in `dt`, b' (O,) f32) of conv + BN."""
        conv, bn = self[0], self[1]
        f = acc_dtype(conv.weight.dtype)
        a = bn.weight.to(f) * torch.rsqrt(bn.running_var.to(f) + 1e-5)
        b = (conv.bias.to(f) - bn.running_mean.to(f)) * a + bn.bias.to(f)
        k = tp.full(conv.weight).to(f).permute(2, 3, 1, 0) * a
        return k.to(dt).contiguous(), b

    def forward(self, tasks, out_hw, dt: Dtype = None, train: bool = False):
        if not train and (self.head_lowres or self.fused_head):
            d = dt or tasks[0].dtype
            k, b = self.folded(d)
            head = (resize_ops.resize_sum_conv_relu_phase if self.head_lowres
                    else resize_ops.resize_sum_conv_relu)
            return head([t.to(d).contiguous() for t in tasks], out_hw, k, b)
        x = resize_ops.bilinear_resize_sum([t.contiguous() for t in tasks], out_hw)
        conv, bn = self[0], self[1]
        y = conv2d(x, conv.weight, conv.bias, dt, padding=1)
        return torch.relu(bn(y, dt, train))


class MLPHead(nn.Module):
    """1x1 conv + sigmoid in f32 (reference common_block.py:111-122)."""

    def __init__(self, cin: int, num_classes: int = 1):
        super().__init__()
        self.linear_pred = nn.Conv2d(cin, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, f = self.linear_pred, acc_dtype(x.dtype)
        return torch.sigmoid(conv2d(x.to(f), p.weight, p.bias, f))
