"""The DiffSal model in plain PyTorch, float32: the yardstick that decides
whether the port's outputs are correct, and the model whose operations the
benchmark counts.

Written from the published architecture (github.com/junwenxiong/diff_sal:
`models/mvit.py`, `models/vggish.py`, `models/audio_attention.py`,
`models/saliency_decoder/`) as the port lays it out: channel-last
tensors, the reference's parameter names, the same quirks (CvT attention
scaled by the full width, ReduceTemp keeping frames 0-4, the dead-frame
cut, the scrambled audio tokens). It imports nothing but torch and numpy:
every product is a plain matmul, einsum or convolution, every attention
materialises its scores.

`LOWP` stores every product's operands and its result in float8 at a
per-tensor scale (e4m3 forward, e5m2 for the gradients flowing back
through them), as a float8 program would keep them where a bf16 one
keeps bf16: the precision below the configurations' bf16, the control
that the comparison has to fail.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LOWP = {"on": False}
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    s = top / t.abs().amax().clamp_min(1e-30)
    return (t * s).to(dtype).to(t.dtype) / s


class _Fp8(torch.autograd.Function):
    """Forward in float8 e4m3, gradient in float8 e5m2, each at a
    per-tensor scale: the usual recipe of float8 training."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


def lowp(t: torch.Tensor) -> torch.Tensor:
    """An operand or a result of a product: itself, or in float8 when the
    control is on."""
    if not LOWP["on"] or not t.is_floating_point():
        return t
    return _Fp8.apply(t)


def ns(d) -> SimpleNamespace:
    """A configuration dict (the `model` block of a configs/ file) as
    attributes, recursively."""
    if isinstance(d, dict):
        return SimpleNamespace(**{k: ns(v) for k, v in d.items()})
    return d


# -- building blocks -------------------------------------------------------

def uniform(shape, x: torch.Tensor, generator) -> torch.Tensor:
    dev = generator.device if generator is not None else x.device
    return torch.rand(shape, generator=generator, device=dev).to(x.device)


def dropout(x, rate, train, generator=None):
    if not train or rate == 0.0:
        return x
    keep = uniform(x.shape, x, generator) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x, rate, train, generator=None, mask_dtype=torch.float32):
    """Stochastic depth per row: mask = floor(keep + U) with U and the sum
    in `mask_dtype`, the configuration's compute dtype (timm's rule takes
    it in the activations' dtype, and so do the port and the JAX package):
    a U within that dtype's rounding of 1 - keep keeps or drops its row by
    the rounding, so the reference decides as the configuration does."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.floor(keep + uniform(shape, x, generator).to(mask_dtype))
    return x / keep * mask.to(x.dtype)


def dense(x, lin: nn.Linear):
    return lowp(F.linear(lowp(x), lowp(lin.weight), lin.bias))


def _pads(padding):
    if isinstance(padding, int):
        return padding, None
    pairs = [tuple(p) if not isinstance(p, int) else (p, p) for p in padding]
    if all(lo == hi for lo, hi in pairs):
        return tuple(lo for lo, _ in pairs), None
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return 0, flat


def conv2d(x, weight, bias, stride=1, padding=0, dilation=1, groups=1):
    """(N, H, W, C) input, torch (O, I/g, kh, kw) weight."""
    pad, explicit = _pads(padding)
    xc = x.permute(0, 3, 1, 2)
    if explicit is not None:
        xc = F.pad(xc, explicit)
    return lowp(F.conv2d(lowp(xc), lowp(weight), bias, stride, pad, dilation, groups)).permute(
        0, 2, 3, 1)


def conv3d(x, weight, bias, stride=1, padding=0, groups=1):
    """(N, T, H, W, C) input, torch (O, I/g, kt, kh, kw) weight."""
    pad, _ = _pads(padding)
    xc = x.permute(0, 4, 1, 2, 3)
    y = lowp(F.conv3d(lowp(xc), lowp(weight), bias, stride, pad, 1, groups))
    return y.permute(0, 2, 3, 4, 1)


def gelu(h, mode):
    return F.gelu(h, approximate="tanh") if mode == "tanh" else F.gelu(h)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis (`weight`, `bias` as torch names them)."""

    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class GroupNorm(nn.GroupNorm):
    def __init__(self, channels, groups=32, eps=1e-6):
        super().__init__(groups, channels, eps=eps)

    def forward(self, x):
        B, C = x.shape[0], x.shape[-1]
        xg = x.reshape(B, -1, self.num_groups, C // self.num_groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight + self.bias


class BatchNorm(nn.BatchNorm2d):
    """Channel-last BatchNorm: running statistics at eval; in training the
    batch's mean and biased variance, the running ones updated as flax
    does (0.9 old + 0.1 batch, biased variance)."""

    def __init__(self, channels, eps=1e-5):
        super().__init__(channels, eps=eps)

    def forward(self, x, train=False):
        if not train:
            return (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps) \
                * self.weight + self.bias
        dims = tuple(range(x.ndim - 1))
        mean = x.mean(dims)
        var = ((x - mean) ** 2).mean(dims)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class Mlp(nn.Module):
    def __init__(self, dim, hidden, act="tanh", rate=0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.act, self.rate = act, rate

    def forward(self, x, train=False, generator=None):
        h = dropout(gelu(dense(x, self.fc1), self.act), self.rate, train, generator)
        return dropout(dense(h, self.fc2), self.rate, train, generator)


def interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) bilinear weights, half-pixel centres, edges clamped."""
    coords = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    coords = np.clip(coords, 0.0, in_size - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = coords - lo
    w = np.zeros((out_size, in_size), dtype=np.float32)
    w[np.arange(out_size), lo] += (1.0 - frac).astype(np.float32)
    w[np.arange(out_size), hi] += frac.astype(np.float32)
    return w


def bilinear_resize(x, out_hw):
    """(..., H, W, C) -> (..., H', W', C)."""
    oh, ow = out_hw
    lead = x.shape[:-3]
    h, w = x.shape[-3], x.shape[-2]
    y = x.reshape((-1,) + tuple(x.shape[-3:]))
    if h != oh:
        y = torch.einsum("oh,bhwc->bowc", torch.from_numpy(interp_matrix(h, oh)).to(x), y)
    if w != ow:
        y = torch.einsum("ow,bhwc->bhoc", torch.from_numpy(interp_matrix(w, ow)).to(x), y)
    return y.reshape(tuple(lead) + (oh, ow, x.shape[-1]))


# -- MViTv2 ------------------------------------------------------------------

def _pool_out(size, stride):
    return tuple((n - 1) // s + 1 for n, s in zip(size, stride))


def block_plan(c):
    """Per-block widths, heads, strides, grids and rel-pos table lengths
    (reference mvit.py:1016-1066, with its persistent kv-stride halving)."""
    down = set(c.downscale_indices)
    stage_of = {i - 1: s for s, i in enumerate(c.downscale_indices)}
    stage_of[c.num_layers - 1] = len(c.downscale_indices)
    rel_hw = c.rel_pos_spatial_size // 4
    dims, heads = c.embed_dims, c.num_heads
    skv = list(c.adaptive_kv_stride)
    size = (c.temporal_size // 2, c.spatial_size[0] // 4, c.spatial_size[1] // 4)
    plans = []
    for i in range(c.num_layers):
        if i in down:
            heads *= c.head_mul
            sq = (1, 2, 2)
            skv = [max(s // 2, 1) for s in skv]
        else:
            sq = (1, 1, 1)
        out = dims * c.dim_mul if i in down else dims
        rel_dim = 2 * max(rel_hw // sq[1], rel_hw // skv[1]) - 1
        plans.append(dict(in_dims=dims, out_dims=out, heads=heads, stride_q=sq,
                          stride_kv=tuple(skv), rel_dims=(2 * (c.temporal_size // 2) - 1, rel_dim),
                          emit=stage_of.get(i)))
        size = _pool_out(size, sq)
        rel_hw //= sq[1]
        dims = out
    return plans


def rel_table(rel_pos, q_size, k_size):
    """(q, k, C) table from a learned (L, C) one, resized linearly when its
    length differs (reference mvit.py:359-366)."""
    L = int(2 * max(q_size, k_size) - 1)
    table = rel_pos
    if table.shape[0] != L:
        table = torch.from_numpy(interp_matrix(table.shape[0], L)).to(table) @ table
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    rel = (np.arange(q_size)[:, None] * q_ratio - np.arange(k_size)[None, :] * k_ratio
           + (k_size - 1) * k_ratio).astype(np.int64)
    return table[torch.from_numpy(rel).to(table.device)]


class MultiScaleAttention(nn.Module):
    def __init__(self, p, c):
        super().__init__()
        self.heads = p["heads"]
        self.out_dims = p["out_dims"]
        self.hd = hd = p["out_dims"] // p["heads"]
        self.stride_q, self.stride_kv = p["stride_q"], p["stride_kv"]
        self.kernel = tuple(c.pool_kernel)
        self.residual = c.residual_pooling
        self.qkv = nn.Linear(p["in_dims"], 3 * p["out_dims"], bias=c.qkv_bias)
        self.proj = nn.Linear(p["out_dims"], p["out_dims"])
        for part in "qkv":
            setattr(self, f"pool_{part}", nn.Conv3d(hd, hd, self.kernel, groups=hd, bias=False))
            setattr(self, f"norm_{part}", LayerNorm(hd))
        self.rel_pos_t = nn.Parameter(torch.zeros(p["rel_dims"][0], hd))
        self.rel_pos_h = nn.Parameter(torch.zeros(p["rel_dims"][1], hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(p["rel_dims"][1], hd))

    def _pool(self, x, part, stride):
        """Depthwise (3,3,3) pool of (B, T, H, W, heads*hd), one kernel
        shared by the heads."""
        w = getattr(self, f"pool_{part}").weight.repeat(self.heads, 1, 1, 1, 1)
        return conv3d(x, w, None, stride=stride, padding=tuple(k // 2 for k in self.kernel),
                      groups=w.shape[0])

    def _norm(self, t, part):
        B, L, _ = t.shape
        y = getattr(self, f"norm_{part}")(t.reshape(B, L, self.heads, self.hd))
        return y.reshape(B, L, -1)

    def forward(self, sp, cls, size):
        B = sp.shape[0]
        C, H, hd = self.out_dims, self.heads, self.hd
        T, Hh, Ww = size
        qkv = dense(sp, self.qkv).reshape(B, T, Hh, Ww, 3 * C)
        q_sp = self._pool(qkv[..., :C], "q", self.stride_q)
        k_sp = self._pool(qkv[..., C:2 * C], "k", self.stride_kv)
        v_sp = self._pool(qkv[..., 2 * C:], "v", self.stride_kv)
        q_shape, k_shape = tuple(q_sp.shape[1:4]), tuple(k_sp.shape[1:4])
        cq, ck, cv = dense(cls, self.qkv).split(C, dim=-1)
        q = self._norm(torch.cat([cq, q_sp.reshape(B, -1, C)], 1), "q")
        k = self._norm(torch.cat([ck, k_sp.reshape(B, -1, C)], 1), "k")
        v = self._norm(torch.cat([cv, v_sp.reshape(B, -1, C)], 1), "v")
        qh, kh, vh = (t.reshape(B, t.shape[1], H, hd).transpose(1, 2) for t in (q, k, v))
        scores = lowp(torch.matmul(lowp(qh * hd ** -0.5), lowp(kh.transpose(-1, -2))))
        # decomposed rel-pos bias on the spatial queries and keys: none on
        # the cls row or the cls column
        qt, qhh, qw = q_shape
        kt, khh, kw = k_shape
        r_q = lowp(qh[:, :, 1:].reshape(B, H, qt, qhh, qw, hd))
        rt = lowp(torch.einsum("bythwc,tkc->bythwk", r_q, lowp(rel_table(self.rel_pos_t, qt, kt))))
        rh = lowp(torch.einsum("bythwc,hkc->bythwk", r_q, lowp(rel_table(self.rel_pos_h, qhh, khh))))
        rw = lowp(torch.einsum("bythwc,wkc->bythwk", r_q, lowp(rel_table(self.rel_pos_w, qw, kw))))
        bias = (rt[..., :, None, None] + rh[..., None, :, None]
                + rw[..., None, None, :]).reshape(B, H, qt * qhh * qw, kt * khh * kw)
        bias = F.pad(F.pad(bias, (1, 0)), (0, 0, 1, 0))
        probs = torch.softmax(scores + bias, dim=-1)
        out = lowp(torch.matmul(lowp(probs), lowp(vh)))
        if self.residual:  # every spatial query row, not the cls row
            out = out + F.pad(qh[:, :, 1:], (0, 0, 1, 0))
        out = out.transpose(1, 2).reshape(B, -1, C)
        return dense(out[:, 1:], self.proj), dense(out[:, :1], self.proj), q_shape


class MultiScaleBlock(nn.Module):
    def __init__(self, p, c):
        super().__init__()
        self.stride_q = p["stride_q"]
        self.norm1 = LayerNorm(p["in_dims"])
        self.attn = MultiScaleAttention(p, c)
        self.norm2 = LayerNorm(p["out_dims"])
        self.mlp = Mlp(p["out_dims"], int(p["out_dims"] * c.mlp_ratio), c.gelu)
        self.proj = nn.Linear(p["in_dims"], p["out_dims"]) if p["in_dims"] != p["out_dims"] else None

    def forward(self, sp, cls, size):
        B = sp.shape[0]
        sp_n, cls_n = self.norm1(sp), self.norm1(cls)
        a_sp, a_cls, out_size = self.attn(sp_n, cls_n, size)
        skip = sp if self.proj is None else dense(sp_n, self.proj)
        if any(s > 1 for s in self.stride_q):
            kernel = tuple(s + 1 if s > 1 else s for s in self.stride_q)
            x5 = skip.reshape((B,) + tuple(size) + (-1,)).permute(0, 4, 1, 2, 3)
            x5 = F.max_pool3d(x5, kernel, self.stride_q, tuple(k // 2 for k in kernel))
            skip = x5.permute(0, 2, 3, 4, 1).reshape(B, -1, x5.shape[1])
        sp = skip + a_sp
        cls = (cls if self.proj is None else dense(cls_n, self.proj)) + a_cls
        return sp + self.mlp(self.norm2(sp)), cls + self.mlp(self.norm2(cls)), out_size


class PatchEmbed3D(nn.Module):
    def __init__(self, cin, dims):
        super().__init__()
        self.projection = nn.Conv3d(cin, dims, (3, 7, 7), (2, 4, 4), (1, 3, 3))

    def forward(self, x):
        p = self.projection
        y = conv3d(x, p.weight, p.bias, stride=p.stride, padding=p.padding)
        return y.reshape(y.shape[0], -1, y.shape[-1]), tuple(y.shape[1:4])


class MViT(nn.Module):
    """MViTv2 with its cls token, returning the coarse-first 4-scale pyramid.
    `remat` recomputes each block in the backward (the same function; no
    block draws random numbers)."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.plans = block_plan(c)
        self.remat = False
        self.patch_embed = PatchEmbed3D(c.in_channels, c.embed_dims)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.embed_dims))
        self.blocks = nn.ModuleList([MultiScaleBlock(p, c) for p in self.plans])
        for p in self.plans:
            if p["emit"] is not None and p["emit"] in c.out_scales:
                self.add_module(f"norm{p['emit']}", LayerNorm(p["out_dims"]))

    def forward(self, x):
        B = x.shape[0]
        sp, size = self.patch_embed(x)
        cls = self.cls_token.expand(B, 1, -1)
        outs = []
        for blk, p in zip(self.blocks, self.plans):
            if self.remat and torch.is_grad_enabled():
                sp, cls, _ = checkpoint(blk, sp, cls, size, use_reentrant=False)
            else:
                sp, cls, _ = blk(sp, cls, size)
            size = _pool_out(size, p["stride_q"])
            if p["emit"] is not None and p["emit"] in self.c.out_scales:
                outs.append(getattr(self, f"norm{p['emit']}")(sp).reshape((B,) + size + (-1,)))
        return outs[::-1]


# -- audio: VGGish trunk and AudioAttnNet -------------------------------------

class VGGish(nn.Module):
    def __init__(self, c):
        super().__init__()
        layers, cin = [], c.in_channels
        for v in c.layers:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, int(v), 3, padding=1), nn.ReLU()]
                cin = int(v)
        self.features = nn.Sequential(*layers)

    @torch.no_grad()
    def forward_feat(self, x):
        for layer in self.features:
            if isinstance(layer, nn.Conv2d):
                x = torch.relu(conv2d(x, layer.weight, layer.bias, padding=1))
            elif isinstance(layer, nn.MaxPool2d):
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return x


class TokenAttention(nn.Module):
    def __init__(self, dim, heads, dim_head, rate):
        super().__init__()
        self.heads, self.dim_head, self.rate = heads, dim_head, rate
        inner = heads * dim_head
        self.norm = LayerNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(0.0))

    def forward(self, x, train=False, generator=None):
        B, N, _ = x.shape
        q, k, v = dense(self.norm(x), self.to_qkv).reshape(
            B, N, 3, self.heads, self.dim_head).unbind(2)
        a = lowp(torch.einsum("bnhd,bmhd->bhnm", lowp(q), lowp(k))) * self.dim_head ** -0.5
        a = dropout(torch.softmax(a, dim=-1), self.rate, train, generator)
        out = lowp(torch.einsum("bhnm,bmhd->bnhd", lowp(a), lowp(v))).reshape(B, N, -1)
        return dropout(dense(out, self.to_out[0]), self.rate, train, generator)


class TokenFeedForward(nn.Module):
    def __init__(self, dim, hidden, rate):
        super().__init__()
        self.rate = rate
        self.net = nn.Sequential(LayerNorm(dim), nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Dropout(0.0), nn.Linear(hidden, dim), nn.Dropout(0.0))

    def forward(self, x, train=False, generator=None):
        h = dropout(gelu(dense(self.net[0](x), self.net[1]), "exact"), self.rate, train, generator)
        return dropout(dense(h, self.net[4]), self.rate, train, generator)


class AudioAttnNet(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList([
            nn.ModuleList([TokenAttention(c.dim, c.heads, c.dim_head, c.dropout),
                           TokenFeedForward(c.dim, c.mlp_dim, c.dropout)])
            for _ in range(c.depth)])
        self.transformer.norm = LayerNorm(c.dim)

    def forward(self, x, train=False, generator=None):
        B, T, H, W, C = x.shape
        tok = x.reshape(B, T * H * W, C)
        for attn, ff in self.transformer.layers:
            tok = attn(tok, train, generator) + tok
            tok = ff(tok, train, generator) + tok
        return self.transformer.norm(tok).reshape(B, T, H, W, C)


# -- SalUNet decoder -----------------------------------------------------------

def timestep_embedding(t, dim):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / (half - 1))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


class TimestepMLP(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.ch = ch
        self.dense = nn.ModuleList([nn.Linear(ch, 4 * ch), nn.Linear(4 * ch, 4 * ch)])

    def forward(self, t):
        return dense(F.silu(dense(timestep_embedding(t, self.ch), self.dense[0])), self.dense[1])


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, temb_ch, rate):
        super().__init__()
        self.rate = rate
        self.norm1 = GroupNorm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.temb_proj = nn.Linear(temb_ch, cout)
        self.norm2 = GroupNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb, train=False, generator=None):
        h = conv2d(F.silu(self.norm1(x)), self.conv1.weight, self.conv1.bias, padding=1)
        h = h + dense(F.silu(temb), self.temb_proj)[:, None, None, :]
        h = dropout(F.silu(self.norm2(h)), self.rate, train, generator)
        h = conv2d(h, self.conv2.weight, self.conv2.bias, padding=1)
        if self.nin_shortcut is not None:
            x = conv2d(x, self.nin_shortcut.weight, self.nin_shortcut.bias)
        return x + h


class Downsample(nn.Module):
    """3x3 conv at stride s after the DDPM pad of one row and column at the
    bottom and right."""

    def __init__(self, ch, stride=2):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride)

    def forward(self, x):
        c = self.conv
        return conv2d(x, c.weight, c.bias, stride=c.stride, padding=((0, 1), (0, 1)))


class _ResDown(nn.ModuleList):
    def __init__(self, cin, cout, temb_ch, rate):
        super().__init__([ResnetBlock(cin, cout, temb_ch, rate), Downsample(cout)])


class CvTAttention(nn.Module):
    class _ConvProj(nn.Module):
        def __init__(self, C, kt, k):
            super().__init__()
            self.conv = nn.Conv3d(C, C, (kt, k, k), groups=C, bias=False)
            self.bn = LayerNorm(C)

    def __init__(self, C, heads, kernel_kv, stride_kv):
        super().__init__()
        self.heads, self.stride_kv = heads, stride_kv
        self.conv_proj_q = self._ConvProj(C, 3, 3)
        self.conv_proj_k = self._ConvProj(C, 1, kernel_kv)
        self.conv_proj_v = self._ConvProj(C, 1, kernel_kv)
        self.proj_q, self.proj_k = nn.Linear(C, C), nn.Linear(C, C)
        self.proj_v, self.proj = nn.Linear(C, C), nn.Linear(C, C)

    def _tokens(self, x, cp, stride, padding):
        w = cp.conv.weight
        y = conv2d(x, w[:, :, w.shape[2] // 2], None, stride=stride, padding=padding,
                   groups=w.shape[0])  # a T=1 grid: the centre temporal slice
        return cp.bn(y.reshape(y.shape[0], -1, y.shape[-1]))

    def forward(self, tokens, hw, audio_tokens=None):
        H, W = hw
        Bt, _, C = tokens.shape
        x = tokens.reshape(Bt, H, W, C)
        q = dense(self._tokens(x, self.conv_proj_q, 1, 1), self.proj_q)
        src = audio_tokens.reshape(Bt, H, W, C) if audio_tokens is not None else x
        k = dense(self._tokens(src, self.conv_proj_k, self.stride_kv, 0), self.proj_k)
        v = dense(self._tokens(x, self.conv_proj_v, self.stride_kv, 0), self.proj_v)
        nh, hd = self.heads, C // self.heads
        a = lowp(torch.einsum("blhd,bthd->bhlt", lowp(q.reshape(Bt, -1, nh, hd)),
                              lowp(k.reshape(Bt, -1, nh, hd)))) * C ** -0.5  # the full width
        a = torch.softmax(a, dim=-1)
        out = lowp(torch.einsum("bhlt,bthd->blhd", lowp(a), lowp(v.reshape(Bt, -1, nh, hd))))
        return dense(out.reshape(Bt, -1, C), self.proj)


class TransformerBlock(nn.Module):
    def __init__(self, C, heads, mlp_ratio, kernel_kv, stride_kv, audio_dim, act, dp_rate,
                 mask_dtype):
        super().__init__()
        self.dp_rate, self.mask_dtype = dp_rate, mask_dtype
        self.align_conv = nn.Conv2d(audio_dim, C, 1) if audio_dim else None
        self.norm = LayerNorm(C)
        self.attn = CvTAttention(C, heads, kernel_kv, stride_kv)
        self.norm2 = LayerNorm(C)
        self.mlp = Mlp(C, int(C * mlp_ratio), act)

    def forward(self, x, audio, keep, train=False, generator=None):
        B, T, H, W, C = x.shape
        audio_tokens = None
        if audio is not None:
            audio = audio[:, :T]
            ac = conv2d(audio.reshape((-1,) + tuple(audio.shape[2:])), self.align_conv.weight,
                        self.align_conv.bias).reshape(audio.shape[:4] + (C,))
            ha, wa = ac.shape[2], ac.shape[3]
            if ha != H and wa != W:
                f = H // ha
                ac = ac.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)
            gate = torch.softmax((ac * x).mean(dim=1, keepdim=True), dim=3)
            # torch's (b, c, t, h, w).view(b*t, h*w, c) of the gated audio
            audio_tokens = (ac * gate).permute(0, 4, 1, 2, 3).reshape(B * T, H * W, C)
        if keep is not None and keep < T:
            T = keep
            x = x[:, :T]
            if audio_tokens is not None:
                audio_tokens = audio_tokens.reshape(B, -1, H * W, C)[:, :T].reshape(-1, H * W, C)
        tok = x.reshape(B * T, H * W, C)
        tok = self.attn(self.norm(tok), (H, W), audio_tokens) + tok
        h = self.mlp(self.norm2(tok), train, generator)
        tok = tok + drop_path(h, self.dp_rate, train, generator, self.mask_dtype)
        return tok.reshape(B, T, H, W, C)


class UpEmbed(nn.Module):
    def __init__(self, cin, C, k=3, dilation=2):
        super().__init__()
        self.dilation = dilation
        self.proj = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="bilinear"),
            nn.Conv2d(cin, C, k, padding=dilation, dilation=dilation, bias=False),
            BatchNorm(C), nn.ReLU(),
            nn.Conv2d(C, C, k, padding=dilation, dilation=dilation, bias=False),
            BatchNorm(C), nn.ReLU())

    def forward(self, x, train=False):
        B, T, H, W, C = x.shape
        f = bilinear_resize(x.reshape(B * T, H, W, C), (2 * H, 2 * W))
        for ci, bi in ((1, 2), (4, 5)):
            f = conv2d(f, self.proj[ci].weight, None, padding=self.dilation,
                       dilation=self.dilation)
            f = torch.relu(self.proj[bi](f, train))
        return f.reshape(B, T, 2 * H, 2 * W, -1)


class ReduceTemp(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv3d(cin, cout, (k, 1, 1), (k, 1, 1), bias=False),
                                  nn.ReLU())

    def forward(self, x):
        c = self.proj[0]
        return torch.relu(conv3d(x, c.weight, None, stride=c.stride))


class TransformerStage(nn.Module):
    def __init__(self, i, c, with_audio, mask_dtype):
        super().__init__()
        self.i = i
        C = c.up_channel[i]
        self.patch_embed = (nn.ModuleList([UpEmbed(c.up_channel[i - 1], C)])
                            if c.patch_size[i] > 0 else None)
        self.blocks = nn.ModuleList([TransformerBlock(
            C, c.num_heads[i], c.mlp_ratio[i], c.kernel_kv[i], c.stride_kv[i],
            c.audio_dim if with_audio else None, c.gelu, c.drop_path_rate[i], mask_dtype)])

    def forward(self, x, back, audio, keep, train=False, generator=None):
        if self.patch_embed is not None:
            x = self.patch_embed[0](x, train)
            if self.i in (1, 2):  # backbone skips at stages 1 and 2 only
                x = x + back[self.i][:, :x.shape[1]]
        return self.blocks[0](x, audio, keep, train, generator)


class ConvBNRelu(nn.Sequential):
    def __init__(self, cin, cout):
        super().__init__(nn.Conv2d(cin, cout, 3, padding=1), BatchNorm(cout))

    def forward(self, tasks, out_hw, train=False):
        x = sum(bilinear_resize(t, out_hw) for t in tasks)
        y = conv2d(x, self[0].weight, self[0].bias, padding=1)
        return torch.relu(self[1](y, train))


class Decoder(nn.Module):
    def __init__(self, c, with_audio, mask_dtype):
        super().__init__()
        self.c = c
        n = c.mid_num_stages
        self.mid_stages = nn.ModuleList([TransformerStage(i, c, with_audio, mask_dtype)
                                         for i in range(n)])
        self.norm_mts = nn.ModuleList([LayerNorm(c.up_channel[i]) for i in range(n)])
        self.redu_chan_up = nn.ModuleList([
            ReduceTemp(c.up_channel[i], c.ori_embed_dim, c.temporal_list[i]) for i in range(n)])
        self.mt_proj = ConvBNRelu(c.ori_embed_dim, c.down_embed_dim)

    def keep(self, i, train):
        """Frames kept at stage i: the last stage's cut is exact (ReduceTemp
        reads frames 0-4 only); the every-stage cut as configured."""
        c = self.c
        every = c.skip_dead_frames_all and (not train or c.skip_dead_frames_train)
        if c.skip_dead_frames and (i == c.mid_num_stages - 1 or every):
            return c.temporal_list[i]
        return None

    def forward(self, back, audio, train=False, generator=None):
        x = back[0]
        n = self.c.mid_num_stages
        out_hw = (x.shape[2] * 2 ** n, x.shape[3] * 2 ** n)
        tasks = []
        for i in range(n):
            x = self.mid_stages[i](x, back, audio, self.keep(i, train), train, generator)
            tasks.append(self.redu_chan_up[i](self.norm_mts[i](x))[:, 0])
        return self.mt_proj(tasks, out_hw, train)


class MLPHead(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.linear_pred = nn.Conv2d(cin, 1, 1)

    def forward(self, x):
        return torch.sigmoid(conv2d(x, self.linear_pred.weight, self.linear_pred.bias))


class SalUNet(nn.Module):
    def __init__(self, c, with_audio, mask_dtype=torch.float32):
        super().__init__()
        self.c = c
        ch = c.noise_ch
        self.temb = TimestepMLP(ch)
        self.conv_in = nn.Conv2d(1, ch, 3, padding=1)
        self.down1 = Downsample(ch, stride=4)
        chans = [ch] + list(reversed(c.up_channel[:-1]))
        self.res_encoder = nn.ModuleList([_ResDown(chans[i], chans[i + 1], 4 * ch, c.dropout)
                                          for i in range(len(chans) - 1)])
        self.invpt_decoder = Decoder(c, with_audio, mask_dtype)
        self.logits = MLPHead(c.down_embed_dim)

    def forward(self, x, t, feats, audio=None, train=False, generator=None):
        temb = self.temb(t)
        h = self.down1(conv2d(x, self.conv_in.weight, self.conv_in.bias, padding=1))
        noisy = []
        for res, down in self.res_encoder:
            h = down(res(h, temb, train, generator))
            noisy.append(h[:, None])
        noisy = noisy[::-1]
        feats = list(feats)
        if self.c.image_based:
            for i in range(min(len(noisy), len(feats))):
                if feats[i].shape[2:4] == noisy[i].shape[2:4]:
                    feats[i] = torch.cat([feats[i], noisy[i]], dim=1)
        pred = self.logits(self.invpt_decoder(feats, audio, train, generator))
        return bilinear_resize(pred, tuple(self.c.img_size))


class DiffSal(nn.Module):
    """MViT + (frozen VGGish + AudioAttnNet) + SalUNet, with the port's
    entry points: `encode_visual`, `encode_audio`, `denoise`, `forward`."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.visual_net = MViT(c.visual)
        self.audio_net = VGGish(c.audio).requires_grad_(False) if c.audio else None
        self.spatiotemp_net = AudioAttnNet(c.spatiotemp) if c.spatiotemp else None
        self.decoder_net = SalUNet(c.decoder, c.audio is not None, getattr(torch, c.compute_dtype))

    def encode_visual(self, rgb) -> List[torch.Tensor]:
        return self.visual_net(rgb)

    def encode_audio(self, audio, train=False, generator=None):
        B, Ta = audio.shape[:2]
        feat = self.audio_net.forward_feat(audio.reshape((B * Ta,) + tuple(audio.shape[2:])))
        feat = feat.reshape((B, Ta) + tuple(feat.shape[1:]))
        return self.spatiotemp_net(feat, train, generator)

    def denoise(self, x, t, feats: Sequence[torch.Tensor], audio=None, train=False,
                generator=None):
        return self.decoder_net(x, t, feats, audio, train, generator)

    def forward(self, rgb, x_t, t, audio=None, train=False, generator=None):
        audio_feat = None
        if self.audio_net is not None and audio is not None:
            audio_feat = self.encode_audio(audio, train, generator)
        return self.denoise(x_t, t, self.encode_visual(rgb), audio_feat, train, generator)


def norm_scales(model: nn.Module) -> List[str]:
    """Names of the normalisation layers' scales (drawn around 1)."""
    kinds = (LayerNorm, nn.GroupNorm, nn.BatchNorm2d)
    return [f"{n}.weight" if n else "weight" for n, m in model.named_modules()
            if isinstance(m, kinds)]


def build(model_cfg: dict, device="cpu") -> DiffSal:
    """The reference model of a configuration's `model` block, its
    parameters uninitialised until a state dict is loaded."""
    with torch.device(device):
        return DiffSal(ns(model_cfg))
