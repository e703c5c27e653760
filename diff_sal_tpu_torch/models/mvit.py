"""MViTv2 video encoder (JAX package `models/mvit.py`; reference
`models/mvit.py:795-1152`).

3D patch embed (k=(3,7,7), s=(2,4,4)), pooled multi-head attention with
decomposed (T, H, W) rel-pos and residual pooling, channel/head doubling
and 2x query pooling at the downscale blocks, and the coarse-first
4-scale pyramid. The cls token rides a separate (B, 1, C) stream between
blocks. With `cls_stream` (the default) the spatial query rows go through
kernel K1 (`ops/attention.py`) and the single cls query row attends in
plain torch (as at JAX `mvit.py:1122-1131`); with `cls_stream=False` the
attention runs on JAX's token-concat layout (`mvit.py:807-837`), cls at
row 0 of every head, through kernel K12. Both layouts compute one
function with one parameter tree. Every LayerNorm runs through kernel K2;
with `pool_mode="pallas"` (and `cls_stream`, as in JAX) the depthwise
attention pools run through kernel K11 (`ops/pool.py`) on the qkv columns
in place, else through cuDNN's grouped conv3d. With `mlp_quant` ("w8" /
"w8a8", eval only) every block's MLP holds int8 weights
(`ops/quant.QuantLinear`) and takes the cls rows with the spatial rows in
one product. With `remat`, each block's forward runs again in the
backward pass (`torch.utils.checkpoint`, JAX's `nn.remat`,
mvit.py:1550), so a training step saves only the blocks' inputs and
launches MViT's forward kernels twice. Parameter names are the
reference's (`patch_embed.projection`, `cls_token`, `blocks.{i}.*`,
`norm{s}`).

Shapes for rgb (B, 16, 224, 384, 3):
  tokens (B, 8*56*96, 96) + cls (B, 1, 96)
  pyramid [(B,8,7,12,768), (B,8,14,24,384), (B,8,28,48,192), (B,8,56,96,96)]
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from diff_sal_tpu_torch.config import MViTConfig
from diff_sal_tpu_torch.models.layers import (Dtype, FusedLayerNorm, Mlp, conv3d,
                                              dense)
from diff_sal_tpu_torch.ops import attention as attn_ops
from diff_sal_tpu_torch.ops import layernorm as ln_ops
from diff_sal_tpu_torch.ops import pool as pool_ops
from diff_sal_tpu_torch.ops.kernels import acc_dtype
from diff_sal_tpu_torch.ops.quant import QUANT_MODES
from diff_sal_tpu_torch.ops.rel_pos import rel_pos_parts, rel_pos_terms


# "stencil" is JAX's shifted-multiply-add lowering of the conv's function
POOL_MODES = ("conv", "stencil", "pallas")


def _pool_out_size(size, stride):
    # conv kernel 3, pad 1, stride s
    return tuple((n - 1) // s + 1 for n, s in zip(size, stride))


def block_plan(cfg: MViTConfig):
    """Per-block dims, heads, strides, token grids, rel-pos table sizes and
    emitted scale (JAX `_block_plan`, mvit.py:1446, mirroring reference
    mvit.py:1016-1066 with its persistent kv-stride halving)."""
    downscale = set(cfg.downscale_indices)
    stage_of_block = {i - 1: s for s, i in enumerate(cfg.downscale_indices)}
    stage_of_block[cfg.num_layers - 1] = len(cfg.downscale_indices)
    rel_hw_size = cfg.rel_pos_spatial_size // 4
    plans = []
    dims, heads = cfg.embed_dims, cfg.num_heads
    stride_kv = list(cfg.adaptive_kv_stride)
    size = (cfg.temporal_size // 2, cfg.spatial_size[0] // 4, cfg.spatial_size[1] // 4)
    for i in range(cfg.num_layers):
        if i in downscale:
            heads *= cfg.head_mul
            stride_q = (1, 2, 2)
            stride_kv = [max(s // 2, 1) for s in stride_kv]
        else:
            stride_q = (1, 1, 1)
        out_dims = dims * cfg.dim_mul if i in downscale else dims
        rel_dim = 2 * max(rel_hw_size // stride_q[1], rel_hw_size // stride_kv[1]) - 1
        plans.append(dict(
            in_dims=dims, out_dims=out_dims, num_heads=heads, stride_q=stride_q,
            stride_kv=tuple(stride_kv), in_size=size,
            rel_pos_dims=(2 * (cfg.temporal_size // 2) - 1, rel_dim),
            emit_scale=stage_of_block.get(i),
        ))
        size = _pool_out_size(size, stride_q)
        rel_hw_size = rel_hw_size // stride_q[1]
        dims = out_dims
    return plans


class MultiScaleAttention(nn.Module):
    """Pooled attention (reference mvit.py:497-650): qkv Linear, depthwise
    (3,3,3) pools shared across heads with per-head LayerNorms, decomposed
    rel-pos, residual pooling, output projection."""

    def __init__(self, in_dims: int, out_dims: int, num_heads: int, stride_q,
                 stride_kv, rel_pos_dims, pool_kernel=(3, 3, 3), qkv_bias=True,
                 rel_pos_embed=True, residual_pooling=True, pool_mode="conv",
                 cls_stream=True):
        super().__init__()
        if pool_mode not in POOL_MODES:
            raise ValueError(f"pool_mode={pool_mode!r}; expected one of {POOL_MODES}")
        if pool_mode == "pallas" and tuple(pool_kernel) != (3, 3, 3):
            raise ValueError(f"pool_mode='pallas' takes a (3, 3, 3) pool, got {pool_kernel}")
        self.pool_mode = pool_mode
        self._pool_weights = {}  # parts -> (pool weights' state, K11's tiled weight)
        self.cls_stream = cls_stream
        self.num_heads = num_heads
        self.out_dims = out_dims
        self.head_dim = hd = out_dims // num_heads
        self.stride_q = tuple(stride_q)
        self.stride_kv = tuple(stride_kv)
        self.pool_kernel = tuple(pool_kernel)
        self.rel_pos_embed = rel_pos_embed
        self.residual_pooling = residual_pooling
        self.qkv = nn.Linear(in_dims, 3 * out_dims, bias=qkv_bias)
        self.proj = nn.Linear(out_dims, out_dims)
        for p in ("q", "k", "v"):
            setattr(self, f"pool_{p}", nn.Conv3d(hd, hd, self.pool_kernel,
                                                 groups=hd, bias=False))
            setattr(self, f"norm_{p}", FusedLayerNorm(hd))
        if rel_pos_embed:
            self.rel_pos_t = nn.Parameter(torch.zeros(rel_pos_dims[0], hd))
            self.rel_pos_h = nn.Parameter(torch.zeros(rel_pos_dims[1], hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(rel_pos_dims[1], hd))

    def _pool(self, x: torch.Tensor, parts, stride, dt) -> torch.Tensor:
        """One grouped depthwise conv over channel-concatenated parts
        (B, T, H, W, n*heads*hd); each part's (hd,1,kt,kh,kw) kernel is
        shared across heads, as in the reference. With pool_mode="pallas"
        the pool is kernel K11 on x as it lies, with the kernels tiled
        across heads as (3, 3, 3, C) f32 (JAX `_pallas_depthwise_pool`,
        mvit.py:594)."""
        H = self.num_heads
        if self.pool_mode == "pallas":
            return pool_ops.depthwise_pool3d(x.to(dt), self._pool_weight(parts), stride)
        w = torch.cat([getattr(self, f"pool_{p}").weight.repeat(H, 1, 1, 1, 1)
                       for p in parts], 0)
        return conv3d(x, w, None, dt, stride=stride,
                      padding=tuple(k // 2 for k in self.pool_kernel),
                      groups=w.shape[0])

    def _pool_weight(self, parts) -> torch.Tensor:
        """K11's (3, 3, 3, C) f32 weight: each part's kernel tiled across
        heads. Where a gradient is taken it is built on every call, so that
        the gradients reach `pool_*.weight`; otherwise (eval) one copy per
        `parts` is kept and built again when a pool weight changes (its
        version counter, storage, device or dtype)."""
        ws = [getattr(self, f"pool_{p}").weight for p in parts]

        def build():
            return torch.cat([w[:, 0].permute(1, 2, 3, 0).repeat(1, 1, 1, self.num_heads)
                              for w in ws], -1).float().contiguous()
        if torch.is_grad_enabled() and any(w.requires_grad for w in ws):
            return build()
        state = tuple((w._version, w.data_ptr(), w.device, w.dtype) for w in ws)
        kept = self._pool_weights.get(parts)
        if kept is None or kept[0] != state:
            with torch.no_grad():
                kept = self._pool_weights[parts] = (state, build())
        return kept[1]

    def _norm(self, t: torch.Tensor, part: str) -> torch.Tensor:
        """Per-head LayerNorm of a (B, L, heads*hd) tensor."""
        B, L, _ = t.shape
        n = getattr(self, f"norm_{part}")
        y = ln_ops.layer_norm(t.reshape(B, L, self.num_heads, self.head_dim).contiguous(),
                              n.weight, n.bias, n.eps)
        return y.reshape(B, L, -1)

    def forward(self, sp: torch.Tensor, cls: torch.Tensor, in_size, dt: Dtype = None):
        """sp (B, L, C_in) normed spatial tokens over the in_size grid, cls
        (B, 1, C_in). Returns (out_sp (B, L', C), out_cls (B, 1, C), q_shape)."""
        B = sp.shape[0]
        C, H, hd = self.out_dims, self.num_heads, self.head_dim
        T, Hh, Ww = in_size
        qkv = dense(sp, self.qkv, dt).reshape(B, T, Hh, Ww, 3 * C)
        qkv_cls = dense(cls, self.qkv, dt)
        d = qkv.dtype
        if self.stride_q == self.stride_kv:
            pooled = self._pool(qkv, "qkv", self.stride_q, d)
            q_sp, k_sp, v_sp = pooled.split(C, dim=-1)
            q_shape = k_shape = tuple(pooled.shape[1:4])
        else:
            q_sp = self._pool(qkv[..., :C], "q", self.stride_q, d)
            kv = self._pool(qkv[..., C:], "kv", self.stride_kv, d)
            k_sp, v_sp = kv.split(C, dim=-1)
            q_shape, k_shape = tuple(q_sp.shape[1:4]), tuple(kv.shape[1:4])
        Lq = q_shape[0] * q_shape[1] * q_shape[2]
        cq, ck, cv = qkv_cls.split(C, dim=-1)
        # LayerNorm is per row: cls and spatial rows share one launch
        q_all = self._norm(torch.cat([cq, q_sp.reshape(B, Lq, C)], 1), "q")
        k2 = self._norm(torch.cat([ck, k_sp.reshape(B, -1, C)], 1), "k")
        v2 = self._norm(torch.cat([cv, v_sp.reshape(B, -1, C)], 1), "v")
        scale = hd ** -0.5
        if not self.cls_stream:
            out = dense(self._token_concat(q_all, k2, v2, q_shape, k_shape, scale), self.proj, d)
            return out[:, 1:], out[:, :1], q_shape
        cq, q2 = q_all[:, :1], q_all[:, 1:].contiguous()

        kt, kh, kw = k_shape
        if self.rel_pos_embed:
            rel = rel_pos_terms(q2.reshape(B, Lq, H, hd), q_shape, k_shape,
                                self.rel_pos_t, self.rel_pos_h, self.rel_pos_w)
        else:
            rel = torch.zeros((B, Lq, H, kt + kh + kw), dtype=d, device=sp.device)
        out = attn_ops.bias_attention(q2, k2, v2, rel.contiguous(), k_shape, H,
                                      scale, self.residual_pooling)
        # cls query row: full attention over [cls | pooled kv], no bias and
        # no residual (reference mvit.py:640-644)
        k4 = k2.reshape(B, -1, H, hd)
        v4 = v2.reshape(B, -1, H, hd)
        f = acc_dtype(k4.dtype)
        cs = torch.einsum("bqhd,bkhd->bhqk", (cq.reshape(B, 1, H, hd) * scale).to(f), k4.to(f))
        cp = torch.softmax(cs, dim=-1).to(d)
        out_cls = torch.einsum("bhqk,bkhd->bqhd", cp, v4).reshape(B, 1, C)
        return dense(out, self.proj, d), dense(out_cls, self.proj, d), q_shape

    def _token_concat(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_shape,
                      k_shape, scale: float) -> torch.Tensor:
        """The attention of JAX's token-concat layout (`mvit.py:807-837`):
        q (B, 1 + Lq, C), k and v (B, 1 + Lk, C) with cls at row 0, laid out
        per head as (B*H, L, hd); the bias terms of the spatial query rows
        in f32 with a zero cls row; kernel K12 with the residual on rows >=
        1. Returns (B, 1 + Lq, C), cls at row 0."""
        B, L, C = q.shape
        H, hd = self.num_heads, self.head_dim

        def heads(t):
            return t.reshape(B, t.shape[1], H, hd).transpose(1, 2).reshape(B * H, -1, hd)

        qh, kh, vh = (heads(t).contiguous() for t in (q, k, v))
        if self.rel_pos_embed:
            rels = rel_pos_parts(qh[:, 1:], q_shape, k_shape, self.rel_pos_t, self.rel_pos_h,
                                 self.rel_pos_w)
        else:
            rels = [torch.zeros((B * H, L, n), dtype=acc_dtype(q.dtype), device=q.device)
                    for n in k_shape]
        out = attn_ops.fused_bias_attention(qh, kh, vh, *rels, k_shape, scale,
                                            self.residual_pooling)
        return out.reshape(B, H, L, hd).transpose(1, 2).reshape(B, L, C)


class MultiScaleBlock(nn.Module):
    """Pre-norm block: pooled attention + MLP, channel expansion in the
    attention, max-pooled residual on strided blocks (reference
    mvit.py:653-792)."""

    def __init__(self, plan: dict, cfg: MViTConfig):
        super().__init__()
        in_dims, out_dims = plan["in_dims"], plan["out_dims"]
        self.stride_q = tuple(plan["stride_q"])
        self.norm1 = FusedLayerNorm(in_dims)
        self.attn = MultiScaleAttention(
            in_dims, out_dims, plan["num_heads"], plan["stride_q"],
            plan["stride_kv"], plan["rel_pos_dims"], cfg.pool_kernel,
            cfg.qkv_bias, cfg.rel_pos_embed, cfg.residual_pooling,
            cfg.pool_mode if cfg.cls_stream else "conv", cfg.cls_stream,
        )
        self.norm2 = FusedLayerNorm(out_dims)
        self.mlp = Mlp(out_dims, int(out_dims * cfg.mlp_ratio), act=cfg.gelu,
                       quant=cfg.mlp_quant)
        self.proj = nn.Linear(in_dims, out_dims) if in_dims != out_dims else None

    def forward(self, sp: torch.Tensor, cls: torch.Tensor, in_size, dt: Dtype = None):
        B = sp.shape[0]
        sp_n, cls_n = self.norm1(sp), self.norm1(cls)
        attn_sp, attn_cls, out_size = self.attn(sp_n, cls_n, in_size, dt)
        if self.proj is not None:
            skip_sp, skip_cls = dense(sp_n, self.proj, dt), dense(cls_n, self.proj, dt)
        else:
            skip_sp, skip_cls = sp, cls
        if any(s > 1 for s in self.stride_q):
            kernel = tuple(s + 1 if s > 1 else s for s in self.stride_q)
            x5 = skip_sp.reshape((B,) + tuple(in_size) + (-1,)).permute(0, 4, 1, 2, 3)
            x5 = F.max_pool3d(x5, kernel, self.stride_q, tuple(k // 2 for k in kernel))
            skip_sp = x5.permute(0, 2, 3, 4, 1).reshape(B, -1, x5.shape[1])
        sp = skip_sp + attn_sp
        cls = skip_cls + attn_cls
        if self.mlp.quant != "none":
            # the quantised MLP works row by row: the cls rows join the
            # spatial rows in one int8 product (torch._int_mm takes more
            # than 16 rows; the cls stream alone has B)
            m = self.mlp(torch.cat([self.norm2(cls), self.norm2(sp)], 1), dt)
            return sp + m[:, 1:], cls + m[:, :1], out_size
        sp = sp + self.mlp(self.norm2(sp), dt)
        cls = cls + self.mlp(self.norm2(cls), dt)
        return sp, cls, out_size


class PatchEmbed3D(nn.Module):
    """Conv3d stem (reference mvit.py:124-247)."""

    def __init__(self, in_channels: int, embed_dims: int):
        super().__init__()
        self.projection = nn.Conv3d(in_channels, embed_dims, (3, 7, 7), (2, 4, 4), (1, 3, 3))

    def forward(self, x: torch.Tensor, dt: Dtype = None):
        p = self.projection
        y = conv3d(x, p.weight, p.bias, dt, stride=p.stride, padding=p.padding)
        return y.reshape(y.shape[0], -1, y.shape[-1]), tuple(y.shape[1:4])


class MViT(nn.Module):
    """MViTv2 encoder returning the coarse-first 4-scale pyramid."""

    def __init__(self, cfg: MViTConfig):
        super().__init__()
        if not cfg.with_cls_token:
            raise NotImplementedError("the port builds MViT with its cls token")
        if cfg.mlp_quant not in QUANT_MODES:
            raise ValueError(f"mlp_quant={cfg.mlp_quant!r}; expected one of {QUANT_MODES}")
        if cfg.gelu not in ("tanh", "exact"):
            raise ValueError(f"gelu={cfg.gelu!r}")
        self.cfg = cfg
        self.plans = block_plan(cfg)
        self.patch_embed = PatchEmbed3D(cfg.in_channels, cfg.embed_dims)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dims))
        self.blocks = nn.ModuleList([MultiScaleBlock(p, cfg) for p in self.plans])
        for p in self.plans:
            s = p["emit_scale"]
            if s is not None and s in cfg.out_scales:
                self.add_module(f"norm{s}", FusedLayerNorm(p["out_dims"]))

    def forward(self, x: torch.Tensor, dt: Dtype = None) -> List[torch.Tensor]:
        B = x.shape[0]
        sp, size = self.patch_embed(x, dt)
        cls = self.cls_token.to(sp.dtype).expand(B, 1, -1)
        outs = []
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk, plan in zip(self.blocks, self.plans):
            if remat:
                # the backward runs the block's forward (its kernels) again
                # to rebuild what it saves; the size tuple passes through
                sp, cls, _ = checkpoint(blk, sp, cls, size, dt, use_reentrant=False)
            else:
                sp, cls, _ = blk(sp, cls, size, dt)
            size = _pool_out_size(size, plan["stride_q"])
            s = plan["emit_scale"]
            if s is not None and s in self.cfg.out_scales:
                normed = getattr(self, f"norm{s}")(sp)
                outs.append(normed.reshape((B,) + tuple(size) + (-1,)))
        return outs[::-1]
