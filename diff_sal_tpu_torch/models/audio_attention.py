"""AudioAttnNet: the effective 1-layer pre-norm transformer over VGGish
tokens (JAX package `models/audio_attention.py`; reference
`models/audio_attention.py:93-143`, whose patch and position embeddings
are computed and discarded, so they are not built).

State-dict keys follow the reference: `transformer.layers.{i}.0.*`
(attention: norm, to_qkv, to_out.0), `transformer.layers.{i}.1.net.*`
(feed-forward: 0 LayerNorm, 1 and 4 Linear), `transformer.norm`. Every
LayerNorm (eps 1e-6, as the JAX package builds them) runs through K2.
With `train=True` dropout (`AudioAttnConfig.dropout`, 0.0 in the AV
config) acts where the JAX package's does: on the attention
probabilities, after each output projection and after the GELU.

(B, T, H, W, 512) -> (B, T, H, W, 512)
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from diff_sal_tpu_torch.config import AudioAttnConfig
from diff_sal_tpu_torch.models.layers import Dtype, FusedLayerNorm, dense, dropout
from diff_sal_tpu_torch.ops.mlp import gelu


class TokenAttention(nn.Module):
    """LN -> qkv (no bias) -> softmax(q k^T / sqrt(d_head)) v -> out proj."""

    def __init__(self, dim: int, heads: int, dim_head: int, rate: float = 0.0):
        super().__init__()
        self.heads, self.dim_head, self.rate = heads, dim_head, rate
        inner = heads * dim_head
        self.norm = FusedLayerNorm(dim)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor, dt: Dtype = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, N, _ = x.shape
        qkv = dense(self.norm(x), self.to_qkv, dt).reshape(B, N, 3, self.heads, self.dim_head)
        q, k, v = qkv.unbind(2)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * self.dim_head ** -0.5
        attn = dropout(torch.softmax(attn, dim=-1), self.rate, train, generator)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, -1)
        return dropout(dense(out, self.to_out[0], dt), self.rate, train, generator)


class TokenFeedForward(nn.Module):
    """LN -> Linear -> exact GELU -> Linear."""

    def __init__(self, dim: int, hidden: int, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.net = nn.Sequential(FusedLayerNorm(dim), nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Dropout(0.0), nn.Linear(hidden, dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor, dt: Dtype = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = gelu(dense(self.net[0](x), self.net[1], dt), "exact")
        h = dropout(h, self.rate, train, generator)
        return dropout(dense(h, self.net[4], dt), self.rate, train, generator)


class _Transformer(nn.Module):
    def __init__(self, cfg: AudioAttnConfig):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([TokenAttention(cfg.dim, cfg.heads, cfg.dim_head, cfg.dropout),
                           TokenFeedForward(cfg.dim, cfg.mlp_dim, cfg.dropout)])
            for _ in range(cfg.depth)
        ])
        self.norm = FusedLayerNorm(cfg.dim)


class AudioAttnNet(nn.Module):
    def __init__(self, cfg: AudioAttnConfig = AudioAttnConfig()):
        super().__init__()
        self.transformer = _Transformer(cfg)

    def forward(self, x: torch.Tensor, dt: Dtype = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, H, W, C = x.shape
        tokens = x.reshape(B, T * H * W, C)
        for attn, ff in self.transformer.layers:
            tokens = attn(tokens, dt, train, generator) + tokens
            tokens = ff(tokens, dt, train, generator) + tokens
        return self.transformer.norm(tokens).reshape(B, T, H, W, C)
