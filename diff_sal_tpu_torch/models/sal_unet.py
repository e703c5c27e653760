"""Saliency-UNet diffusion decoder, channel-last (JAX package
`models/sal_unet.py`; reference `models/saliency_decoder/`).

Noise-pyramid encoder, four CvT transformer stages with gated audio-video
cross-attention, temporal reduction, multi-scale resize-and-sum (kernel
K4) and sigmoid head. At eval every TransformerBlock tail runs through
kernel K3 and every LayerNorm through K2; with `fused_attn` the CvT
attention runs through K7, and with `head_lowres` the resize-sum and
`mt_proj` run as one conv-at-low-res head through K9 (`fused_head` on
`mt_proj`: through K8), BatchNorm folded. With `train=True` (the training
step) the tail takes the module path with DropPath instead of K3, the
noise encoder's ResnetBlocks apply dropout, the UpEmbed and `mt_proj`
BatchNorms use batch statistics, and the dead-frame cut follows
`skip_dead_frames_train`; random masks come from the `generator` given. Parameter names are the
reference's (`temb.dense`, `conv_in`, `down1`, `res_encoder`,
`invpt_decoder.{mid_stages,norm_mts,redu_chan_up,mt_proj}`, `logits`).

Reference behaviours kept on purpose (README "Quirk register"):
  * CvT attention scales by the full dim, not the head dim;
  * only stages 1 and 2 get backbone skips; the finest video scale is unused;
  * ReduceTemp (kernel/stride 5 over 9 frames) keeps frames 0-4 only;
  * the audio gate's tokens mix (C, T) axes like torch's
    `(b, c, t, h, w).view(b*t, h*w, c)`;
  * the CvT q/k/v projections are Conv3d on a T=1 grid: only the centre
    temporal slice of their weights touches data.

Shapes (AV config): x_t (B, 224, 384, 1), t (B,), pyramid
[(B,8,7,12,768), (B,8,14,24,384), (B,8,28,48,192), (B,8,56,96,96)], audio
(B, 9, 7, 12, 512) -> (B, 224, 384, 1) in (0, 1).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from diff_sal_tpu_torch.config import SalUNetConfig
from diff_sal_tpu_torch.models.layers import (BatchNorm, ConvBNRelu, Dtype,
                                              FusedLayerNorm, GroupNorm, MLPHead,
                                              Mlp, conv2d, conv3d, dense, drop_path,
                                              dropout, timestep_embedding)
from diff_sal_tpu_torch.ops import attention as attn_ops
from diff_sal_tpu_torch.ops import mlp as mlp_ops
from diff_sal_tpu_torch.ops.resize import bilinear_resize, nearest_upsample
from diff_sal_tpu_torch.parallel import tensor as tp


class TimestepMLP(nn.Module):
    """sinusoid(ch) -> Linear(4ch) -> swish -> Linear(4ch), in f32."""

    def __init__(self, ch: int):
        super().__init__()
        self.ch = ch
        self.dense = nn.ModuleList([nn.Linear(ch, 4 * ch), nn.Linear(4 * ch, 4 * ch)])

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.ch)
        return dense(torch.nn.functional.silu(dense(emb, self.dense[0])), self.dense[1])


class ResnetBlock(nn.Module):
    """DDPM resnet block with timestep conditioning (reference
    sal_unet.py:87-142); dropout before conv2 when training."""

    def __init__(self, cin: int, cout: int, temb_ch: int, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.norm1 = GroupNorm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.temb_proj = nn.Linear(temb_ch, cout)
        self.norm2 = GroupNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb, dt: Dtype = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        silu = torch.nn.functional.silu
        h = silu(self.norm1(x, dt))
        h = conv2d(h, self.conv1.weight, self.conv1.bias, dt, padding=1)
        h = h + dense(silu(temb), self.temb_proj, dt)[:, None, None, :].to(h.dtype)
        h = dropout(silu(self.norm2(h, dt)), self.rate, train, generator)
        h = conv2d(h, self.conv2.weight, self.conv2.bias, dt, padding=1)
        if self.nin_shortcut is not None:
            x = conv2d(x, self.nin_shortcut.weight, self.nin_shortcut.bias, dt)
        return x + h


class Downsample(nn.Module):
    """3x3 conv, stride s, with the DDPM asymmetric (0,1)x(0,1) pad."""

    def __init__(self, ch: int, stride: int = 2):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride)

    def forward(self, x, dt: Dtype = None):
        c = self.conv
        return conv2d(x, c.weight, c.bias, dt, stride=c.stride, padding=((0, 1), (0, 1)))


class _ResDown(nn.ModuleList):
    def __init__(self, cin: int, cout: int, temb_ch: int, rate: float):
        super().__init__([ResnetBlock(cin, cout, temb_ch, rate), Downsample(cout)])


class CvTAttention(nn.Module):
    """Cross-modal CvT attention (reference saliency_decoder/attention.py):
    depthwise conv projections + LayerNorm; with audio tokens, keys come
    from audio and queries/values from video."""

    class _ConvProj(nn.Module):
        def __init__(self, C: int, kt: int, k: int):
            super().__init__()
            self.conv = nn.Conv3d(C, C, (kt, k, k), groups=C, bias=False)
            self.bn = FusedLayerNorm(C)

    def __init__(self, C: int, num_heads: int, kernel_kv: int, stride_kv: int,
                 fused_attn: bool = False):
        super().__init__()
        self.fused_attn = fused_attn
        self.num_heads = num_heads
        self.stride_kv = stride_kv
        # q: 3x3 / pad 1 / stride 1; k, v: kernel == stride, no pad
        self.conv_proj_q = self._ConvProj(C, 3, 3)
        self.conv_proj_k = self._ConvProj(C, 1, kernel_kv)
        self.conv_proj_v = self._ConvProj(C, 1, kernel_kv)
        self.proj_q = nn.Linear(C, C)
        self.proj_k = nn.Linear(C, C)
        self.proj_v = nn.Linear(C, C)
        self.proj = nn.Linear(C, C)

    def _tokens(self, x_sp, cp, stride, padding, dt):
        w = cp.conv.weight
        w2 = w[:, :, w.shape[2] // 2]  # T=1 grid: the centre temporal slice
        y = conv2d(x_sp, w2, None, dt, stride=stride, padding=padding, groups=w.shape[0])
        return cp.bn(y.reshape(y.shape[0], -1, y.shape[-1]))

    def forward(self, tokens, hw, audio_tokens=None, dt: Dtype = None, train: bool = False):
        """With `fused_attn`, at eval, the attention is kernel K7 (JAX
        `sal_unet.py:383`, `fused_attn and not train`)."""
        H, W = hw
        Bt, _, C = tokens.shape
        x_sp = tokens.reshape(Bt, H, W, C)
        q = self._tokens(x_sp, self.conv_proj_q, 1, 1, dt)
        kv_src = audio_tokens.reshape(Bt, H, W, C) if audio_tokens is not None else x_sp
        k = self._tokens(kv_src, self.conv_proj_k, self.stride_kv, 0, dt)
        v = self._tokens(x_sp, self.conv_proj_v, self.stride_kv, 0, dt)
        q, k, v = dense(q, self.proj_q, dt), dense(k, self.proj_k, dt), dense(v, self.proj_v, dt)
        nh, hd = self.num_heads, C // self.num_heads
        scale = C ** -0.5  # reference quirk: the full dim, not the head dim
        if self.fused_attn and not train:
            out = attn_ops.cvt_cross_attention(q, k, v, nh, scale)
            return dense(out, self.proj, dt)
        attn = torch.einsum("blhd,bthd->bhlt", q.reshape(Bt, -1, nh, hd),
                            k.reshape(Bt, -1, nh, hd)) * scale
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhlt,bthd->blhd", attn, v.reshape(Bt, -1, nh, hd))
        return dense(out.reshape(Bt, -1, C), self.proj, dt)


def scrambled_audio_tokens(ac: torch.Tensor) -> torch.Tensor:
    """torch's `(b, c, t, h, w).view(b*t, h*w, c)` on channel-last audio
    (B, T, H, W, C) (reference transformer.py:146)."""
    B, T, H, W, C = ac.shape
    return ac.permute(0, 4, 1, 2, 3).reshape(B * T, H * W, C)


class TransformerBlock(nn.Module):
    """Gated audio-video fusion + CvT attention + MLP (reference
    transformer.py:76-159). At eval the tail (residual, norm2, MLP,
    residual) is one K3 launch; training takes the module path, with
    DropPath on the MLP branch."""

    def __init__(self, C: int, num_heads: int, mlp_ratio: float, kernel_kv: int,
                 stride_kv: int, audio_dim: Optional[int], act: str,
                 drop_path_rate: float = 0.0, fused_attn: bool = False):
        super().__init__()
        self.act = act
        self.drop_path_rate = drop_path_rate
        self.align_conv = nn.Conv2d(audio_dim, C, 1) if audio_dim else None
        self.norm = FusedLayerNorm(C)
        self.attn = CvTAttention(C, num_heads, kernel_kv, stride_kv, fused_attn)
        self.norm2 = FusedLayerNorm(C)
        self.mlp = Mlp(C, int(C * mlp_ratio), act=act)

    def forward(self, x, audio, keep_frames: Optional[int] = None, dt: Dtype = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        B, T, H, W, C = x.shape
        audio_tokens = None
        if audio is not None:
            if audio.shape[1] > T:  # an upstream dead-frame cut shortened x
                audio = audio[:, :T]
            ac = conv2d(audio.reshape((-1,) + tuple(audio.shape[2:])),
                        self.align_conv.weight, self.align_conv.bias, dt)
            ac = ac.reshape(audio.shape[:4] + (C,))
            ha, wa = ac.shape[2], ac.shape[3]
            if ha != H and wa != W:
                if H // ha < 1:
                    raise ValueError(f"audio grid ({ha},{wa}) must divide the video grid ({H},{W})")
                ac = nearest_upsample(ac, H // ha, h_axis=2, w_axis=3)
            # av gate: mean over time of audio*video, softmax over W
            av = torch.softmax((ac * x).mean(dim=1, keepdim=True), dim=3)
            audio_tokens = scrambled_audio_tokens(ac * av)
        if keep_frames is not None and keep_frames < T:
            T = keep_frames
            x = x[:, :T]
            if audio_tokens is not None:
                audio_tokens = audio_tokens.reshape(B, -1, H * W, C)[:, :T].reshape(B * T, H * W, C)
        tokens = x.reshape(B * T, H * W, C)
        attn_out = self.attn(self.norm(tokens), (H, W), audio_tokens, dt, train)
        if train:
            tokens = attn_out + tokens
            h = self.mlp(self.norm2(tokens).reshape(-1, C), dt, train, generator)
            tokens = tokens + drop_path(h.reshape(tokens.shape), self.drop_path_rate, train,
                                        generator)
            return tokens.reshape(B, T, H, W, C)
        d = attn_out.dtype
        m = self.mlp
        # K3 takes whole weights: sharded ones are gathered just before it
        out = mlp_ops.block_tail(
            tokens.reshape(-1, C).to(d).contiguous(), attn_out.reshape(-1, C).contiguous(),
            self.norm2.weight, self.norm2.bias, tp.full(m.fc1.weight.to(d)), m.fc1.bias,
            tp.full(m.fc2.weight.to(d)), m.fc2.bias, self.norm2.eps, self.act,
        )
        return out.reshape(B, T, H, W, C)


class UpEmbed(nn.Module):
    """2x bilinear upsample + two dilated 3x3 conv-BN-ReLU per frame
    (reference common_block.py:176-223; keys `proj.{1,2,4,5}`)."""

    def __init__(self, cin: int, C: int, patch_size: int = 3, dilation: int = 2):
        super().__init__()
        self.dilation = dilation
        self.proj = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="bilinear"),
            nn.Conv2d(cin, C, patch_size, padding=dilation, dilation=dilation, bias=False),
            BatchNorm(C), nn.ReLU(),
            nn.Conv2d(C, C, patch_size, padding=dilation, dilation=dilation, bias=False),
            BatchNorm(C), nn.ReLU(),
        )

    def forward(self, x, dt: Dtype = None, train: bool = False):
        B, T, H, W, C = x.shape
        f = bilinear_resize(x.reshape(B * T, H, W, C), (2 * H, 2 * W))
        for ci, bi in ((1, 2), (4, 5)):
            conv = self.proj[ci]
            f = conv2d(f, conv.weight, None, dt, padding=self.dilation, dilation=self.dilation)
            f = torch.relu(self.proj[bi](f, dt, train))
        return f.reshape(B, T, 2 * H, 2 * W, -1)


class ReduceTemp(nn.Module):
    """Temporal collapse: Conv3d kernel/stride (k, 1, 1), no bias, ReLU
    (reference common_block.py:150-173; keys `proj.0`)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.k = k
        self.proj = nn.Sequential(nn.Conv3d(cin, cout, (k, 1, 1), (k, 1, 1), bias=False),
                                  nn.ReLU())

    def forward(self, x, dt: Dtype = None):
        c = self.proj[0]
        return torch.relu(conv3d(x, c.weight, None, dt, stride=c.stride))


class TransformerStage(nn.Module):
    """Optional UpEmbed (+ backbone skip at stages 1 and 2), then a block."""

    def __init__(self, idx: int, cfg: SalUNetConfig, with_audio: bool):
        super().__init__()
        self.idx = idx
        C = cfg.up_channel[idx]
        self.patch_embed = (nn.ModuleList([UpEmbed(cfg.up_channel[idx - 1], C)])
                            if cfg.patch_size[idx] > 0 else None)
        self.blocks = nn.ModuleList([TransformerBlock(
            C, cfg.num_heads[idx], cfg.mlp_ratio[idx], cfg.kernel_kv[idx],
            cfg.stride_kv[idx], cfg.audio_dim if with_audio else None, cfg.gelu,
            cfg.drop_path_rate[idx], cfg.fused_attn,
        )])

    def forward(self, x, back_fea, audio, keep_frames, dt: Dtype = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.patch_embed is not None:
            x = self.patch_embed[0](x, dt, train)
            if self.idx in (1, 2):  # reference transformer.py:265-270
                x = x + back_fea[self.idx][:, : x.shape[1]]
        return self.blocks[0](x, audio, keep_frames, dt, train, generator)


class Decoder(nn.Module):
    """Four stages coarse -> fine; each stage output is LayerNormed,
    temporally reduced at 768 channels, resized to the finest grid x2 and
    summed (K4); then conv-BN-ReLU to 96 channels (reference
    sal_unet.py:331-491)."""

    def __init__(self, cfg: SalUNetConfig, with_audio: bool):
        super().__init__()
        self.cfg = cfg
        n = cfg.mid_num_stages
        self.mid_stages = nn.ModuleList([TransformerStage(i, cfg, with_audio) for i in range(n)])
        self.norm_mts = nn.ModuleList([FusedLayerNorm(cfg.up_channel[i]) for i in range(n)])
        self.redu_chan_up = nn.ModuleList([
            ReduceTemp(cfg.up_channel[i], cfg.ori_embed_dim, cfg.temporal_list[i])
            for i in range(n)
        ])
        self.mt_proj = ConvBNRelu(cfg.ori_embed_dim, cfg.down_embed_dim, cfg.head_lowres)

    def keep_frames(self, i: int, train: bool = False) -> Optional[int]:
        """Frames kept at stage i (JAX `sal_unet.py:639-650`): the last
        stage's cut is exact; the every-stage cut applies at eval, and when
        training only with `skip_dead_frames_train`."""
        cfg = self.cfg
        last = i == cfg.mid_num_stages - 1
        every = cfg.skip_dead_frames_all and (not train or cfg.skip_dead_frames_train)
        if cfg.skip_dead_frames and (last or every):
            return cfg.temporal_list[i]
        return None

    def forward(self, back_fea: Sequence[torch.Tensor], audio, dt: Dtype = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        x = back_fea[0]
        n = self.cfg.mid_num_stages
        h, w = x.shape[2], x.shape[3]
        out_hw = (h * 2 ** (n - 1) * 2, w * 2 ** (n - 1) * 2)
        tasks = []
        for i in range(n):
            x = self.mid_stages[i](x, back_fea, audio, self.keep_frames(i, train), dt, train,
                                   generator)
            task = self.redu_chan_up[i](self.norm_mts[i](x), dt)
            tasks.append(task[:, 0])
        return self.mt_proj(tasks, out_hw, dt, train)


class SalUNet(nn.Module):
    """Denoiser f(x_t, t, video pyramid, audio features) -> x0 estimate."""

    def __init__(self, cfg: SalUNetConfig, with_audio: bool):
        super().__init__()
        if cfg.gelu not in ("tanh", "exact"):
            raise ValueError(f"gelu={cfg.gelu!r}")
        self.cfg = cfg
        ch = cfg.noise_ch
        self.temb = TimestepMLP(ch)
        self.conv_in = nn.Conv2d(1, ch, 3, padding=1)
        self.down1 = Downsample(ch, stride=4)
        chans = [ch] + list(reversed(cfg.up_channel[:-1]))
        self.res_encoder = nn.ModuleList([
            _ResDown(chans[i], chans[i + 1], 4 * ch, cfg.dropout) for i in range(len(chans) - 1)
        ])
        self.invpt_decoder = Decoder(cfg, with_audio)
        self.logits = MLPHead(cfg.down_embed_dim, 1)

    def noise_pyramid(self, x, temb, dt: Dtype = None, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """x_t -> coarse-first noisy pyramid (reference sal_unet.py:240-300)."""
        h = conv2d(x, self.conv_in.weight, self.conv_in.bias, dt, padding=1)
        h = self.down1(h, dt)
        outs = []
        for res, down in self.res_encoder:
            h = down(res(h, temb, dt, train, generator), dt)
            outs.append(h[:, None])
        return outs[::-1]

    def forward(self, x, t, feat_list: Sequence[torch.Tensor],
                audio_feat: Optional[torch.Tensor] = None, dt: Dtype = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        temb = self.temb(t)
        noisy = self.noise_pyramid(x, temb, dt, train, generator)
        feats = list(feat_list)
        if self.cfg.image_based:
            for i in range(min(len(noisy), len(feats))):
                if feats[i].shape[2:4] == noisy[i].shape[2:4]:
                    feats[i] = torch.cat([feats[i], noisy[i].to(feats[i].dtype)], dim=1)
        pred = self.invpt_decoder(feats, audio_feat, dt, train, generator)
        pred = self.logits(pred)
        return bilinear_resize(pred, tuple(self.cfg.img_size))
