"""VideoSaliencyModel: MViT visual encoder, frozen VGGish + AudioAttnNet
audio path and the SalUNet denoiser (JAX package `models/diff_model.py`;
reference `models/diff_model.py:8-114`).

`encode_visual`, `encode_audio` and `denoise` are separate entry points,
so a sampler encodes once and calls only the denoiser per step; `forward`
is the whole model, the counterpart of the JAX module's `__call__`, which
the training step calls with `train=True`. Inputs are channel-last: rgb
(B, 16, 224, 384, 3) float or uint8, audio (B, 9, 112, 192, 1), x_t (B,
224, 384, 1), t (B,). The VGGish trunk is frozen: its parameters do not
require grad and it runs under no_grad (JAX `diff_model.py:110` stops
its gradient).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from diff_sal_tpu_torch.config import ModelConfig
from diff_sal_tpu_torch.data.transforms import normalize_rgb_u8
from diff_sal_tpu_torch.models.audio_attention import AudioAttnNet
from diff_sal_tpu_torch.models.layers import BatchNorm, FusedLayerNorm
from diff_sal_tpu_torch.models.mvit import MViT
from diff_sal_tpu_torch.models.sal_unet import SalUNet
from diff_sal_tpu_torch.models.vggish import VGGish


class VideoSaliencyModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.visual is None:
            raise NotImplementedError("the visual=None random-pyramid mode is not ported yet")
        self.cfg = cfg
        self.visual_net = MViT(cfg.visual)
        self.audio_net = VGGish(cfg.audio).requires_grad_(False) if cfg.audio else None
        self.spatiotemp_net = AudioAttnNet(cfg.spatiotemp) if cfg.spatiotemp else None
        self.decoder_net = SalUNet(cfg.decoder, with_audio=cfg.audio is not None)

    def set_stats_group(self, group) -> int:
        """Train-mode BatchNorm statistics over the global batch of
        `group`'s data-parallel ranks (None: this process's batch alone).
        Returns the number of BatchNorms set (the decoder's 7)."""
        norms = [m for m in self.modules() if isinstance(m, BatchNorm)]
        for m in norms:
            m.stats_group = group
        return len(norms)

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        name = self.cfg.compute_dtype
        return None if name in (None, "float32") else getattr(torch, name)

    def encode_visual(self, rgb: torch.Tensor) -> List[torch.Tensor]:
        """rgb (B, T, H, W, 3) -> coarse-first 4-scale pyramid; uint8 input
        is normalized on the device first."""
        if rgb.dtype == torch.uint8:
            rgb = normalize_rgb_u8(rgb, stats=self.cfg.uint8_norm)
        return self.visual_net(rgb, self.compute_dtype)

    def encode_audio(self, audio: torch.Tensor, train: bool = False,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """audio (B, Ta, 112, 192, 1) -> (B, Ta, 7, 12, 512); the VGGish trunk
        is frozen."""
        B, Ta = audio.shape[:2]
        feat = self.audio_net.forward_feat(audio.reshape((B * Ta,) + tuple(audio.shape[2:])),
                                           self.compute_dtype)
        feat = feat.reshape((B, Ta) + tuple(feat.shape[1:]))
        if self.spatiotemp_net is not None:
            feat = self.spatiotemp_net(feat, self.compute_dtype, train, generator)
        return feat

    def denoise(self, x: torch.Tensor, t: torch.Tensor, feat_list: List[torch.Tensor],
                audio_feat: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decoder_net(x, t, feat_list, audio_feat, self.compute_dtype, train,
                                generator)

    def forward(self, data: dict, t: torch.Tensor, train: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """data {"rgb", "input": x_t[, "audio"]}, t (B,) -> the denoiser's
        output (B, H, W, 1). `train` defaults to the module's training
        mode; dropout and DropPath masks come from `generator`."""
        train = self.training if train is None else train
        audio_feat = None
        if self.audio_net is not None and data.get("audio") is not None:
            audio_feat = self.encode_audio(data["audio"], train, generator)
        feat_list = self.encode_visual(data["rgb"])
        return self.denoise(data["input"], t, feat_list, audio_feat, train, generator)


def param_counts(model: nn.Module) -> Dict[str, float]:
    """Parameters per sub-network, in millions (the reference prints these
    when it builds the model, diff_model.py:66-68)."""
    out: Dict[str, float] = {}
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0]
        out[top] = out.get(top, 0.0) + p.numel() / 1e6
    return out


def build_model(cfg: ModelConfig, seed: int = 0, device="cuda",
                train: bool = False) -> VideoSaliencyModel:
    """The model with seeded random weights (`init_weights`) in eval mode,
    or in train mode when asked, on `device`: the card unless the caller
    asks for the CPU."""
    return init_weights(VideoSaliencyModel(cfg), seed).train(train).to(device)


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random initialisation, drawn on the CPU from one
    torch.Generator (device-independent): fan-in-scaled normal weights,
    zero biases, unit norm scales, trunc-normal(0.02) cls token and rel-pos
    tables, identity BatchNorm statistics."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("rel_pos") or leaf == "cls_token":
                v = torch.randn(p.shape, generator=g).clamp_(-2, 2) * 0.02
            elif p.dim() == 1:
                v = torch.ones(p.shape) if _is_norm_scale(model, name) else torch.zeros(p.shape)
            else:
                fan_in = int(np.prod(p.shape[1:]))
                v = torch.randn(p.shape, generator=g) / np.sqrt(fan_in)
            p.copy_(v.to(p.device))
        for name, b in model.named_buffers():
            if name.endswith("running_var"):
                b.fill_(1.0)
            elif name.endswith("running_mean") or name.endswith("num_batches_tracked"):
                b.zero_()
    return model


def _is_norm_scale(model: nn.Module, name: str) -> bool:
    mod_name, leaf = name.rsplit(".", 1)
    mod = model.get_submodule(mod_name)
    norms = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d, FusedLayerNorm)
    return leaf == "weight" and isinstance(mod, norms)
