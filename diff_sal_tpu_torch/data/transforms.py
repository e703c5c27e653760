"""Saliency-map transforms and rgb normalisation (JAX package
`data/transforms.py`; reference `datasets/__init__.py:8-35`). Under the
default config only Gaussian dequantization (`x + 0.01 * N(0, 1)`) is
active on the way in, and clamp-to-[0, 1] on the way out."""

from __future__ import annotations

from typing import Optional

import torch

from diff_sal_tpu_torch.config import DataTransformConfig

# ImageNet statistics in [0, 1] (DHF1k visual pretrain)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# STAViS statistics in 0-255 (the 6-dataset AV corpus, cfgs/dataset.json:74-77)
AV_MEAN = (114.7748, 107.7354, 99.475)
AV_STD = (38.7568578, 37.88248729, 40.02898126)


def logit_transform(x: torch.Tensor, lam: float = 1e-6) -> torch.Tensor:
    x = lam + (1 - 2 * lam) * x
    return torch.log(x) - torch.log1p(-x)


def data_transform(cfg: DataTransformConfig, x: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The training-time map transform. Its random draws (uniform and/or
    normal, of x's shape) come from `generator`; `noise` replaces the draw
    when one dequantization is on (tests hand over the JAX package's)."""

    def draw(fn):
        if noise is not None:
            if cfg.uniform_dequantization and cfg.gaussian_dequantization:
                raise ValueError("noise= takes the draw of one dequantization, two are on")
            return noise.to(device=x.device, dtype=x.dtype)
        dev = generator.device if generator is not None else x.device
        return fn(x.shape, generator=generator, device=dev, dtype=x.dtype).to(x.device)

    if cfg.uniform_dequantization:
        x = x / 256.0 * 255.0 + draw(torch.rand) / 256.0
    if cfg.gaussian_dequantization:
        x = x + draw(torch.randn) * 0.01
    if cfg.rescaled:
        x = 2 * x - 1.0
    elif cfg.logit_transform:
        x = logit_transform(x)
    return x


def inverse_data_transform(cfg: DataTransformConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.logit_transform:
        x = torch.sigmoid(x)
    elif cfg.rescaled:
        x = (x + 1.0) / 2.0
    return torch.clamp(x, 0.0, 1.0)


def normalize_rgb_u8(rgb: torch.Tensor, stats: str = "imagenet") -> torch.Tensor:
    """(..., 3) uint8 -> normalized float32 on the tensor's device."""
    f32 = torch.float32
    if stats == "stavis":
        mean = torch.tensor(AV_MEAN, dtype=f32, device=rgb.device)
        std = torch.tensor(AV_STD, dtype=f32, device=rgb.device)
        return (rgb.to(f32) - mean) / std
    if stats != "imagenet":
        raise ValueError(f"unknown rgb statistics {stats!r}")
    mean = torch.tensor(IMAGENET_MEAN, dtype=f32, device=rgb.device)
    std = torch.tensor(IMAGENET_STD, dtype=f32, device=rgb.device)
    return (rgb.to(f32) / 255.0 - mean) / std
