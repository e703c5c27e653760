"""Saliency-map transforms and rgb normalisation (JAX package
`data/transforms.py`; reference `datasets/__init__.py:8-35`)."""

from __future__ import annotations

import torch

from diff_sal_tpu_torch.config import DataTransformConfig

# ImageNet statistics in [0, 1] (DHF1k visual pretrain)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# STAViS statistics in 0-255 (the 6-dataset AV corpus, cfgs/dataset.json:74-77)
AV_MEAN = (114.7748, 107.7354, 99.475)
AV_STD = (38.7568578, 37.88248729, 40.02898126)


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
