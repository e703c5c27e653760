"""VGGish audio conv trunk (JAX package `models/vggish.py`; reference
`models/vggish.py:96-128`).

[64, M, 128, M, 256, 256, M, 512, 512, M]: each int a 3x3 conv + ReLU,
each M a 2x2 max-pool; state-dict keys `features.{0,3,6,8,11,13}`. The
trunk is frozen: it runs under `torch.no_grad`. The reference's FC
embedding head (`embeddings.*`) is not used by the saliency path and is
not built.

(N, 112, 192, 1) -> (N, 7, 12, 512)
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diff_sal_tpu_torch.config import VGGishConfig
from diff_sal_tpu_torch.models.layers import Dtype, conv2d


class VGGish(nn.Module):
    def __init__(self, cfg: VGGishConfig = VGGishConfig()):
        super().__init__()
        layers = []
        cin = cfg.in_channels
        for v in cfg.layers:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, int(v), 3, padding=1), nn.ReLU()]
                cin = int(v)
        self.features = nn.Sequential(*layers)

    @torch.no_grad()
    def forward_feat(self, x: torch.Tensor, dt: Dtype = None) -> torch.Tensor:
        """Channel-last (N, H, W, C) log-mel images -> (N, H/16, W/16, 512)."""
        for layer in self.features:
            if isinstance(layer, nn.Conv2d):
                x = torch.relu(conv2d(x, layer.weight, layer.bias, dt, padding=1))
            elif isinstance(layer, nn.MaxPool2d):
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return x
