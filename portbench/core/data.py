"""Weights and inputs drawn from the run's seed, on the device, in a few
large calls. Both sides of the comparison get the same tensors: the port
loads the weights into its own model, the reference draws them again
after the window."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.core.spec import subseed
from portbench.reference import model as ref_model


def draw_weights(model_cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the configuration, by the reference's
    names and shapes, in float32: one standard-normal draw for the whole
    model, cut into leaves and scaled by kind. Products' weights N(0,
    1/fan_in); rel-pos tables and the cls token 0.02 N(0, 1) clipped at 2
    sigma; norm scales 1 + 0.02 N; biases 0.02 N; running means 0 and
    variances 1."""
    shapes = ref_model.build(model_cfg, "meta")
    scales = set(ref_model.norm_scales(shapes))
    params = list(shapes.named_parameters())
    total = sum(p.numel() for _, p in params)
    g = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, p in params:
        v = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("rel_pos") or leaf == "cls_token":
            v = v.clamp(-2, 2) * 0.02
        elif name in scales:
            v = 1.0 + 0.02 * v
        elif p.dim() == 1:
            v = 0.02 * v
        else:
            v = v / float(np.sqrt(np.prod(p.shape[1:])))
        out[name] = v
    for name, b in shapes.named_buffers():
        if name.endswith("running_var"):
            out[name] = torch.ones(b.shape, device=device)
        elif name.endswith("running_mean"):
            out[name] = torch.zeros(b.shape, device=device)
        elif name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.long, device=device)
    return out


def draw_batches(model_cfg: dict, traffic: dict, seed: int, device) -> List[dict]:
    """The cell's rotating set of batches: clips 0.5 N(0, 1), audio
    log-mel examples N(0, 1), saliency maps U(0, 1) for training, x_T
    N(0, 1) for sampling."""
    B, n = traffic["batch"], traffic["rotating_batches"]
    vis, dec = model_cfg["visual"], model_cfg["decoder"]
    T, (H, W) = vis["temporal_size"], vis["spatial_size"]
    h, w = dec["img_size"]
    g = torch.Generator(device=device).manual_seed(subseed(seed, "inputs"))
    batches = []
    for _ in range(n):
        b = {"rgb": 0.5 * torch.randn((B, T, H, W, 3), generator=g, device=device)}
        if model_cfg.get("audio"):
            b["audio"] = torch.randn((B, traffic["audio_examples"], h // 2, w // 2, 1),
                                     generator=g, device=device)
        if traffic["kind"] == "train":
            b["salmap"] = torch.rand((B, h, w, 1), generator=g, device=device)
        else:
            b["noise"] = torch.randn((B, h, w, 1), generator=g, device=device)
        batches.append(b)
    return batches


def kept_iterations(seed: int, span: int = 200, count: int = 12) -> set:
    """The window's iterations whose outputs are kept for the comparison:
    `count` drawn from the seed out of the first `span` (the last ones of
    the window are kept besides)."""
    rng = np.random.default_rng(subseed(seed, "sample"))
    return set(int(i) for i in rng.choice(span, size=count, replace=False))
