"""Exponential moving average of parameters (JAX package `train/ema.py`;
reference `models/diffusion_decoder/ema.py`), off by default as in the
reference."""

from __future__ import annotations

import contextlib
from typing import Dict

import torch


def ema_init(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A shadow copy of every parameter, by name."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float = 0.9999) -> Dict[str, torch.Tensor]:
    """shadow = decay * shadow + (1 - decay) * new, in place; returns `ema`."""
    for name, e in ema.items():
        e.copy_(decay * e + (1.0 - decay) * params[name])
    return ema


@contextlib.contextmanager
def swap_in_ema(model: torch.nn.Module, ema: Dict[str, torch.Tensor]):
    """The model with the EMA shadow in place of its parameters inside the
    scope (for evaluation); the parameters are put back after it."""
    params = dict(model.named_parameters())
    saved = {n: params[n].detach().clone() for n in ema}
    with torch.no_grad():
        for n, e in ema.items():
            params[n].copy_(e)
    try:
        yield model
    finally:
        with torch.no_grad():
            for n, v in saved.items():
                params[n].copy_(v)
