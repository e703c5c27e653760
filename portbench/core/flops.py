"""The model's operations per batch or per step, counted from the
benchmark's own reference model on the `meta` device (no data, no time)
under `torch.utils.flop_counter.FlopCounterMode`: products and
convolutions at 2 operations a multiply-add, the backward through
autograd as it runs, not as twice the forward. So the count is the same
work whatever the port runs to do it."""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import diffusion as ref_diff
from portbench.reference import model as ref_model


def conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                  transposed, _output_padding, _groups, output_mask, out_shape=None, **kw):
    """A convolution's backward: the input's gradient and the weight's
    gradient (each where asked for) cost as much as the forward, 2
    operations per output element and weight tap of its group. (The
    counter's own formula counts a grouped convolution's weight gradient
    as if it were dense: a depthwise pool's came out 96 times too high.)"""
    out = grad_out_shape if not transposed else x_shape
    forward = 2.0 * math.prod(out) * math.prod(w_shape[1:])
    return int(forward * (bool(output_mask[0]) + bool(output_mask[1])))


def _inputs(model_cfg: dict, traffic: dict):
    B = traffic["batch"]
    vis, dec = model_cfg["visual"], model_cfg["decoder"]
    T, (H, W) = vis["temporal_size"], vis["spatial_size"]
    h, w = dec["img_size"]
    rgb = torch.empty((B, T, H, W, 3), device="meta")
    audio = (torch.empty((B, traffic["audio_examples"], h // 2, w // 2, 1), device="meta")
             if model_cfg.get("audio") else None)
    return rgb, audio, torch.empty((B, h, w, 1), device="meta")


def count(model_cfg: dict, traffic: dict) -> float:
    """Operations of one batch through the sampler (inference traffic) or
    of one training step's forward and backward (training traffic)."""
    model = ref_model.build(model_cfg, "meta")
    rgb, audio, x = _inputs(model_cfg, traffic)
    mode = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: conv_backward})
    if traffic["kind"] == "infer":
        model.eval().requires_grad_(False)
        with torch.no_grad(), mode:
            ref_diff.sample(model, ref_diff.Schedule(), traffic["sampler"], rgb, audio, x)
    else:
        model.train()
        t = torch.empty((x.shape[0],), device="meta")
        with mode:
            pred = model(rgb, x, t, audio, train=True)
            ref_diff.mse_loss(pred, x).backward()
    return float(mode.get_total_flops())
