"""Int8 quantisation of the MViT blocks' MLP weights (JAX package
`ops/quant.py`), an eval-time deployment transform selected by
`MViTConfig.mlp_quant`:

  "w8"   int8 weights with per-output-channel scales; the product runs on
         the activations with the weight converted to their dtype (exact:
         int8 values fit every float type), accumulated in f32, then
         scaled.
  "w8a8" int8 weights, and each activation row quantised to int8 by its
         own absmax (dynamic); the product is int8 x int8 -> int32
         (`torch._int_mm` on the card: the JAX package computes it with
         XLA's `dot_general`, not in a Pallas kernel), then scaled by the
         row's and the channel's scales.

A quantised `QuantLinear` keeps the torch `nn.Linear` layout: `weight_q`
(out, in) int8, `weight_scale` (out,) f32 and `bias` (out,) f32, under
the fp layer's name (`blocks.{i}.mlp.fc1.weight_q`, `...fc1.weight_scale`,
`...fc1.bias`). `quantize_state_dict` maps an fp `state_dict` onto a
quantised model's keys (JAX `quantize_like`), and `bridge.py` carries
JAX's `kernel_q` (in, out) and `kernel_scale` across, transposed as the
other dense kernels are. Quantised models are never trained.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from diff_sal_tpu_torch.ops.kernels import acc_dtype
from diff_sal_tpu_torch.parallel import tensor as tp

QUANT_MODES = ("none", "w8", "w8a8")


def quantize_kernel(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 of an (in, out) kernel (JAX's
    layout; the last axis is the output): w ~= q * scale[None, :], a
    column of zeros taking scale 1."""
    w = np.asarray(w, np.float32)
    s = np.abs(w).max(axis=tuple(range(w.ndim - 1))) / 127.0
    s = np.where(s == 0.0, 1.0, s).astype(np.float32)
    q = np.clip(np.rint(w / s), -127, 127).astype(np.int8)
    return q, s


def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row absmax int8 quantisation of the trailing axis:
    (int8 rows, (..., 1) f32 scales)."""
    xf = x.float()
    ax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    q = torch.clamp(torch.round(xf * (127.0 / ax)), -127, 127).to(torch.int8)
    return q, ax * (1.0 / 127.0)


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32. On the card
    `torch._int_mm`, which takes M > 16 and K, N multiples of 8 and raises
    here with the shapes where they are not met; on the CPU an exact
    product (int8 products summed in f64: exact while K * 127^2 < 2^53)."""
    (M, K), N = a.shape, b_t.shape[0]
    if a.device.type == "cuda":
        if M <= 16 or K % 8 or N % 8:
            raise ValueError(f"int8 product ({M}, {K}) x ({K}, {N}): torch._int_mm takes "
                             "more than 16 rows and K, N multiples of 8")
        return torch._int_mm(a.contiguous(), b_t.contiguous().t())
    if a.device.type != "cpu":
        raise ValueError(f"int8 product on {a.device}: the port runs on cuda or the cpu")
    return (a.double() @ b_t.double().t()).to(torch.int32)


class QuantLinear(nn.Module):
    """nn.Linear with int8 weight storage (JAX `QuantDense`): `weight_q`
    (out, in) int8, `weight_scale` (out,) f32, `bias` (out,) f32, all
    buffers (a quantised layer is not trained). Built with zero weights and
    unit scales, as JAX's `init`; real values come from
    `quantize_state_dict`. The input is cast to `dt` (None: kept), and the
    output has its dtype, as flax's `dtype=`."""

    def __init__(self, in_features: int, out_features: int, mode: str):
        super().__init__()
        if mode not in ("w8", "w8a8"):
            raise ValueError(f"QuantLinear mode {mode!r}; expected 'w8' or 'w8a8'")
        self.mode = mode
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features))

    def forward(self, x: torch.Tensor, dt=None) -> torch.Tensor:
        if dt is not None:
            x = x.to(dt)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        w = tp.full(self.weight_q)  # whole where tensor-parallel sharding split it
        if self.mode == "w8":
            # the weight in the activation dtype (exact) and the products
            # summed in f32: an f32 product of the two is the same sum
            f = acc_dtype(x2.dtype)
            y = (x2.to(f) @ w.to(x2.dtype).to(f).t()) * self.weight_scale
        else:
            xq, xs = _quant_rows(x2)
            y = int_mm(xq, w).float() * xs * self.weight_scale
        y = y + self.bias
        return y.to(x.dtype).reshape(*lead, self.out_features)


def quantize_state_dict(fp: Mapping[str, torch.Tensor], template: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """An fp `state_dict` onto a quantised model's keys (JAX `quantize_like`,
    quant.py:99-129). Wherever `template` (the quantised model's
    `state_dict`) holds `<layer>.weight_q`, `fp` must hold `<layer>.weight`
    (out, in), which is quantised per output channel into `weight_q` and
    `weight_scale`, and its `<layer>.bias`. Every other entry passes
    through from `fp`. Raises ValueError where the two trees do not match:
    a key on one side only, or a shape that differs."""
    layers = {k[: -len(".weight_q")] for k in template if k.endswith(".weight_q")}
    out: Dict[str, torch.Tensor] = {}
    for name in sorted(layers):
        w = fp.get(name + ".weight")
        if w is None:
            raise ValueError(f"tree mismatch: no fp weight {name}.weight for {name}.weight_q")
        if tuple(w.shape) != tuple(template[name + ".weight_q"].shape):
            raise ValueError(f"tree mismatch at {name}: fp weight {tuple(w.shape)}, quantised "
                             f"{tuple(template[name + '.weight_q'].shape)}")
        q, s = quantize_kernel(w.detach().float().cpu().numpy().T)
        out[name + ".weight_q"] = torch.from_numpy(np.ascontiguousarray(q.T))
        out[name + ".weight_scale"] = torch.from_numpy(s)
        out[name + ".bias"] = fp[name + ".bias"].detach().float().cpu().clone()
    consumed = {n + sfx for n in layers for sfx in (".weight", ".bias")}
    rest_fp = set(fp) - consumed
    rest_t = set(template) - set(out)
    if rest_fp != rest_t:
        raise ValueError(f"tree mismatch: {sorted(rest_fp ^ rest_t)}")
    for k in rest_t:
        if tuple(fp[k].shape) != tuple(template[k].shape):
            raise ValueError(f"tree mismatch at {k}: {tuple(fp[k].shape)} vs "
                             f"{tuple(template[k].shape)}")
        out[k] = fp[k]
    return out
