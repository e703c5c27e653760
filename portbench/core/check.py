"""The comparison that decides `correct`: what the timed path produced,
against the plain float32 reference of `portbench/reference/`, run after
the window on the same weights and inputs, which it draws again from the
seed.

Inference: the maps of a sample of the window's batches (drawn from the
seed, and the window's last ones), each against the reference's map of
the same input: the widest gap over every pixel (`map_max_abs`) and the
worst batch's relative L2 (`map_rel_l2`).

Training: the three steps that set-up drove through the window's own
call, followed by the reference from the same weights, batches and
random draws: each step's loss (`loss_gap`, relative), the norm of the
first gradient as the optimizer got it, before its global-norm clip
(Adam's first moment after one step over 1 - beta1, times the returned
global norm over the clip where it clipped) and the norm of the parameters' change after the
three, each by the worst leaf: the gap between the port's norm and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf (`grad_gap`, `change_gap`). Leaves whose reference
gradient is under a thousandth of the median leaf's (nought to rounding)
are left out of the change: Adam moves them by round-off alone."""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from portbench.core import data
from portbench.reference import diffusion as ref_diff
from portbench.reference import model as ref_model

NEGLIGIBLE_GRAD = 1e-3


def reference_model(model_cfg: dict, seed: int, device, train: bool):
    model = ref_model.build(model_cfg, device)
    model.load_state_dict(data.draw_weights(model_cfg, seed, device), strict=True)
    return model.train(train)


def fp32_exact():
    """The reference's products in float32 proper, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def reference_maps(model_cfg: dict, traffic: dict, seed: int, device, batches) -> List[torch.Tensor]:
    """The reference's maps (on the host) of each of the cell's batches."""
    fp32_exact()
    model = reference_model(model_cfg, seed, device, train=False)
    out = [ref_diff.sample(model, ref_diff.Schedule(), traffic["sampler"], b["rgb"],
                           b.get("audio"), b["noise"]).cpu() for b in batches]
    del model
    gc.collect()
    return out


def map_numbers(kept: Dict[int, torch.Tensor], refs: List[torch.Tensor]) -> Dict[str, float]:
    """kept: window iteration -> its maps on the host."""
    n = len(refs)
    worst_abs, worst_rel = 0.0, 0.0
    for i, got in kept.items():
        ref = refs[i % n]
        d = (got.float() - ref).reshape(-1)
        worst_abs = max(worst_abs, _finite(d.abs().max()))
        worst_rel = max(worst_rel, _finite(d.norm() / ref.reshape(-1).norm().clamp_min(1e-30)))
    return {"map_max_abs": worst_abs, "map_rel_l2": worst_rel}


def _finite(x) -> float:
    """x as a float, with NaN read as infinitely far off."""
    x = float(x)
    return x if np.isfinite(x) else float("inf")


def reference_steps(model_cfg: dict, traffic: dict, seed: int, device, batches):
    """The reference's checked steps: (losses, the first step's gradients
    before the clip, the parameters' change after the last), by name. MViT
    recomputes each block in the backward, so that the f32 step with its
    materialised attention scores fits beside the run's state."""
    fp32_exact()
    model = reference_model(model_cfg, seed, device, train=True)
    model.visual_net.remat = True
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    p0 = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    o = traffic["optim"]
    opt = ref_diff.Adam(model.parameters(), lr=float(np.float32(o["lr"])), clip=o["grad_clip"])
    gen = torch.Generator(device=device).manual_seed(data.subseed(seed, "steps"))
    sched = ref_diff.Schedule()
    losses, g1 = [], None
    for i in range(traffic["checked_steps"]):
        loss, grads = ref_diff.train_step(model, sched, opt, batches[i % len(batches)], gen)
        losses.append(float(loss))
        if i == 0:
            g1 = dict(zip(names, grads))
    change = {n: p.detach() - p0[n] for n, p in model.named_parameters() if p.requires_grad}
    del model, opt, p0
    gc.collect()
    return losses, g1, change


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(v.double().norm()) for n, v in d.items()}


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], leaves=None) -> Dict[str, float]:
    """Per leaf |got - ref| / max(ref leaf, median ref leaf)."""
    leaves = list(leaves if leaves is not None else ref)
    med = float(np.median([ref[n] for n in leaves]))
    return {n: _finite(abs(got[n] - ref[n]) / max(ref[n], med, 1e-30)) for n in leaves}


def step_numbers(port_losses, port_g1, port_change, ref_losses, ref_g1, ref_change):
    """The training comparison: the worst step's loss gap and the first
    step's; the worst leaf's and the median leaf's gap of the first
    gradient's norm and of the change's norm."""
    losses = [_finite(abs(a - b) / abs(b)) for a, b in zip(port_losses, ref_losses)]
    rg = _norms(ref_g1)
    med = float(np.median(list(rg.values())))
    moved = [n for n, v in rg.items() if v >= NEGLIGIBLE_GRAD * med]
    grad = leaf_gaps(_norms(port_g1), rg)
    change = leaf_gaps(_norms(port_change), _norms(ref_change), moved)
    numbers = {"loss_gap": max(losses), "loss1_gap": losses[0],
               "grad_gap": max(grad.values()), "grad_gap_median": float(np.median(list(grad.values()))),
               "change_gap": max(change.values()),
               "change_gap_median": float(np.median(list(change.values())))}
    return numbers, {"grad_leaf": max(grad, key=grad.get), "change_leaf": max(change, key=change.get),
                     "left_out": len(rg) - len(moved), "loss_gaps": losses}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number with a limit is finite and within it; numbers without
    one are reported and not compared."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= lim for k, lim in limits.items())
