"""Adam + MultiStepLR + global-norm gradient clip with optax's semantics
(JAX package `train/optim.py`; reference `util/utils.py:116-123`,
`cfgs/diffusion.yml:53-60`), which differ from torch's in three places:

  * the clip scales the gradients by max_norm / norm only when norm >=
    max_norm (as (g / norm) * max_norm), where torch's `clip_grad_norm_`
    scales by max_norm / (norm + 1e-6);
  * the learning rate of update `count` (0-based) is the piecewise-constant
    schedule at `count`, with boundaries at int(frac * epochs *
    steps_per_epoch) and the factor applied from the boundary on;
  * bias correction uses count + 1 and eps is added outside the square
    root: u = m_hat / (sqrt(v_hat) + eps).

Every trainable parameter takes part; one without a gradient this step
counts as a zero gradient, as JAX's gradient tree would give it. Frozen
parameters (requires_grad False, the VGGish trunk) are left unchanged.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from diff_sal_tpu_torch.config import OptimConfig
from diff_sal_tpu_torch.ops.kernels import acc_dtype

BETA2 = 0.999


def multistep_lr(base_lr: float, steps_per_epoch: int, n_epochs: int,
                 milestone_fracs=(0.5, 0.75), gamma: float = 0.1) -> Callable[[int], float]:
    """optax.piecewise_constant_schedule at epoch-fraction milestones, in
    f32 as optax computes it."""
    boundaries = {int(frac * n_epochs * steps_per_epoch): gamma for frac in milestone_fracs}

    def schedule(count: int) -> float:
        v = np.float32(base_lr)
        for b, s in sorted(boundaries.items()):
            if count >= b:
                v = np.float32(v * np.float32(s))
        return float(v)

    return schedule


class Optimizer:
    """Adam(b1, 0.999, eps) or AdamW, after a global-norm clip, on the
    trainable parameters of a model. `step()` reads each parameter's
    `.grad`, updates the parameters in place and returns the global norm
    of the raw gradients. `ema` holds the parameter EMA shadow when the
    training step keeps one."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: OptimConfig,
                 schedule: Callable[[int], float]):
        if cfg.optimizer.lower() != "adam":
            raise NotImplementedError(cfg.optimizer)
        self.cfg = cfg
        self.schedule = schedule
        self.params = [p for p in params if p.requires_grad]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.ema: Optional[Dict[str, torch.Tensor]] = None

    def state_dict(self, names: List[str]) -> Dict:
        """Adam's moments by parameter name (`names`: the trainable
        parameters' names, in the order the optimizer holds them), the
        update count and the EMA shadow (None when off)."""
        assert len(names) == len(self.params), (len(names), len(self.params))
        return {"count": self.count, "mu": dict(zip(names, self.mu)),
                "nu": dict(zip(names, self.nu)), "ema": self.ema}

    @torch.no_grad()
    def load_state_dict(self, state: Dict, names: List[str]):
        """The inverse of `state_dict`, copied into the optimizer's own
        tensors."""
        assert len(names) == len(self.params), (len(names), len(self.params))
        for mine, key in ((self.mu, "mu"), (self.nu, "nu")):
            for t, n in zip(mine, names):
                t.copy_(state[key][n])
        self.count = int(state["count"])
        ema = state.get("ema")
        self.ema = None if ema is None else {
            n: v.to(self.params[0].device).clone() for n, v in ema.items()}

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        cfg = self.cfg
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm([g.to(acc_dtype(g.dtype)) for g in grads])))
        if cfg.grad_clip:
            clip = torch.where(norm < cfg.grad_clip, torch.ones_like(norm),
                               cfg.grad_clip / norm)
            grads = torch._foreach_mul(grads, clip)
        b1, count = cfg.beta1, self.count + 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, BETA2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - BETA2)
        bc1 = float(1 - np.float32(b1) ** count)
        bc2 = float(1 - np.float32(BETA2) ** count)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        if cfg.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=cfg.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-self.schedule(self.count))
        self.count += 1
        return norm


def make_optimizer_and_schedule(model: torch.nn.Module, cfg: OptimConfig,
                                steps_per_epoch: int, n_epochs: int
                                ) -> Tuple[Optimizer, Callable[[int], float]]:
    """(optimizer, lr schedule): the schedule is the function the optimizer
    applies, returned so that a caller logs that same function."""
    schedule = multistep_lr(cfg.lr, steps_per_epoch, n_epochs, cfg.milestone_fracs, cfg.gamma)
    return Optimizer(model.parameters(), cfg, schedule), schedule


def make_optimizer(model: torch.nn.Module, cfg: OptimConfig, steps_per_epoch: int,
                   n_epochs: int) -> Optimizer:
    """The optimizer over `model`'s trainable parameters, with the
    MultiStepLR schedule of `cfg` (JAX `make_optimizer`)."""
    return make_optimizer_and_schedule(model, cfg, steps_per_epoch, n_epochs)[0]
