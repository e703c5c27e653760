"""Beta schedules and the diffusion coefficient tables (JAX package
`diffusion/schedule.py`; reference `diffusion_utils.py:5-45`,
`diffusion_trainer.py:46-76`).

The betas are computed in float64 numpy and cast to float32 before the
tables are derived (in float32 numpy), exactly as the reference's
`to_torch(betas)` does and in that order; the tables then become torch
tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def get_beta_schedule(beta_schedule: str, *, beta_start: float, beta_end: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    """Betas (T,) in float64: quad | linear | const | jsd | sigmoid | cosine."""
    T = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(T, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(T, 1, T, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, T)
        betas = 1.0 / (1.0 + np.exp(-x)) * (beta_end - beta_start) + beta_start
    elif beta_schedule == "cosine":
        # the reference evaluates the cosine on linspace(0, T+1, T+1)
        steps = T + 1
        s = 0.008
        x = np.linspace(0, steps, steps)
        alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
        alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
        betas = np.clip(1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1]), 0, 0.999)
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (T,)
    return betas


class DiffusionSchedule(NamedTuple):
    """Per-timestep coefficient tables, each (T,) float32 (CPU tensors)."""

    betas: torch.Tensor
    alphas_hat: torch.Tensor
    alphas_hat_prev: torch.Tensor
    sqrt_alphas_hat: torch.Tensor
    sqrt_one_minus_alphas_hat: torch.Tensor
    log_one_minus_alphas_hat: torch.Tensor
    sqrt_recip_alphas_hat: torch.Tensor
    sqrt_recipm1_alphas_hat: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(beta_schedule: str = "cosine", beta_start: float = 0.0001,
                  beta_end: float = 0.02,
                  num_diffusion_timesteps: int = 1000) -> DiffusionSchedule:
    betas = get_beta_schedule(beta_schedule, beta_start=beta_start, beta_end=beta_end,
                              num_diffusion_timesteps=num_diffusion_timesteps
                              ).astype(np.float32)
    alphas = 1.0 - betas
    alphas_hat = np.cumprod(alphas, axis=0)
    alphas_hat_prev = np.concatenate([np.ones(1, np.float32), alphas_hat[:-1]])
    posterior_variance = betas * (1.0 - alphas_hat_prev) / (1.0 - alphas_hat)
    t = torch.from_numpy
    return DiffusionSchedule(
        betas=t(betas),
        alphas_hat=t(alphas_hat),
        alphas_hat_prev=t(alphas_hat_prev),
        sqrt_alphas_hat=t(np.sqrt(alphas_hat)),
        sqrt_one_minus_alphas_hat=t(np.sqrt(1.0 - alphas_hat)),
        log_one_minus_alphas_hat=t(np.log(1.0 - alphas_hat)),
        sqrt_recip_alphas_hat=t(np.sqrt(1.0 / alphas_hat)),
        sqrt_recipm1_alphas_hat=t(np.sqrt(1.0 / alphas_hat - 1.0)),
        posterior_variance=t(posterior_variance),
        posterior_log_variance_clipped=t(np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=t(betas * np.sqrt(alphas_hat) / (1.0 - alphas_hat)),
        posterior_mean_coef2=t((1.0 - alphas_hat_prev) * np.sqrt(alphas) / (1.0 - alphas_hat)),
    )


def q_sample(schedule: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward noising x_t = sqrt(a-bar_t) x0 + sqrt(1 - a-bar_t) eps, for a
    scalar or a (B,) t (JAX `schedule.py:130`; reference
    diffusion_trainer.py:122-137)."""
    return (_coef(schedule.sqrt_alphas_hat, t, x_start) * x_start
            + _coef(schedule.sqrt_one_minus_alphas_hat, t, x_start) * noise)


def _coef(table: torch.Tensor, t, like: torch.Tensor) -> torch.Tensor:
    """table[t] on `like`'s device, shaped to broadcast over a (B, ...) x
    where t is (B,), as `q_sample` does; a scalar t gives a scalar."""
    t = torch.as_tensor(t, device=like.device).long()
    shape = (-1,) + (1,) * (like.ndim - 1) if t.ndim else ()
    return table.to(like.device)[t].reshape(shape)


def predict_noise_from_start(schedule: DiffusionSchedule, x_t: torch.Tensor, t,
                             x0: torch.Tensor) -> torch.Tensor:
    """eps = (x_t / sqrt(a-bar) - x0) / sqrt(1/a-bar - 1) (JAX
    `schedule.py:150`; reference diffusion_trainer.py:434-437); t an int or
    a tensor."""
    return ((_coef(schedule.sqrt_recip_alphas_hat, t, x_t) * x_t - x0)
            / _coef(schedule.sqrt_recipm1_alphas_hat, t, x_t))


def predict_start_from_noise(schedule: DiffusionSchedule, x_t: torch.Tensor, t,
                             noise: torch.Tensor) -> torch.Tensor:
    """x0 = x_t sqrt(1/a-bar) - eps sqrt(1/a-bar - 1) (JAX `schedule.py:161`;
    reference diffusion_trainer.py:482-486); t an int or a tensor."""
    return (_coef(schedule.sqrt_recip_alphas_hat, t, x_t) * x_t
            - _coef(schedule.sqrt_recipm1_alphas_hat, t, x_t) * noise)
