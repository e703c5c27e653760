"""DDIM and DDPM reverse-process samplers (JAX package
`diffusion/sampling.py`; reference `diffusion_trainer.py:439-543`).

`denoise_fn(x_t, t_vec)` returns the model's prediction; conditioning
features are encoded once by the caller and captured by the closure.
With the shipping config (timesteps=1, eta=0, x0 target) DDIM is one
denoiser call at t=0 that returns x_start (NFE=1).

Per-step coefficients are computed on the host in float64 from the
float32 tables, as the JAX package does. Noise for eta > 0 and DDPM is
drawn from the caller's `torch.Generator`; the JAX package's draws differ,
so tests hand both sides the same starting noise and use eta = 0.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from diff_sal_tpu_torch.diffusion.schedule import DiffusionSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ddim_timesteps(num_timesteps: int, timesteps: int):
    """range(0, T, T // steps) walked in reverse with predecessor pairs."""
    skip = num_timesteps // timesteps
    seq = list(range(0, num_timesteps, skip))
    seq_next = [-1] + seq[:-1]
    return list(zip(reversed(seq), reversed(seq_next)))


def _randn_like(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    g_dev = generator.device if generator is not None else x.device
    return torch.randn(x.shape, generator=generator, dtype=x.dtype, device=g_dev).to(x.device)


def ddim_sample(schedule: DiffusionSchedule, denoise_fn: DenoiseFn, x: torch.Tensor, *,
                timesteps: int = 1, eta: float = 0.0, training_target: str = "x0",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Generalized (eta-parameterized) DDIM; the last step returns x_start."""
    ah = schedule.alphas_hat.double().numpy()
    sa = schedule.sqrt_alphas_hat.double().numpy()
    sra = schedule.sqrt_recip_alphas_hat.double().numpy()
    srm = schedule.sqrt_recipm1_alphas_hat.double().numpy()
    B = x.shape[0]
    for time, time_next in ddim_timesteps(schedule.num_timesteps, timesteps):
        t_vec = torch.full((B,), float(time), device=x.device)
        if training_target == "x0":
            x_start = denoise_fn(x, t_vec)
            if time_next < 0:
                return x_start
            pred_noise = (float(sra[time]) * x - x_start) / float(srm[time])
        else:
            pred_noise = denoise_fn(x, t_vec)
            x_start = (x - pred_noise * float(np.sqrt(1.0 - ah[time]))) / float(np.sqrt(ah[time]))
            if time_next < 0:
                return x_start
        alpha, alpha_next = float(ah[time]), float(ah[time_next])
        c1 = eta * float(np.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha)))
        c2 = float(np.sqrt(max((1 - alpha_next) - c1 ** 2, 0.0)))
        noise = c1 * _randn_like(x, generator) if eta > 0 else 0.0
        x = float(sa[time_next]) * x_start + noise + c2 * pred_noise
    return x


def ddpm_sample(schedule: DiffusionSchedule, denoise_fn: DenoiseFn, x: torch.Tensor, *,
                timesteps: Optional[int] = None, training_target: str = "x0",
                clip_denoised: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Ancestral DDPM over the (possibly strided) timestep grid. The
    reference's clamp is a no-op, hence clip_denoised=False by default."""
    T = schedule.num_timesteps
    skip = T // (timesteps or T)
    B = x.shape[0]
    f32 = lambda a, i: float(np.float32(a[i]))  # noqa: E731
    sr = schedule.sqrt_recip_alphas_hat.numpy()
    srm = schedule.sqrt_recipm1_alphas_hat.numpy()
    c1s = schedule.posterior_mean_coef1.numpy()
    c2s = schedule.posterior_mean_coef2.numpy()
    logv = schedule.posterior_log_variance_clipped.numpy()
    for time in list(range(0, T, skip))[::-1]:
        t_vec = torch.full((B,), float(time), device=x.device)
        if training_target == "x0":
            x_recon = denoise_fn(x, t_vec)
        else:
            x_recon = f32(sr, time) * x - f32(srm, time) * denoise_fn(x, t_vec)
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        mean = f32(c1s, time) * x_recon + f32(c2s, time) * x
        sigma = float(np.exp(np.float32(0.5) * logv[time])) if time > 0 else 0.0
        x = mean + sigma * _randn_like(x, generator)
    return x
