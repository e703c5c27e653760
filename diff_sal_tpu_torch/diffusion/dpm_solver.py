"""DPM-Solver and DPM-Solver++ (orders 1-3, singlestep and multistep), the
JAX package's `diffusion/dpm_solver.py` (reference
`models/dpm_solver/sampler.py:6-1247`): the discrete-beta VP noise schedule
with logSNR clipping at -5.1, logSNR / time_uniform / time_quadratic step
spacing, noise- and data-prediction algorithms, `lower_order_final`,
`denoise_to_zero` and dynamic thresholding.

As in the JAX package, every timestep, lambda, alpha and sigma is a
float64 scalar computed on the host from the betas; only `x` and the
model outputs are tensors. So the sampler is a fixed chain of denoiser
calls and elementwise updates, and the two packages agree to f32 rounding.
The parameterization follows `training_target` (the reference's glue
asserted eps-prediction against an x0-trained model).

Not ported: `model_wrapper` (guidance) and `adaptive_sample`; the
inference path calls neither.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

from diff_sal_tpu_torch.config import SamplingConfig
from diff_sal_tpu_torch.diffusion.schedule import DiffusionSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class DiscreteVPSchedule:
    """Continuous-time view of a discrete-beta VP diffusion (reference
    sampler.py:6-167, schedule='discrete'). Methods take and return numpy
    float64 scalars or arrays."""

    def __init__(self, betas: np.ndarray, lambda_min_clip: float = -5.1):
        betas = np.asarray(betas, np.float64)
        log_alphas = 0.5 * np.cumsum(np.log(1.0 - betas))
        N = len(betas)
        t_array = np.linspace(0.0, 1.0, N + 1)[1:]
        # drop the tail where logSNR < lambda_min_clip, as the reference's
        # numerical_clip_alpha does
        lambdas = log_alphas - 0.5 * np.log(1.0 - np.exp(2.0 * log_alphas))
        keep = int(np.sum(lambdas > lambda_min_clip))
        if keep < N:
            log_alphas = log_alphas[:keep]
            t_array = t_array[:keep]
        self.total_N = N
        self.t_array = t_array
        self.log_alpha_array = log_alphas
        self.T = float(t_array[-1])
        self.t_0 = 1.0 / N

    def marginal_log_mean_coeff(self, t):
        return np.interp(t, self.t_array, self.log_alpha_array)

    def marginal_alpha(self, t):
        return np.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_a = self.marginal_log_mean_coeff(t)
        return log_a - 0.5 * np.log(1.0 - np.exp(2.0 * log_a))

    def inverse_lambda(self, lamb):
        lambdas = self.marginal_lambda(self.t_array)  # decreasing in t
        return np.interp(lamb, lambdas[::-1], self.t_array[::-1])

    def model_input_time(self, t):
        """Continuous t -> the discrete timestep the network was trained
        on (reference get_model_input_time)."""
        return (t - 1.0 / self.total_N) * 1000.0


def time_steps(ns: DiscreteVPSchedule, skip_type: str, t_T: float, t_0: float,
               N: int) -> np.ndarray:
    """N + 1 decreasing timesteps from t_T to t_0 (reference
    get_time_steps)."""
    if skip_type == "logSNR":
        lT, l0 = ns.marginal_lambda(t_T), ns.marginal_lambda(t_0)
        return ns.inverse_lambda(np.linspace(lT, l0, N + 1))
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, N + 1)
    if skip_type == "time_quadratic":
        return np.linspace(t_T ** (1 / 2), t_0 ** (1 / 2), N + 1) ** 2
    raise ValueError(f"unknown skip_type {skip_type}")


def singlestep_orders(steps: int, order: int) -> List[int]:
    """Split `steps` model evaluations into per-update orders (reference
    get_orders_and_timesteps_for_singlestep)."""
    if order == 3:
        k = steps // 3 + 1
        if steps % 3 == 0:
            return [3] * (k - 2) + [2, 1]
        if steps % 3 == 1:
            return [3] * (k - 1) + [1]
        return [3] * (k - 1) + [2]
    if order == 2:
        return [2] * (steps // 2) + ([1] if steps % 2 else [])
    return [1] * steps


def _dynamic_threshold(x0: torch.Tensor, ratio: float = 0.995,
                       max_val: float = 1.0) -> torch.Tensor:
    """Imagen-style dynamic thresholding (reference sampler.py:377-388);
    torch.quantile's linear interpolation is jnp.quantile's default."""
    B = x0.shape[0]
    s = torch.quantile(x0.abs().reshape(B, -1), ratio, dim=1)
    s = s.clamp_min(max_val).reshape((B,) + (1,) * (x0.ndim - 1))
    return torch.maximum(torch.minimum(x0, s), -s) / s


class _Solver:
    """DPM-Solver over a denoiser that predicts x0 or the noise."""

    def __init__(self, ns: DiscreteVPSchedule, denoise_fn: DenoiseFn, *,
                 algorithm: str = "dpmsolver", training_target: str = "x0",
                 thresholding: bool = False):
        if algorithm not in ("dpmsolver", "dpmsolver++"):
            raise ValueError(f"unknown algorithm {algorithm}")
        self.ns = ns
        self.denoise_fn = denoise_fn
        self.training_target = training_target
        self.thresholding = thresholding
        self.data_pred = algorithm == "dpmsolver++"

    # ---- model parameterizations ------------------------------------------
    def _raw(self, x: torch.Tensor, t: float) -> torch.Tensor:
        t_in = torch.full((x.shape[0],), float(self.ns.model_input_time(t)),
                          dtype=torch.float32, device=x.device)
        return self.denoise_fn(x, t_in)

    def x0_pred(self, x: torch.Tensor, t: float) -> torch.Tensor:
        raw = self._raw(x, t)
        if self.training_target == "x0":
            x0 = raw
        else:  # the model predicts the noise
            a, s = self._alpha(t), self._sigma(t)
            x0 = (x - s * raw) / a
        if self.thresholding:
            x0 = _dynamic_threshold(x0)
        return x0

    def eps_pred(self, x: torch.Tensor, t: float) -> torch.Tensor:
        if self.training_target == "noise" and not self.thresholding:
            return self._raw(x, t)
        x0 = self.x0_pred(x, t)
        return (x - self._alpha(t) * x0) / self._sigma(t)

    def model(self, x: torch.Tensor, t: float) -> torch.Tensor:
        return self.x0_pred(x, t) if self.data_pred else self.eps_pred(x, t)

    # ---- update rules ---------------------------------------------------
    def _alpha(self, t: float) -> float:
        return float(self.ns.marginal_alpha(t))

    def _sigma(self, t: float) -> float:
        return float(self.ns.marginal_std(t))

    def _lambda(self, t: float) -> float:
        return float(self.ns.marginal_lambda(t))

    def _coef(self, t: float):
        return self._alpha(t), self._sigma(t), self._lambda(t)

    def first_order_update(self, x, s: float, t: float, m_s):
        a_s, sig_s, l_s = self._coef(s)
        a_t, sig_t, l_t = self._coef(t)
        h = l_t - l_s
        if self.data_pred:
            return (sig_t / sig_s) * x - a_t * math.expm1(-h) * m_s
        return (a_t / a_s) * x - sig_t * math.expm1(h) * m_s

    def multistep_second_update(self, x, tl, ml, t: float):
        (t0, t1), (m0, m1) = tl, ml  # t0 the more recent
        a_p, sig_p, l0 = self._coef(t0)
        a_t, sig_t, l_t = self._coef(t)
        l1 = self._lambda(t1)
        h, h0 = l_t - l0, l0 - l1
        r0 = h0 / h
        D1 = (1.0 / r0) * (m0 - m1)
        if self.data_pred:
            phi = math.expm1(-h)
            return (sig_t / sig_p) * x - a_t * phi * m0 - 0.5 * a_t * phi * D1
        phi = math.expm1(h)
        return (a_t / a_p) * x - sig_t * phi * m0 - 0.5 * sig_t * phi * D1

    def multistep_third_update(self, x, tl, ml, t: float):
        (t0, t1, t2), (m0, m1, m2) = tl, ml
        a_p, sig_p, l0 = self._coef(t0)
        a_t, sig_t, l_t = self._coef(t)
        l1, l2 = self._lambda(t1), self._lambda(t2)
        h, h0, h1 = l_t - l0, l0 - l1, l1 - l2
        r0, r1 = h0 / h, h1 / h
        D1_0 = (1.0 / r0) * (m0 - m1)
        D1_1 = (1.0 / r1) * (m1 - m2)
        D1 = D1_0 + (r0 / (r0 + r1)) * (D1_0 - D1_1)
        D2 = (1.0 / (r0 + r1)) * (D1_0 - D1_1)
        if self.data_pred:
            phi_1 = math.expm1(-h)
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            return ((sig_t / sig_p) * x - a_t * phi_1 * m0 + a_t * phi_2 * D1
                    - a_t * phi_3 * D2)
        phi_1 = math.expm1(h)
        phi_2 = phi_1 / h - 1.0
        phi_3 = phi_2 / h - 0.5
        return ((a_t / a_p) * x - sig_t * phi_1 * m0 - sig_t * phi_2 * D1
                - sig_t * phi_3 * D2)

    def singlestep_second_update(self, x, s: float, t: float, r1: float = 0.5):
        a_s, sig_s, l_s = self._coef(s)
        a_t, sig_t, l_t = self._coef(t)
        h = l_t - l_s
        s1 = float(self.ns.inverse_lambda(l_s + r1 * h))
        a_s1, sig_s1, _ = self._coef(s1)
        m_s = self.model(x, s)
        if self.data_pred:
            phi_11 = math.expm1(-r1 * h)
            phi_1 = math.expm1(-h)
            x_s1 = (sig_s1 / sig_s) * x - a_s1 * phi_11 * m_s
            m_s1 = self.model(x_s1, s1)
            return ((sig_t / sig_s) * x - a_t * phi_1 * m_s
                    - (0.5 / r1) * a_t * phi_1 * (m_s1 - m_s))
        phi_11 = math.expm1(r1 * h)
        phi_1 = math.expm1(h)
        x_s1 = (a_s1 / a_s) * x - sig_s1 * phi_11 * m_s
        m_s1 = self.model(x_s1, s1)
        return ((a_t / a_s) * x - sig_t * phi_1 * m_s
                - (0.5 / r1) * sig_t * phi_1 * (m_s1 - m_s))

    def singlestep_third_update(self, x, s: float, t: float, r1: float = 1.0 / 3.0,
                                r2: float = 2.0 / 3.0):
        a_s, sig_s, l_s = self._coef(s)
        a_t, sig_t, l_t = self._coef(t)
        h = l_t - l_s
        s1 = float(self.ns.inverse_lambda(l_s + r1 * h))
        s2 = float(self.ns.inverse_lambda(l_s + r2 * h))
        a_s1, sig_s1, _ = self._coef(s1)
        a_s2, sig_s2, _ = self._coef(s2)
        m_s = self.model(x, s)
        if self.data_pred:
            phi_11 = math.expm1(-r1 * h)
            phi_12 = math.expm1(-r2 * h)
            phi_1 = math.expm1(-h)
            phi_22 = math.expm1(-r2 * h) / (r2 * h) + 1.0
            phi_2 = phi_1 / h + 1.0
            x_s1 = (sig_s1 / sig_s) * x - a_s1 * phi_11 * m_s
            m_s1 = self.model(x_s1, s1)
            x_s2 = ((sig_s2 / sig_s) * x - a_s2 * phi_12 * m_s
                    + (r2 / r1) * a_s2 * phi_22 * (m_s1 - m_s))
            m_s2 = self.model(x_s2, s2)
            return ((sig_t / sig_s) * x - a_t * phi_1 * m_s
                    + (1.0 / r2) * a_t * phi_2 * (m_s2 - m_s))
        phi_11 = math.expm1(r1 * h)
        phi_12 = math.expm1(r2 * h)
        phi_1 = math.expm1(h)
        phi_22 = math.expm1(r2 * h) / (r2 * h) - 1.0
        phi_2 = phi_1 / h - 1.0
        x_s1 = (a_s1 / a_s) * x - sig_s1 * phi_11 * m_s
        m_s1 = self.model(x_s1, s1)
        x_s2 = ((a_s2 / a_s) * x - sig_s2 * phi_12 * m_s
                - (r2 / r1) * sig_s2 * phi_22 * (m_s1 - m_s))
        m_s2 = self.model(x_s2, s2)
        return ((a_t / a_s) * x - sig_t * phi_1 * m_s
                - (1.0 / r2) * sig_t * phi_2 * (m_s2 - m_s))

    # ---- samplers ---------------------------------------------------------
    def sample_multistep(self, x, steps: int, skip_type: str = "logSNR", order: int = 2,
                         lower_order_final: bool = False):
        ns = self.ns
        ts = time_steps(ns, skip_type, ns.T, ns.t_0, steps)
        model_list = [self.model(x, float(ts[0]))]
        t_list = [float(ts[0])]
        # warm-up with increasing orders (reference sample(), method='multistep')
        for i in range(1, order):
            t = float(ts[i])
            x = self._multistep_update(x, t_list, model_list, t, order=i)
            t_list.append(t)
            model_list.append(self.model(x, t))
        for i in range(order, steps + 1):
            t = float(ts[i])
            step_order = min(order, steps + 1 - i) if lower_order_final else order
            x = self._multistep_update(x, t_list, model_list, t, order=step_order)
            t_list.append(t)
            model_list.append(self.model(x, t) if i < steps else None)
            t_list, model_list = t_list[-order:], model_list[-order:]
        return x

    def _multistep_update(self, x, t_list, model_list, t, order):
        if order == 1:
            return self.first_order_update(x, t_list[-1], t, model_list[-1])
        if order == 2:
            return self.multistep_second_update(
                x, (t_list[-1], t_list[-2]), (model_list[-1], model_list[-2]), t)
        if order == 3:
            return self.multistep_third_update(
                x, (t_list[-1], t_list[-2], t_list[-3]),
                (model_list[-1], model_list[-2], model_list[-3]), t)
        raise ValueError(order)

    def sample_singlestep(self, x, steps: int, skip_type: str = "logSNR", order: int = 2):
        ns = self.ns
        orders = singlestep_orders(steps, order)
        if skip_type == "logSNR":
            # one spacing per update, as the reference splits by order
            ts = time_steps(ns, skip_type, ns.T, ns.t_0, len(orders))
        else:
            full = time_steps(ns, skip_type, ns.T, ns.t_0, steps)
            ts = full[np.cumsum([0] + orders)]
        for i, o in enumerate(orders):
            s, t = float(ts[i]), float(ts[i + 1])
            if o == 1:
                x = self.first_order_update(x, s, t, self.model(x, s))
            elif o == 2:
                x = self.singlestep_second_update(x, s, t)
            else:
                x = self.singlestep_third_update(x, s, t)
        return x

    def denoise_to_zero(self, x):
        return self.x0_pred(x, self.ns.t_0)


def dpm_solver_sample(schedule: DiffusionSchedule, denoise_fn: DenoiseFn, x: torch.Tensor, *,
                      sampling: SamplingConfig, training_target: str = "x0") -> torch.Tensor:
    """Run DPM-Solver per the sampling config (reference sample_image's
    dpmsolver branch, diffusion_trainer.py:582-636). With `denoise` the
    last of the `timesteps` denoiser calls is the denoise-to-zero step."""
    ns = DiscreteVPSchedule(schedule.betas.double().numpy())
    solver = _Solver(ns, denoise_fn, algorithm=sampling.sample_type,
                     training_target=training_target, thresholding=sampling.thresholding)
    steps = max(sampling.timesteps - 1 if sampling.denoise else sampling.timesteps, 1)
    order = min(sampling.dpm_solver_order, steps)
    if sampling.dpm_solver_method == "multistep":
        x = solver.sample_multistep(x, steps, skip_type=sampling.skip_type, order=order,
                                    lower_order_final=sampling.lower_order_final)
    elif sampling.dpm_solver_method in ("singlestep", "singlestep_fixed"):
        x = solver.sample_singlestep(x, steps, skip_type=sampling.skip_type, order=order)
    else:
        raise NotImplementedError(sampling.dpm_solver_method)
    if sampling.denoise:
        x = solver.denoise_to_zero(x)
    return x
