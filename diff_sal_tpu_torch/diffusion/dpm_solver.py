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

`model_wrapper` turns a network predicting the noise, x0, v or the score
into a continuous-time noise predictor with classifier or
classifier-free guidance; `dpm_solver_sample(..., wrapped_eps_fn=...)`
and `adaptive_sample(..., wrapped_eps_fn=...)` sample with it.
`adaptive_sample` is the adaptive-step DPM-Solver-12 / -23: its step
size depends on the data, so its times are f32 scalars on the host,
looked up by `interp` as the JAX package's traced `jnp.interp` does, and
each step reads its error norm back from the device once.
`SamplingConfig` has no adaptive fields: `adaptive_sample` takes `atol`
and `rtol` as arguments and `dpm_solver_sample` raises on
`dpm_solver_method="adaptive"`, as in JAX.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

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


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation with `jnp.interp`'s arithmetic and
    end behaviour: the segment from `searchsorted(side="right")` clipped
    to [1, len - 1], fp[i-1] + (x - xp[i-1]) / dx * df (fp[i-1] where
    |dx| is below the dtype's smallest step above eps), and fp[0] / fp[-1]
    outside [xp[0], xp[-1]]. xp increasing; all three in one dtype."""
    i = torch.searchsorted(xp, x.reshape(-1), right=True).clamp(1, len(xp) - 1).reshape(x.shape)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo({torch.float32: np.float32,
                                     torch.float64: np.float64}[xp.dtype]).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class _TracedSchedule:
    """The f32 view of DiscreteVPSchedule that JAX's adaptive loop traces
    (JAX `_TracedSchedule`, dpm_solver.py:544): the grids as f32 tensors on
    the host, times as f32 scalar tensors; `adaptive_sample` and
    `model_wrapper` (at such times) read the schedule through it."""

    def __init__(self, ns: DiscreteVPSchedule):
        self.t_array = torch.tensor(ns.t_array, dtype=torch.float32)
        self.log_alpha_array = torch.tensor(ns.log_alpha_array, dtype=torch.float32)
        lambdas = np.asarray(ns.marginal_lambda(ns.t_array), np.float64)
        self._lam_rev = torch.tensor(lambdas[::-1].copy(), dtype=torch.float32)
        self._t_rev = torch.tensor(ns.t_array[::-1].copy(), dtype=torch.float32)
        self.total_N = ns.total_N

    def log_alpha(self, t):
        return interp(t, self.t_array, self.log_alpha_array)

    def alpha(self, t):
        return torch.exp(self.log_alpha(t))

    def sigma(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * self.log_alpha(t)))

    def lam(self, t):
        la = self.log_alpha(t)
        return la - 0.5 * torch.log(1.0 - torch.exp(2.0 * la))

    def inverse_lambda(self, lamb):
        return interp(lamb, self._lam_rev, self._t_rev)

    def model_input_time(self, t):
        return (t - 1.0 / self.total_N) * 1000.0


def model_wrapper(model_fn: Callable, ns: DiscreteVPSchedule, *, model_type: str = "noise",
                  guidance_type: str = "uncond", condition=None, unconditional_condition=None,
                  guidance_scale: float = 1.0, classifier_fn: Optional[Callable] = None
                  ) -> Callable[[torch.Tensor, object], torch.Tensor]:
    """Wrap a network into a continuous-time NOISE predictor with optional
    guidance (JAX `model_wrapper`, dpm_solver.py:123-217; reference
    models/dpm_solver/sampler.py:170-334).

    `model_fn(x, t_input_vec, cond)` is the raw network; `cond` is passed
    through (None for unconditional calls). The returned `eps(x, t)` takes
    t in (0, 1], a host float (the static-step solvers: alpha and sigma
    from the float64 schedule) or an f32 scalar tensor (the adaptive
    solver: `interp` over the schedule's f32 grid, as JAX's traced times),
    and converts what the network predicts (model_type noise / x_start / v
    / score) to the noise; then

      * 'uncond'          plain call,
      * 'classifier'      eps - guidance_scale * sigma * grad_x log p(c|x, t),
                          from `classifier_fn(x, t_input_vec, cond)`'s
                          per-example log-probabilities (torch.autograd),
      * 'classifier-free' e_uncond + s * (e_cond - e_uncond).
    """
    traced = _TracedSchedule(ns)

    def alpha_sigma(t):
        if isinstance(t, torch.Tensor):
            return traced.alpha(t), traced.sigma(t)
        return float(ns.marginal_alpha(t)), float(ns.marginal_std(t))

    def t_in(x, t):
        return torch.full((x.shape[0],), float(ns.model_input_time(t)), dtype=torch.float32,
                          device=x.device)

    def noise_pred(x, t, cond):
        out = model_fn(x, t_in(x, t), cond)
        if model_type == "noise":
            return out
        a, s = alpha_sigma(t)
        if model_type == "x_start":
            return (x - a * out) / s
        if model_type == "v":
            return a * out + s * x
        if model_type == "score":
            return -s * out
        raise ValueError(f"unknown model_type {model_type}")

    if guidance_type == "uncond":
        return lambda x, t: noise_pred(x, t, condition)

    if guidance_type == "classifier":
        if classifier_fn is None:
            raise ValueError("guidance_type='classifier' needs classifier_fn")

        def eps(x, t):
            with torch.enable_grad():
                xi = x.detach().requires_grad_(True)
                grad, = torch.autograd.grad(classifier_fn(xi, t_in(xi, t), condition).sum(), xi)
            _, s = alpha_sigma(t)
            return noise_pred(x, t, None) - guidance_scale * s * grad

        return eps

    if guidance_type == "classifier-free":
        def eps(x, t):
            if guidance_scale == 1.0 or unconditional_condition is None:
                return noise_pred(x, t, condition)
            e_uncond = noise_pred(x, t, unconditional_condition)
            e_cond = noise_pred(x, t, condition)
            return e_uncond + guidance_scale * (e_cond - e_uncond)

        return eps

    raise ValueError(f"unknown guidance_type {guidance_type}")


class _Solver:
    """DPM-Solver over a denoiser that predicts x0 or the noise. With
    `continuous_time` the denoiser takes (x, t) with t the continuous time
    (a `model_wrapper` result) instead of the model-input time vector."""

    def __init__(self, ns: DiscreteVPSchedule, denoise_fn: DenoiseFn, *,
                 algorithm: str = "dpmsolver", training_target: str = "x0",
                 thresholding: bool = False, continuous_time: bool = False):
        if algorithm not in ("dpmsolver", "dpmsolver++"):
            raise ValueError(f"unknown algorithm {algorithm}")
        self.ns = ns
        self.denoise_fn = denoise_fn
        self.training_target = training_target
        self.thresholding = thresholding
        self.data_pred = algorithm == "dpmsolver++"
        self.continuous_time = continuous_time

    # ---- model parameterizations ------------------------------------------
    def _raw(self, x: torch.Tensor, t: float) -> torch.Tensor:
        if self.continuous_time:
            return self.denoise_fn(x, t)
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


def dpm_solver_sample(schedule: DiffusionSchedule, denoise_fn: Optional[DenoiseFn],
                      x: torch.Tensor, *, sampling: SamplingConfig, training_target: str = "x0",
                      wrapped_eps_fn: Optional[Callable] = None) -> torch.Tensor:
    """Run DPM-Solver per the sampling config (reference sample_image's
    dpmsolver branch, diffusion_trainer.py:582-636). With `denoise` the
    last of the `timesteps` denoiser calls is the denoise-to-zero step.
    Pass `wrapped_eps_fn` (a `model_wrapper` result: a continuous-time
    noise predictor, possibly guided) instead of `denoise_fn` to sample
    through it."""
    ns = DiscreteVPSchedule(schedule.betas.double().numpy())
    if wrapped_eps_fn is not None:
        solver = _Solver(ns, wrapped_eps_fn, algorithm=sampling.sample_type,
                         training_target="noise", thresholding=sampling.thresholding,
                         continuous_time=True)
    else:
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


# ---------------------------------------------------------------------------
# Adaptive step-size solver (DPM-Solver-12 / -23, reference
# sampler.py:973-1032): data-dependent control flow as a host loop over f32
# scalar times, the schedule looked up by `interp` over the discrete grid.
# ---------------------------------------------------------------------------


def adaptive_sample(schedule: DiffusionSchedule, denoise_fn: Optional[DenoiseFn],
                    x: torch.Tensor, *, training_target: str = "x0",
                    algorithm: str = "dpmsolver++", order: int = 2, atol: float = 0.0078,
                    rtol: float = 0.05, theta: float = 0.9, h_init: float = 0.05,
                    max_steps: int = 200, wrapped_eps_fn: Optional[Callable] = None,
                    return_stats: bool = False):
    """Adaptive DPM-Solver-12 (order 2) / DPM-Solver-23 (order 3): a lower-
    and a higher-order singlestep update per step, the step accepted where
    their scaled difference is small (JAX `adaptive_sample`,
    dpm_solver.py:575-744; reference sampler.py:973-1032). Order 2
    compares first order with singlestep-2 (r1 = 0.5); order 3 compares
    singlestep-2 (r1 = 1/3) with singlestep-3 (r1 = 1/3, r2 = 2/3), which
    reuses singlestep-2's intermediate model call.

    The error is per element: delta = max(atol, rtol * max(|x_lower|,
    |x_prev|)), then the per-sample RMS of (x_higher - x_lower) / delta,
    its maximum over the batch. JAX runs the loop as a `while_loop`; here
    it is a host loop, and since whether a step is accepted and how long
    the next one is depend on that error, each step reads it back from
    the device once (`float`): the one synchronisation per step a
    data-dependent step size needs. The times (s, t, h) are f32 scalars
    on the host, as JAX's traced ones are f32. The loop ends where s
    reaches t_0 (within 1e-5, the reference's test; JAX's loop goes on to
    `max_steps` there, in steps that change nothing: fault F7) or after
    `max_steps` model calls; then one more call denoises to x0 at t_0.

    `wrapped_eps_fn` (a `model_wrapper` result) replaces `denoise_fn` and
    `training_target`: a continuous-time noise predictor called with the
    loop's f32 times. With `return_stats`, returns (x, {"nfe", "accepted",
    "rejected"}): the loop's model calls (the final denoise not counted,
    as JAX's counter) and its accepted and rejected steps."""
    if order not in (2, 3):
        raise ValueError(f"adaptive_sample takes order 2 or 3, got {order}")
    if algorithm not in ("dpmsolver", "dpmsolver++"):
        raise ValueError(f"unknown algorithm {algorithm}")
    ns_host = DiscreteVPSchedule(schedule.betas.double().numpy())
    ns = _TracedSchedule(ns_host)
    t_0, t_T = ns_host.t_0, ns_host.T
    lambda_0 = float(ns_host.marginal_lambda(t_0))
    data_pred = algorithm == "dpmsolver++"

    def model(x, t):
        if wrapped_eps_fn is not None:
            eps = wrapped_eps_fn(x, t)
            if data_pred:
                return (x - ns.sigma(t) * eps) / ns.alpha(t)
            return eps
        t_in = torch.full((x.shape[0],), float(ns.model_input_time(t)), dtype=torch.float32,
                          device=x.device)
        raw = denoise_fn(x, t_in)
        x0 = raw if training_target == "x0" else (x - ns.sigma(t) * raw) / ns.alpha(t)
        if data_pred:
            return x0
        return (x - ns.alpha(t) * x0) / ns.sigma(t)

    def first_order(x, s, t, m_s):
        h = ns.lam(t) - ns.lam(s)
        if data_pred:
            return (ns.sigma(t) / ns.sigma(s)) * x - ns.alpha(t) * torch.expm1(-h) * m_s
        return (ns.alpha(t) / ns.alpha(s)) * x - ns.sigma(t) * torch.expm1(h) * m_s

    def second_order(x, s, t, m_s, r1=0.5):
        """Singlestep-2 update and its intermediate model call, which
        third_order reuses."""
        h = ns.lam(t) - ns.lam(s)
        s1 = ns.inverse_lambda(ns.lam(s) + r1 * h)
        if data_pred:
            x_s1 = (ns.sigma(s1) / ns.sigma(s)) * x - ns.alpha(s1) * torch.expm1(-r1 * h) * m_s
            m_s1 = model(x_s1, s1)
            x_t = ((ns.sigma(t) / ns.sigma(s)) * x - ns.alpha(t) * torch.expm1(-h) * m_s
                   - (0.5 / r1) * ns.alpha(t) * torch.expm1(-h) * (m_s1 - m_s))
            return x_t, m_s1
        x_s1 = (ns.alpha(s1) / ns.alpha(s)) * x - ns.sigma(s1) * torch.expm1(r1 * h) * m_s
        m_s1 = model(x_s1, s1)
        x_t = ((ns.alpha(t) / ns.alpha(s)) * x - ns.sigma(t) * torch.expm1(h) * m_s
               - (0.5 / r1) * ns.sigma(t) * torch.expm1(h) * (m_s1 - m_s))
        return x_t, m_s1

    def third_order(x, s, t, m_s, m_s1, r1=1.0 / 3.0, r2=2.0 / 3.0):
        """Singlestep-3 update reusing m_s and m_s1 of the order-2 lower
        update (reference dpm_solver_third_update with model_s / model_s1)."""
        h = ns.lam(t) - ns.lam(s)
        s2 = ns.inverse_lambda(ns.lam(s) + r2 * h)
        if data_pred:
            phi_12 = torch.expm1(-r2 * h)
            phi_1 = torch.expm1(-h)
            phi_22 = torch.expm1(-r2 * h) / (r2 * h) + 1.0
            phi_2 = phi_1 / h + 1.0
            x_s2 = ((ns.sigma(s2) / ns.sigma(s)) * x - ns.alpha(s2) * phi_12 * m_s
                    + (r2 / r1) * ns.alpha(s2) * phi_22 * (m_s1 - m_s))
            m_s2 = model(x_s2, s2)
            return ((ns.sigma(t) / ns.sigma(s)) * x - ns.alpha(t) * phi_1 * m_s
                    + (1.0 / r2) * ns.alpha(t) * phi_2 * (m_s2 - m_s))
        phi_12 = torch.expm1(r2 * h)
        phi_1 = torch.expm1(h)
        phi_22 = torch.expm1(r2 * h) / (r2 * h) - 1.0
        phi_2 = phi_1 / h - 1.0
        x_s2 = ((ns.alpha(s2) / ns.alpha(s)) * x - ns.sigma(s2) * phi_12 * m_s
                - (r2 / r1) * ns.sigma(s2) * phi_22 * (m_s1 - m_s))
        m_s2 = model(x_s2, s2)
        return ((ns.alpha(t) / ns.alpha(s)) * x - ns.sigma(t) * phi_1 * m_s
                - (1.0 / r2) * ns.sigma(t) * phi_2 * (m_s2 - m_s))

    s = torch.tensor(t_T, dtype=torch.float32)
    h = torch.tensor(h_init, dtype=torch.float32)
    x_prev, nfe, accepted, rejected = x, 0, 0, 0
    # JAX's loop test alone, an f32 lambda(s) against lambda(t_0) in f64,
    # stays true at s = t_0, where f32 rounds lambda's 1 - alpha^2 too
    # coarsely (fault F7): its loop runs on to max_steps in steps that
    # leave x as it is. The reference ends where |s - t_0| <= 1e-5
    # (sampler.py:991), and so does this loop.
    while (bool(ns.lam(s) < lambda_0 - 1e-5) and abs(float(s) - t_0) > 1e-5
           and nfe < max_steps):
        t = ns.inverse_lambda(torch.minimum(ns.lam(s) + h, torch.tensor(lambda_0)))
        m_s = model(x, s)
        if order == 2:
            x_lower = first_order(x, s, t, m_s)
            x_higher, _ = second_order(x, s, t, m_s)
        else:  # adaptive-23 (reference sampler.py:1006-1015)
            x_lower, m_s1 = second_order(x, s, t, m_s, r1=1.0 / 3.0)
            x_higher = third_order(x, s, t, m_s, m_s1)
        delta = torch.maximum(torch.full_like(x_lower, atol),
                              rtol * torch.maximum(x_lower.abs(), x_prev.abs()))
        v = ((x_higher - x_lower) / delta).reshape(x.shape[0], -1)
        err = torch.sqrt(torch.mean(v ** 2, dim=-1)).max().float().cpu()
        nfe += order
        if bool(err <= 1.0):
            s, x, x_prev = t, x_higher, x_lower
            accepted += 1
        else:
            rejected += 1
        h = torch.minimum(theta * h * torch.clamp_min(err, 1e-10) ** (-1.0 / order),
                          lambda_0 - ns.lam(s))
    # final denoise to x0 at t_0, a host float (float64 coefficients)
    if wrapped_eps_fn is not None:
        eps = wrapped_eps_fn(x, t_0)
        x = (x - float(ns_host.marginal_std(t_0)) * eps) / float(ns_host.marginal_alpha(t_0))
    else:
        t_in = torch.full((x.shape[0],), float(ns.model_input_time(t_0)), dtype=torch.float32,
                          device=x.device)
        raw = denoise_fn(x, t_in)
        x = raw if training_target == "x0" else (
            (x - ns.sigma(torch.tensor(t_0, dtype=torch.float32)) * raw)
            / ns.alpha(torch.tensor(t_0, dtype=torch.float32)))
    if return_stats:
        return x, {"nfe": nfe, "accepted": accepted, "rejected": rejected}
    return x
