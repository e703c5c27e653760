"""The port's DPM-Solver (`diff_sal_tpu_torch/diffusion/dpm_solver.py`)
against the JAX package's, on the CPU in f32, with an analytic denoiser
written alike in jnp and torch, and the schedule's host-side float64
arithmetic (timesteps, lambda, alpha, sigma) compared exactly; and the
slice as a whole: the small AV model with the eval lowerings (K7, K9,
K11) through DPM-Solver++ 2M at NFE 2 against JAX's `sample_saliency`.

Tolerance: both sides run the same chain of f32 updates with coefficients
computed in float64 on the host and rounded to f32 at the product, so
they agree to f32 rounding. The chain amplifies that rounding: the
noise-prediction solver multiplies x by alpha_t / alpha_s up to ~1e2
across a step from t_T (alpha ~ 6e-3) and cancels it against the noise
term, so at some settings both f32 solvers land up to ~9e-4 (of max(1,
max|x|)) from the same solver run in f64. The test holds the port to
JAX's f32 result within 1e-4 of that scale, and to the f64 run no worse
than JAX's f32 result is, plus 1e-5 of the scale.
"""

import dataclasses
import itertools

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sal_tpu import config as jc
from diff_sal_tpu.diffusion import dpm_solver as jd
from diff_sal_tpu.diffusion.schedule import make_schedule as j_make_schedule
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.diffusion import dpm_solver as td
from diff_sal_tpu_torch.diffusion.schedule import make_schedule


def _denoiser(xp):
    """x0 or eps prediction f(x, t) = 0.8 x + 0.4 tanh(x) * t / 1000 + 0.05,
    in jnp or torch; non-linear so that every order's correction differs."""
    def fn(x, t):
        return 0.8 * x + 0.4 * xp.tanh(x) * (t / 1000.0)[:, None, None, None] + 0.05
    return fn


# every (algorithm, method, order, skip_type) with five settings of
# (denoise, thresholding, lower_order_final, target) that together hold
# every pair of values of every two of them (a covering array)
FLAGS = [(False, False, False, "x0"), (False, True, True, "noise"),
         (True, False, True, "noise"), (True, True, False, "noise"),
         (True, True, True, "x0")]
CASES = [c + f for c, f in itertools.product(
    itertools.product(("dpmsolver", "dpmsolver++"), ("multistep", "singlestep"), (1, 2, 3),
                      ("logSNR", "time_uniform", "time_quadratic")), FLAGS)]


@pytest.mark.parametrize("algorithm,method,order,skip_type,denoise,thresholding,"
                         "lower_order_final,target", CASES)
def test_dpm_solver_matches_jax(algorithm, method, order, skip_type, denoise, thresholding,
                                lower_order_final, target):
    x = np.random.RandomState(order).randn(2, 6, 5, 1).astype(np.float32) * 1.5
    kw = dict(sample_type=algorithm, timesteps=6, dpm_solver_method=method,
              dpm_solver_order=order, skip_type=skip_type, denoise=denoise,
              thresholding=thresholding, lower_order_final=lower_order_final)
    ref = jd.dpm_solver_sample(j_make_schedule(), _denoiser(jnp), jnp.asarray(x),
                               sampling=jc.SamplingConfig(**kw), training_target=target)
    out = td.dpm_solver_sample(make_schedule(), _denoiser(torch), torch.from_numpy(x),
                               sampling=pc.SamplingConfig(**kw), training_target=target)
    out64 = td.dpm_solver_sample(make_schedule(), _denoiser(torch), torch.from_numpy(x).double(),
                                 sampling=pc.SamplingConfig(**kw), training_target=target)
    ref, out, out64 = np.asarray(ref), out.numpy(), out64.numpy()
    assert np.isfinite(ref).all() and out.dtype == np.float32
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, atol=1e-4 * scale, rtol=0)
    assert np.abs(out - out64).max() <= np.abs(ref - out64).max() + 1e-5 * scale


def test_schedule_and_steps_match_jax_exactly():
    """The host-side float64 schedule: the clipped grid, timesteps of every
    spacing, lambda and its inverse, the singlestep order split."""
    ns_j = jd.DiscreteVPSchedule(np.asarray(j_make_schedule().betas))
    ns_t = td.DiscreteVPSchedule(make_schedule().betas.double().numpy())
    np.testing.assert_array_equal(ns_t.t_array, ns_j.t_array)
    np.testing.assert_array_equal(ns_t.log_alpha_array, ns_j.log_alpha_array)
    assert (ns_t.T, ns_t.t_0, ns_t.total_N) == (ns_j.T, ns_j.t_0, ns_j.total_N)
    for skip in ("logSNR", "time_uniform", "time_quadratic"):
        for n in (1, 4, 7):
            np.testing.assert_array_equal(td.time_steps(ns_t, skip, ns_t.T, ns_t.t_0, n),
                                          jd.time_steps(ns_j, skip, ns_j.T, ns_j.t_0, n))
    lam = np.linspace(-5.0, 7.0, 9)
    np.testing.assert_array_equal(ns_t.inverse_lambda(lam), ns_j.inverse_lambda(lam))
    for steps, order in itertools.product(range(1, 8), (1, 2, 3)):
        assert td.singlestep_orders(steps, order) == jd.singlestep_orders(steps, order)


def test_dynamic_threshold_matches_jax():
    x = np.random.RandomState(5).randn(3, 16, 12, 1).astype(np.float32) * 2.0
    ref = jd._dynamic_threshold(jnp.asarray(x))
    np.testing.assert_allclose(td._dynamic_threshold(torch.from_numpy(x)).numpy(),
                               np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("nfe", [2, 5])
def test_bench_sampler_calls_the_denoiser_nfe_times(nfe):
    """bench.py's DPM-Solver++ 2M settings with denoise: `timesteps`
    denoiser calls in all, the last at the smallest time."""
    calls = []

    def fn(x, t):
        calls.append(float(t[0]))
        return 0.5 * x

    sampling = pc.SamplingConfig(sample_type="dpmsolver++", timesteps=nfe,
                                 dpm_solver_method="multistep", dpm_solver_order=2)
    td.dpm_solver_sample(make_schedule(), fn, torch.zeros(1, 2, 2, 1), sampling=sampling)
    assert len(calls) == nfe
    assert calls == sorted(calls, reverse=True) and calls[-1] == pytest.approx(0.0)


def test_unknown_settings_raise():
    with pytest.raises(NotImplementedError):
        td.dpm_solver_sample(make_schedule(), lambda x, t: x, torch.zeros(1, 2, 2, 1),
                             sampling=pc.SamplingConfig(sample_type="dpmsolver",
                                                        dpm_solver_method="adaptive"))
    with pytest.raises(ValueError):
        td.time_steps(td.DiscreteVPSchedule(make_schedule().betas.numpy()), "cubic", 1.0,
                      1e-3, 3)


def _lowered(cfg: jc.ModelConfig) -> jc.ModelConfig:
    return dataclasses.replace(
        cfg, visual=dataclasses.replace(cfg.visual, pool_mode="pallas"),
        decoder=dataclasses.replace(cfg.decoder, fused_attn=True, head_lowres=True))


def test_sample_saliency_dpmpp_with_lowerings_matches_jax():
    """The small AV model with the three flags through DPM-Solver++ 2M at
    NFE 2 (bench.py's sampler settings), the port against JAX's
    sample_saliency on the same weights, inputs and starting noise:
    max|d| <= 1e-4 on the [0, 1] map. The same weights load into the model
    without the flags (the flags change no parameter)."""
    from diff_sal_tpu.diffusion.schedule import make_schedule as j_make_schedule
    from diff_sal_tpu.inference import sample_saliency as j_sample
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.inference import sample_saliency
    from test_torch_models import full_model_variables, port_model, small_av_config

    cfg = _lowered(small_av_config())
    jmodel, variables = full_model_variables(cfg, seed=21)
    rng = np.random.RandomState(22)
    B = 2
    rgb = rng.randn(B, 16, 64, 96, 3).astype(np.float32)
    audio = rng.randn(B, 9, 32, 48, 1).astype(np.float32)
    sampling = jc.SamplingConfig(sample_type="dpmsolver++", timesteps=2,
                                 dpm_solver_method="multistep", dpm_solver_order=2,
                                 skip_type="logSNR")
    data_cfg, sched, key = jc.DataTransformConfig(), j_make_schedule(), jax.random.PRNGKey(0)
    ref = jax.jit(lambda v, r, a: j_sample(jmodel, v, sched, sampling, data_cfg, r, a, key))(
        variables, rgb, audio)
    noise = jax.random.normal(jax.random.split(key, 3)[1], (B, 64, 96, 1))

    model = port_model(cfg, variables)
    plain = port_model(small_av_config(), variables)
    assert model.decoder_net.invpt_decoder.mt_proj.head_lowres
    args = (make_schedule(), pc.from_fields(sampling), pc.from_fields(data_cfg),
            torch.from_numpy(rgb), torch.from_numpy(audio))
    calls = []
    denoise = model.denoise
    model.denoise = lambda *a, **kw: calls.append(1) or denoise(*a, **kw)
    out = sample_saliency(model, *args, noise=torch.from_numpy(np.array(noise)))
    assert len(calls) == 2  # NFE 2: one solver step and the denoise-to-zero
    assert tuple(out.shape) == (B, 64, 96, 1) and float(out.std()) > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    unlowered = sample_saliency(plain, *args, noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(unlowered.numpy(), out.numpy(), atol=1e-4, rtol=0)
