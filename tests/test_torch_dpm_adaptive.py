"""The rest of the port's DPM-Solver (`diffusion/dpm_solver.py`):
`adaptive_sample`, `model_wrapper` and `dpm_solver_sample(wrapped_eps_fn=)`
against the JAX package's, on the CPU in f32, with the analytic denoiser
of tests/test_torch_dpm_solver.py.

The adaptive solver's steps depend on the data. Each side's denoiser
records the times it is called at (JAX's through `jax.debug.callback`
inside its `while_loop`), which give JAX's accepted and rejected steps up
to its arrival at t_0; the port ends there (fault F7: JAX's loop goes on
to `max_steps` in steps that change nothing). Both run the schedule in
f32, but XLA's CPU exp / log / expm1 / tanh differ from torch's in the
last bit on 6-60% of inputs, and the step size follows err^(-1/order) of
a difference of two updates. So the test first asks whether the steps
are decided by rounding: the port's run in f64 (x and the denoiser in
f64, the times f32 as in JAX) against its f32 run. Where they take the
same steps, the port takes JAX's steps (equal model calls, accepted and
rejected counts), lies within 1e-4 of max(1, max|x|) of JAX's output and
no farther from its f64 run than twice JAX's distance plus 1e-5 of that
scale (measured: 9.5e-7 to 5.7e-5 of the scale from JAX); on the
model's own path (the data-prediction solver of an x0 model) at the
default tolerances within 1e-5 of the scale (measured 1.2e-6 and
4.8e-7; 1.7e-5 at atol 1e-3, rtol 5e-3, 74 model calls). Where rounding decides
the steps (at the default settings one case: order 3, the
noise-prediction solver of an x0 model, whose first error estimate is
f32 rounding; even the f64 run takes other steps), each run is a valid
adaptive solution and is held to the ODE's solution (the multistep solver
at 400 steps in f64) within 1.5 times the farther of JAX's and the f64
run's distance from it. `model_wrapper` mirrors
tests/test_dpm_solver.py:240-381, each case also against JAX's wrapper
on the same inputs.
"""

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
from test_torch_dpm_solver import _denoiser

TOL = 1e-5


def _ns():
    return td.DiscreteVPSchedule(make_schedule().betas.double().numpy())


def _x(seed=0, shape=(2, 6, 5, 1)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * 1.5


def _jax_recording(fn, log):
    def f(x, t):
        jax.debug.callback(lambda tv: log.append(float(np.asarray(tv)[0])), t, ordered=True)
        return fn(x, t)
    return f


def _torch_recording(fn, log):
    def f(x, t):
        log.append(float(t[0]))
        return fn(x, t)
    return f


def _scale(ref):
    return max(1.0, float(np.abs(ref).max()))


def _jax_steps(ts, order):
    """JAX's (model calls, accepted, rejected) up to its arrival at t_0,
    from its denoiser's call times: `order` calls per step, the first at
    the step's start s (model time 0 at t_0); a step is accepted when the
    next one starts elsewhere."""
    starts = ts[:-1][::order]
    arrived = 0.0 in starts
    starts = starts[:starts.index(0.0)] if arrived else starts
    accepted = sum(a != b for a, b in zip(starts[1:], starts[:-1])) + arrived
    return order * len(starts), accepted, len(starts) - accepted


def _samplers(x, wrap, kw):
    """JAX's and the port's adaptive runs of x, each with its call times
    recorded; with `wrap` the denoiser goes in as an x0 network through
    each package's `model_wrapper` (`wrapped_eps_fn`)."""
    j_ts, t_ts = [], []
    j_net, t_net = _jax_recording(_denoiser(jnp), j_ts), _torch_recording(_denoiser(torch), t_ts)
    j_fn = j_net
    if wrap:
        jns = jd.DiscreteVPSchedule(np.asarray(j_make_schedule().betas))
        j_kw = dict(kw, wrapped_eps_fn=jd.model_wrapper(lambda x, tv, c: j_fn(x, tv), jns,
                                                        model_type="x_start"))

        def t_kw(net):
            return dict(kw, wrapped_eps_fn=td.model_wrapper(lambda x, tv, c: net(x, tv), _ns(),
                                                            model_type="x_start"))
        j_net = None  # the wrapper calls j_fn
    else:
        j_kw = kw

        def t_kw(net):
            return kw
    ref = np.asarray(jd.adaptive_sample(j_make_schedule(), j_net, jnp.asarray(x), **j_kw))
    jax.effects_barrier()
    out, stats = td.adaptive_sample(make_schedule(), None if wrap else t_net, torch.from_numpy(x),
                                    return_stats=True, **t_kw(t_net))
    f64 = _denoiser(torch)
    out64, stats64 = td.adaptive_sample(make_schedule(), None if wrap else f64,
                                        torch.from_numpy(x).double(), return_stats=True,
                                        **t_kw(f64))
    assert np.isfinite(ref).all() and out.dtype == torch.float32
    assert len(t_ts) == stats["nfe"] + 1
    assert stats["nfe"] == kw.get("order", 2) * (stats["accepted"] + stats["rejected"])
    return ref, j_ts, out.numpy(), stats, out64.numpy(), stats64


def _hold(x, wrap=False, strict=False, **kw):
    """The port's adaptive run of x against JAX's, as the module's
    docstring sets out, and with `strict` within 1e-5 of the scale too;
    returns (the port's stats, whether the steps were free of
    rounding)."""
    ref, j_ts, out, stats, out64, stats64 = _samplers(x, wrap, kw)
    order = kw.get("order", 2)
    scale = _scale(ref)
    alg, tgt = kw.get("algorithm", "dpmsolver++"), kw.get("training_target", "x0")
    if stats == stats64:  # the steps are not decided by rounding
        assert (stats["nfe"], stats["accepted"], stats["rejected"]) == _jax_steps(j_ts, order), (
            stats, _jax_steps(j_ts, order))
        np.testing.assert_allclose(out, ref, atol=1e-4 * scale, rtol=0)
        assert np.abs(out - out64).max() <= 2 * np.abs(ref - out64).max() + TOL * scale
        if strict:
            np.testing.assert_allclose(out, ref, atol=TOL * scale, rtol=0)
        return stats, True
    ns = _ns()
    solver = td._Solver(ns, _denoiser(torch), algorithm=alg, training_target=tgt)
    exact = solver.x0_pred(solver.sample_multistep(torch.from_numpy(x).double(), steps=400,
                                                   order=3), ns.t_0).numpy()
    far = max(np.abs(ref - exact).max(), np.abs(out64 - exact).max())
    assert np.abs(out - exact).max() <= 1.5 * far, (np.abs(out - exact).max(), far)
    return stats, False


@pytest.mark.parametrize("target", ["x0", "noise"])
@pytest.mark.parametrize("algorithm", ["dpmsolver", "dpmsolver++"])
@pytest.mark.parametrize("order", [2, 3])
def test_adaptive_sample_matches_jax(order, algorithm, target):
    # the model's own path (the data-prediction solver of an x0 model)
    # within 1e-5 of the scale
    stats, same_steps = _hold(_x(order), training_target=target, algorithm=algorithm,
                              order=order, strict=(algorithm, target) == ("dpmsolver++", "x0"))
    assert stats["accepted"] >= 2 and stats["nfe"] < 200, stats
    # at the default settings only this case's steps are decided by rounding
    assert same_steps == ((order, algorithm, target) != (3, "dpmsolver", "x0"))


def test_adaptive_sample_rejects_and_stops_at_max_steps():
    """Tighter tolerances force more rejected steps; max_steps ends the
    loop after that many model calls, both as JAX does."""
    x = _x(5)
    stats, same = _hold(x, atol=1e-3, rtol=5e-3, order=2)
    assert same and stats["rejected"] >= 8, stats
    stats, same = _hold(x, max_steps=8, order=2)
    assert same and stats["nfe"] == 8, stats


def test_adaptive_sample_raises_on_other_orders():
    with pytest.raises(ValueError):
        td.adaptive_sample(make_schedule(), _denoiser(torch), torch.zeros(1, 2, 2, 1), order=1)


def test_interp_is_jnp_interp():
    ns = _ns()
    xp = torch.tensor(ns.t_array, dtype=torch.float32)
    fp = torch.tensor(ns.log_alpha_array, dtype=torch.float32)
    x = np.concatenate([np.linspace(-0.1, 1.1, 301), ns.t_array[:5], ns.t_array[-3:]]).astype(
        np.float32)
    got = td.interp(torch.from_numpy(x), xp, fp).numpy()
    ref = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp.numpy()), jnp.asarray(fp.numpy())))
    assert np.array_equal(got, ref)
    # decreasing lambda grid reversed, as the inverse lookup uses it
    lam = torch.tensor(np.asarray(ns.marginal_lambda(ns.t_array))[::-1].copy(), dtype=torch.float32)
    tr = torch.tensor(ns.t_array[::-1].copy(), dtype=torch.float32)
    y = np.linspace(-6.0, 12.0, 97).astype(np.float32)
    assert np.array_equal(td.interp(torch.from_numpy(y), lam, tr).numpy(), np.asarray(
        jnp.interp(jnp.asarray(y), jnp.asarray(lam.numpy()), jnp.asarray(tr.numpy()))))


def _point_mass_makers(xp, a, s, c):
    full = (lambda x, v: jnp.full_like(x, v)) if xp is jnp else (lambda x, v: torch.full_like(x, v))
    ones = jnp.ones_like if xp is jnp else torch.ones_like
    return {
        "noise": lambda x, tv, cond: (x - a * c) / s,
        "x_start": lambda x, tv, cond: full(x, c),
        "v": lambda x, tv, cond: a * (x - a * c) / s - s * c * ones(x),
        "score": lambda x, tv, cond: -(x - a * c) / (s * s),
    }


@pytest.mark.parametrize("time", ["host float", "f32 tensor"])
def test_model_wrapper_parameterizations(time):
    """Every model_type converts to the analytic noise of a point mass at c
    (JAX's test_model_wrapper_parameterizations), as JAX's wrapper does on
    the same inputs, at a host float time and at an f32 scalar time (the
    adaptive loop's); the network gets the discrete model time."""
    ns, jns = _ns(), jd.DiscreteVPSchedule(np.asarray(j_make_schedule().betas))
    c, t = 0.3, 0.41
    a, s = float(ns.marginal_alpha(t)), float(ns.marginal_std(t))
    x = np.random.RandomState(4).randn(2, 4, 4, 1).astype(np.float32)
    eps_true = (x - a * c) / s
    tm = torch.tensor(t, dtype=torch.float32) if time == "f32 tensor" else t
    jt = jnp.asarray(t, jnp.float32) if time == "f32 tensor" else t
    for mt, fn in _point_mass_makers(torch, a, s, c).items():
        seen = []

        def check_t(xa, tv, cond, fn=fn):
            seen.append(float(tv[0]))
            return fn(xa, tv, cond)

        got = td.model_wrapper(check_t, ns, model_type=mt)(torch.from_numpy(x), tm).numpy()
        ref = np.asarray(jd.model_wrapper(_point_mass_makers(jnp, a, s, c)[mt], jns,
                                          model_type=mt)(jnp.asarray(x), jt))
        np.testing.assert_allclose(got, eps_true, atol=1e-4, err_msg=mt)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-6, err_msg=mt)
        np.testing.assert_allclose(seen, [ns.model_input_time(t)], rtol=1e-6)
    with pytest.raises(ValueError):
        td.model_wrapper(lambda *a: a[0], ns, model_type="other")(torch.from_numpy(x), t)


def test_model_wrapper_classifier_free_guidance():
    ns = _ns()
    x = torch.ones(1, 4, 4, 1)

    def fn(x, tv, cond):
        return torch.full_like(x, 0.0 if cond is None else float(cond))

    def wrap(**kw):
        return td.model_wrapper(fn, ns, guidance_type="classifier-free", **kw)(x, 0.5)

    # no unconditional condition: the conditional call
    assert torch.equal(wrap(condition=1.0, unconditional_condition=None, guidance_scale=2.0),
                       torch.full_like(x, 1.0))
    # e_uncond + s * (e_cond - e_uncond) = -1 + 2 * (1 - (-1)) = 3
    assert torch.equal(wrap(condition=1.0, unconditional_condition=-1.0, guidance_scale=2.0),
                       torch.full_like(x, 3.0))
    # scale 1 takes the conditional branch alone
    assert torch.equal(wrap(condition=0.25, unconditional_condition=-1.0, guidance_scale=1.0),
                       torch.full_like(x, 0.25))
    with pytest.raises(ValueError):
        td.model_wrapper(fn, ns, guidance_type="other")(x, 0.5)


def test_model_wrapper_classifier_guidance_matches_jax():
    """eps - scale * sigma * grad_x log p(c|x) (reference sampler.py:205-216,
    290-299): with log p = -||x||^2 / 2 the gradient is -x."""
    ns, jns = _ns(), jd.DiscreteVPSchedule(np.asarray(j_make_schedule().betas))
    t = 0.5
    s = float(ns.marginal_std(t))
    x = np.random.RandomState(5).randn(2, 4, 4, 1).astype(np.float32)

    def t_fn(x, tv, cond):
        return 0.1 * x

    def t_cls(x, tv, cond):
        return -0.5 * (x.reshape(x.shape[0], -1) ** 2).sum(1) * (1.0 + tv / 1000.0)

    def j_cls(x, tv, cond):
        return -0.5 * jnp.sum(x.reshape(x.shape[0], -1) ** 2, axis=1) * (1.0 + tv / 1000.0)

    got = td.model_wrapper(t_fn, ns, guidance_type="classifier", classifier_fn=t_cls,
                           guidance_scale=3.0)(torch.from_numpy(x), t).numpy()
    ref = np.asarray(jd.model_wrapper(lambda x, tv, c: 0.1 * x, jns, guidance_type="classifier",
                                      classifier_fn=j_cls, guidance_scale=3.0)(jnp.asarray(x), t))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)
    w = 1.0 + float(ns.model_input_time(t)) / 1000.0
    np.testing.assert_allclose(got, 0.1 * x + 3.0 * s * w * x, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        td.model_wrapper(t_fn, ns, guidance_type="classifier")


def test_model_wrapper_drives_the_solver():
    """A wrapped noise predictor in _Solver(continuous_time=True) recovers
    the point mass, as JAX's does."""
    ns = _ns()
    c = 0.25

    def fn(x, tv, cond):
        t_cont = float(tv[0]) / 1000.0 + 1.0 / ns.total_N
        a, s = ns.marginal_alpha(t_cont), ns.marginal_std(t_cont)
        return (x - float(a) * c) / float(s)

    sol = td._Solver(ns, td.model_wrapper(fn, ns, model_type="noise"), algorithm="dpmsolver",
                     training_target="noise", continuous_time=True)
    x = torch.from_numpy(np.random.RandomState(6).randn(1, 4, 4, 1).astype(np.float32))
    y = sol.denoise_to_zero(sol.sample_multistep(x, steps=10, order=2))
    np.testing.assert_allclose(y.numpy(), c, atol=1e-3)


@pytest.mark.parametrize("method,order", [("multistep", 2), ("singlestep", 3)])
@pytest.mark.parametrize("model_type", ["x_start", "noise"])
def test_dpm_solver_sample_with_wrapped_eps_matches_jax(model_type, method, order):
    """dpm_solver_sample(wrapped_eps_fn=...) with classifier-free guidance
    around the analytic denoiser, against JAX's on the same noise."""
    kw = dict(sample_type="dpmsolver++", timesteps=5, dpm_solver_order=order,
              dpm_solver_method=method, denoise=True)
    ns, jns = _ns(), jd.DiscreteVPSchedule(np.asarray(j_make_schedule().betas))

    def net(xp):
        f = _denoiser(xp)
        return lambda x, tv, cond: f(x, tv) + 0.1 * cond

    guide = dict(model_type=model_type, guidance_type="classifier-free", condition=1.0,
                 unconditional_condition=-0.5, guidance_scale=1.5)
    x = _x(8)
    ref = np.asarray(jd.dpm_solver_sample(j_make_schedule(), None, jnp.asarray(x),
                                          sampling=jc.SamplingConfig(**kw),
                                          wrapped_eps_fn=jd.model_wrapper(net(jnp), jns, **guide)))
    out = td.dpm_solver_sample(make_schedule(), None, torch.from_numpy(x),
                               sampling=pc.SamplingConfig(**kw),
                               wrapped_eps_fn=td.model_wrapper(net(torch), ns, **guide)).numpy()
    assert np.isfinite(ref).all()
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize("order", [2, 3])
def test_adaptive_sample_with_wrapped_eps_matches_jax(order):
    """adaptive_sample(wrapped_eps_fn=...): the wrapper at the loop's f32
    times (interp) and at the final host-float t_0. A point mass at c
    (JAX's test_adaptive_sample_with_wrapped_guidance), then the analytic
    denoiser as an x0 network through each package's wrapper, held to
    JAX's run as the unwrapped cases are (order 3 at these settings:
    steps decided by rounding, the eps -> x0 round trip dividing by alpha
    and sigma)."""
    ns = _ns()
    c = 0.35
    x = _x(1, (2, 6, 6, 1))
    guide = dict(model_type="x_start", guidance_type="classifier-free", condition=c,
                 unconditional_condition=c, guidance_scale=2.0)
    out = td.adaptive_sample(make_schedule(), None, torch.from_numpy(x), order=order,
                             wrapped_eps_fn=td.model_wrapper(
                                 lambda x, tv, cond: torch.full_like(x, float(cond)), ns, **guide))
    np.testing.assert_allclose(out.numpy(), c, atol=2e-3)
    _, same = _hold(x, wrap=True, order=order)
    assert same == (order == 2)
