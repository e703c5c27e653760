"""The slice as a whole: the port's `sample_saliency` against the JAX
package's, at the small AV config (MViT tiny 64x96, VGGish, AudioAttnNet,
SalUNet 64x96, audio (B, 9, 32, 48, 1)), DDIM NFE=1, f32 on the CPU.

Same weights (carried across by the bridge), same rgb and audio (numpy,
seeded), and the same starting noise: the test recomputes the noise JAX
draws inside sample_saliency (`split(rng, 3)[1]`, then `normal` of shape
(B, h, w, 1)) and hands it to the port. `skip_dead_frames_all` is at its
default (on) on both sides. Tolerance: max|d| <= 1e-4 on the [0, 1] map.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sal_tpu import config as jc
from diff_sal_tpu.diffusion.schedule import make_schedule as j_make_schedule
from diff_sal_tpu.inference import sample_saliency as j_sample
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.diffusion.schedule import make_schedule
from diff_sal_tpu_torch.inference import sample_saliency
from test_torch_models import full_model_variables, port_model, small_av_config


def test_sample_saliency_matches_jax():
    cfg = small_av_config()
    jmodel, variables = full_model_variables(cfg, seed=11)
    rng = np.random.RandomState(12)
    B = 2
    rgb = rng.randn(B, 16, 64, 96, 3).astype(np.float32)
    audio = rng.randn(B, 9, 32, 48, 1).astype(np.float32)
    sampling, data_cfg = jc.SamplingConfig(), jc.DataTransformConfig()
    sched = j_make_schedule()
    key = jax.random.PRNGKey(0)
    ref = jax.jit(lambda v, r, a: j_sample(jmodel, v, sched, sampling, data_cfg, r, a, key))(
        variables, rgb, audio)
    noise = jax.random.normal(jax.random.split(key, 3)[1], (B, 64, 96, 1))

    model = port_model(cfg, variables)
    out = sample_saliency(model, make_schedule(), pc.from_fields(sampling),
                          pc.from_fields(data_cfg), torch.from_numpy(rgb),
                          torch.from_numpy(audio), noise=torch.from_numpy(np.array(noise)))
    assert tuple(out.shape) == (B, 64, 96, 1)
    assert float(out.std()) > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_schedule_tables_match_jax():
    for name in ("cosine", "linear"):
        ours, ref = make_schedule(name), j_make_schedule(name)
        for field in ref._fields:
            np.testing.assert_array_equal(getattr(ours, field).numpy(),
                                          np.asarray(getattr(ref, field)), err_msg=field)


@pytest.mark.parametrize("name", ["cosine", "linear"])
def test_inverse_helpers_match_jax(name):
    """predict_noise_from_start and predict_start_from_noise against JAX's
    (schedule.py:150-168), f32, t as an int and as a 0-d tensor, and their
    round trip through q_sample at t = 17; a (B,) t gives each item what
    its own int t gives."""
    from diff_sal_tpu.diffusion import schedule as js
    from diff_sal_tpu_torch.diffusion import schedule as ts

    rng = np.random.RandomState(14)
    x0, noise = (rng.randn(3, 1, 8, 8).astype(np.float32) for _ in range(2))
    sched_j, sched_t = j_make_schedule(name), make_schedule(name)
    for t in (0, 17, 999):
        x_t = np.asarray(js.q_sample(sched_j, jnp.asarray(x0), t, jnp.asarray(noise)))
        for tt in (t, torch.tensor(t)):
            eps = ts.predict_noise_from_start(sched_t, torch.from_numpy(x_t), tt,
                                              torch.from_numpy(x0))
            start = ts.predict_start_from_noise(sched_t, torch.from_numpy(x_t), tt,
                                                torch.from_numpy(noise))
            np.testing.assert_allclose(eps.numpy(), np.asarray(
                js.predict_noise_from_start(sched_j, x_t, t, x0)), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(start.numpy(), np.asarray(
                js.predict_start_from_noise(sched_j, x_t, t, noise)), rtol=1e-6, atol=1e-6)
        if t == 17:  # the round trip (at t = 0 eps is x_t - x0 over ~1e-2)
            np.testing.assert_allclose(eps.numpy(), noise, atol=1e-4)
            np.testing.assert_allclose(start.numpy(), x0, atol=1e-4)
    steps = torch.tensor([3, 500, 998])
    x_t = ts.q_sample(sched_t, torch.from_numpy(x0), steps, torch.from_numpy(noise))
    batched = ts.predict_start_from_noise(sched_t, x_t, steps, torch.from_numpy(noise))
    for i, t in enumerate(steps):
        one = ts.predict_start_from_noise(sched_t, x_t[i:i + 1], int(t),
                                          torch.from_numpy(noise[i:i + 1]))
        np.testing.assert_array_equal(batched[i:i + 1].numpy(), one.numpy())


def test_ddim_multistep_and_ddpm_match_jax():
    """The samplers' update equations with a fixed linear 'denoiser' and eta=0
    (DDIM, 4 steps) against the JAX package; DDPM at one step (t=0 has no
    noise term)."""
    from diff_sal_tpu.diffusion import sampling as js
    from diff_sal_tpu_torch.diffusion import sampling as ts

    x = np.random.RandomState(13).randn(2, 8, 8, 1).astype(np.float32)
    sched_j, sched_t = j_make_schedule(), make_schedule()
    fn_j = lambda xt, t: 0.5 * xt + 0.001 * t[:, None, None, None]  # noqa: E731
    fn_t = lambda xt, t: 0.5 * xt + 0.001 * t[:, None, None, None]  # noqa: E731
    for target in ("x0", "noise"):
        ref = js.ddim_sample(sched_j, fn_j, jnp.asarray(x), timesteps=4, training_target=target)
        out = ts.ddim_sample(sched_t, fn_t, torch.from_numpy(x), timesteps=4,
                             training_target=target)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    ref = js.ddpm_sample(sched_j, fn_j, jnp.asarray(x), timesteps=1)
    out = ts.ddpm_sample(sched_t, fn_t, torch.from_numpy(x), timesteps=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
