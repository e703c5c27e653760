"""The port's audio frontend against the JAX package's, on the CPU.

The numpy half of `audio/mel.py` and `audio/features.py` is a copy and is
held bit for bit. The torch half (`log_mel_examples`,
`device_audio_frontend`: `torch.fft.rfft` in f32 where JAX uses
`jnp.fft.rfft`) is held to JAX's jnp frontend within 2e-4 on the log-mel
examples, the bound JAX's own test allows between its device and host paths
(tests/test_audio_mel.py:54-60; log(mel + 0.01) of f32 spectra, values
down to log(0.01)), and within 1e-4 on the resized (B, 9, H, W, 1) model
input. Wave lengths that give 9 examples (the packed excerpt), fewer (the
repeat) and more (the trim) are all run. `sample_saliency_from_wave` on
the small AV model (MViT tiny 64x96, VGGish, AudioAttnNet, f32): within
1e-4 on the map, the bound of tests/test_torch_e2e.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sal_tpu import config as jc
from diff_sal_tpu.audio import features as jfeat
from diff_sal_tpu.audio import mel as jmel
from diff_sal_tpu.train import train_step as jstep
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.audio import features as pfeat
from diff_sal_tpu_torch.audio import mel as pmel
from diff_sal_tpu_torch.train import train_step as pstep

CONSTANTS = ("SAMPLE_RATE", "STFT_WINDOW", "STFT_HOP", "FFT_LENGTH", "NUM_MEL_BINS",
             "MEL_MIN_HZ", "MEL_MAX_HZ", "LOG_OFFSET", "EXAMPLE_WINDOW", "EXAMPLE_HOP",
             "AUDIO_LEN", "MAX_AUDIO_WIN", "MODEL_AUDIO_HW", "PACKED_WAVE_LEN")


def _waves(n: int, length: int, seed: int) -> np.ndarray:
    return (np.random.RandomState(seed).randn(n, length) * 0.1).astype(np.float32)


def test_constants_and_tables_equal_jax():
    for name in CONSTANTS:
        assert getattr(pmel, name) == getattr(jmel, name), name
    for n in (400, 512, 7):
        np.testing.assert_array_equal(pmel.periodic_hann(n), jmel.periodic_hann(n))
    np.testing.assert_array_equal(pmel.mel_matrix(), jmel.mel_matrix())
    np.testing.assert_array_equal(pmel.mel_matrix(32, 129, 8000, 100.0, 3000.0),
                                  jmel.mel_matrix(32, 129, 8000, 100.0, 3000.0))


@pytest.mark.parametrize("sr,length", [(16000, 25600), (22050, 35280), (44100, 50000),
                                       (16000, 19000)])
def test_host_frontend_equals_jax(sr, length):
    wave = np.random.RandomState(length).randn(length) * 0.2
    np.testing.assert_array_equal(pmel.log_mel_spectrogram_np(wave),
                                  jmel.log_mel_spectrogram_np(wave))
    np.testing.assert_array_equal(pmel.waveform_to_examples_np(wave, sr),
                                  jmel.waveform_to_examples_np(wave, sr))
    stereo = np.stack([wave, -0.5 * wave], axis=1)
    np.testing.assert_array_equal(pmel.waveform_to_examples_np(stereo, sr),
                                  jmel.waveform_to_examples_np(stereo, sr))


def test_short_wave_raises_like_jax():
    for mod in (pmel, jmel):
        with pytest.raises(ValueError):
            mod.waveform_to_examples_np(np.zeros(4000), 16000)


@pytest.mark.parametrize("v", [0, 100, 35280, 40001])
def test_center_pad_equals_jax(v):
    ex = np.random.RandomState(v).randn(v)
    np.testing.assert_array_equal(pmel.center_pad_excerpt(ex), jmel.center_pad_excerpt(ex))
    np.testing.assert_array_equal(pmel.center_pad_excerpt(ex, 25600),
                                  jmel.center_pad_excerpt(ex, 25600))


@pytest.mark.parametrize("n", [1, 4, 9, 13])
def test_repeat_and_model_audio_equal_jax(n):
    ex = np.random.RandomState(n).randn(n, 64, 64)
    np.testing.assert_array_equal(pmel.repeat_to_audio_len(ex), jmel.repeat_to_audio_len(ex))
    for hw in (None, (32, 48)):
        np.testing.assert_array_equal(pmel.examples_to_model_audio(ex, hw),
                                      jmel.examples_to_model_audio(ex, hw))


@pytest.mark.parametrize("silent", [False, True])
def test_clip_audio_to_model_input_equals_jax(silent):
    wave = np.random.RandomState(3).randn(30000) * 0.1
    for sr, hw in ((22050, None), (16000, (32, 48))):
        np.testing.assert_array_equal(
            pmel.clip_audio_to_model_input(wave, sr, silent, hw),
            jmel.clip_audio_to_model_input(wave, sr, silent, hw))


@pytest.mark.parametrize("length", [100, 35280, 50000])
def test_spec_and_raw_features_equal_jax(length):
    wave = np.random.RandomState(length).randn(length) * 0.3
    for sr in (22050, 16000):
        np.testing.assert_array_equal(pfeat.spec_feature(wave, sr), jfeat.spec_feature(wave, sr))
    np.testing.assert_array_equal(pfeat.raw_feature(wave), jfeat.raw_feature(wave))
    np.testing.assert_array_equal(pfeat.raw_feature(wave, 2000), jfeat.raw_feature(wave, 2000))


@pytest.mark.parametrize("length", [25600, 19000, 40000])
def test_log_mel_examples_match_jax(length):
    """25600 samples: 9 examples; 19000: 5 (repeated to 9 below); 40000:
    17 (trimmed)."""
    wave = _waves(2, length, length)
    got = pmel.log_mel_examples(torch.from_numpy(wave))
    ref = np.asarray(jmel.log_mel_examples(jnp.asarray(wave)))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=0)
    host = np.stack([pmel.waveform_to_examples_np(w, 16000) for w in wave])
    np.testing.assert_allclose(got.numpy(), host, atol=2e-4, rtol=0)


@pytest.mark.parametrize("length,hw", [(25600, None), (19000, (32, 48)), (40000, (56, 96)),
                                       (25600, (32, 48))])
def test_device_audio_frontend_matches_jax(length, hw):
    wave = _waves(2, length, length + 1)
    got = pmel.device_audio_frontend(torch.from_numpy(wave), hw)
    ref = np.asarray(jmel.device_audio_frontend(jnp.asarray(wave), hw))
    want_hw = hw or (112, 192)
    assert tuple(got.shape) == ref.shape == (2, 9, *want_hw, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_resolve_audio_and_audio_hw_match_jax():
    jcfg = jc.ExperimentConfig(model=jc.ModelConfig(decoder=jc.SalUNetConfig(img_size=(64, 96))))
    assert pstep.audio_hw_for(pc.from_fields(jcfg)) == jstep.audio_hw_for(jcfg) == (32, 48)
    wave = _waves(2, 25600, 5)
    got = pstep.resolve_audio({"wave": wave}, (32, 48))
    ref = np.asarray(jstep.resolve_audio({"wave": jnp.asarray(wave)}, (32, 48)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
    audio = np.ones((2, 9, 32, 48, 1), np.float32)
    assert pstep.resolve_audio({"audio": audio, "wave": wave}) is audio
    assert pstep.resolve_audio({"rgb": audio}) is None


def test_sample_saliency_from_wave_matches_jax(monkeypatch):
    """JAX's sample_saliency_from_wave resizes to the module constant
    MODEL_AUDIO_HW (112, 192); the small model takes (32, 48), so the JAX
    side runs with that constant set to (32, 48), and the port with its
    default, half the model's map size."""
    from diff_sal_tpu.diffusion.schedule import make_schedule as j_make_schedule
    from diff_sal_tpu.inference import sample_saliency_from_wave as j_sample
    from diff_sal_tpu_torch.diffusion.schedule import make_schedule
    from diff_sal_tpu_torch.inference import sample_saliency_from_wave
    from test_torch_models import full_model_variables, port_model, small_av_config

    monkeypatch.setattr(jmel, "MODEL_AUDIO_HW", (32, 48))
    cfg = small_av_config()
    jmodel, variables = full_model_variables(cfg, seed=21)
    rng = np.random.RandomState(22)
    B = 2
    rgb = rng.randn(B, 16, 64, 96, 3).astype(np.float32)
    wave = (rng.randn(B, 25600) * 0.1).astype(np.float32)
    sampling, data_cfg = jc.SamplingConfig(), jc.DataTransformConfig()
    sched = j_make_schedule()
    key = jax.random.PRNGKey(23)
    ref = jax.jit(lambda v, r, w: j_sample(jmodel, v, sched, sampling, data_cfg, r, w, key))(
        variables, rgb, wave)
    noise = jax.random.normal(jax.random.split(key, 3)[1], (B, 64, 96, 1))

    model = port_model(cfg, variables)
    out = sample_saliency_from_wave(model, make_schedule(), pc.from_fields(sampling),
                                    pc.from_fields(data_cfg), torch.from_numpy(rgb),
                                    torch.from_numpy(wave),
                                    noise=torch.from_numpy(np.array(noise)))
    assert tuple(out.shape) == (B, 64, 96, 1) and float(out.std()) > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
