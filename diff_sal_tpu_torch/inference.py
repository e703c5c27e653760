"""End-to-end saliency sampling (JAX package `inference.py`; reference
`sample_image`, diffusion_trainer.py:545-640): encode video and audio
once, run the configured reverse process (DDIM, DDPM, DPM-Solver or
DPM-Solver++; the decoder runs once per denoiser call, the encoders
once), inverse-transform to a [0, 1] map. `sample_saliency_from_wave`
puts the log-mel frontend in front, for raw 16 kHz wave excerpts.
"""

from __future__ import annotations

from typing import Optional

import torch

from diff_sal_tpu_torch.audio.mel import device_audio_frontend
from diff_sal_tpu_torch.config import DataTransformConfig, SamplingConfig
from diff_sal_tpu_torch.data.transforms import inverse_data_transform
from diff_sal_tpu_torch.diffusion.dpm_solver import dpm_solver_sample
from diff_sal_tpu_torch.diffusion.sampling import ddim_sample, ddpm_sample
from diff_sal_tpu_torch.diffusion.schedule import DiffusionSchedule
from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel


@torch.no_grad()
def sample_saliency(model: VideoSaliencyModel, schedule: DiffusionSchedule,
                    sampling: SamplingConfig, data_cfg: DataTransformConfig,
                    rgb: torch.Tensor, audio: Optional[torch.Tensor] = None, *,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    training_target: str = "x0") -> torch.Tensor:
    """rgb (B, T, H, W, 3)[, audio (B, 9, 112, 192, 1)] -> (B, H', W', 1) in
    [0, 1]. Runs on the model's device, to which the inputs are moved.

    noise: the starting x_T (B, H', W', 1); drawn from `generator` when not
    given. Tests pass the noise the JAX package drew, since the two RNGs
    differ."""
    dev = next(model.parameters()).device
    rgb = rgb.to(dev)
    audio = None if audio is None else audio.to(dev)
    audio_feat = None
    if audio is not None and model.cfg.audio is not None:
        audio_feat = model.encode_audio(audio)
    feat_list = model.encode_visual(rgb)
    B = rgb.shape[0]
    h, w = model.cfg.decoder.img_size
    if noise is None:
        g_dev = generator.device if generator is not None else rgb.device
        noise = torch.randn((B, h, w, 1), generator=generator, device=g_dev)
    x = noise.to(device=rgb.device, dtype=torch.float32)

    def denoise_fn(x_t, t_vec):
        return model.denoise(x_t, t_vec, feat_list, audio_feat)

    if sampling.sample_type == "ddim":
        x = ddim_sample(schedule, denoise_fn, x, timesteps=sampling.timesteps,
                        eta=sampling.eta, training_target=training_target,
                        generator=generator)
    elif sampling.sample_type == "ddpm":
        x = ddpm_sample(schedule, denoise_fn, x, timesteps=sampling.timesteps,
                        training_target=training_target, generator=generator)
    elif sampling.sample_type in ("dpmsolver", "dpmsolver++"):
        x = dpm_solver_sample(schedule, denoise_fn, x, sampling=sampling,
                              training_target=training_target)
    else:
        raise NotImplementedError(f"sample_type={sampling.sample_type!r}")
    return inverse_data_transform(data_cfg, x)


def sample_saliency_from_wave(model: VideoSaliencyModel, schedule: DiffusionSchedule,
                              sampling: SamplingConfig, data_cfg: DataTransformConfig,
                              rgb: torch.Tensor, wave16k: torch.Tensor, *,
                              noise: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None,
                              training_target: str = "x0") -> torch.Tensor:
    """`sample_saliency` with the audio frontend in front, on the model's
    device: raw 16 kHz excerpts wave16k (B, 25600) -> log-mel examples ->
    VGGish -> ... -> maps (the reference runs the frontend in numpy on its
    loader's workers, SURVEY.md §2.4). The examples are resized to half
    the model's map size, (112, 192) at 224x384 (the reference's audio
    size)."""
    dev = next(model.parameters()).device
    h, w = model.cfg.decoder.img_size
    audio = device_audio_frontend(torch.as_tensor(wave16k).to(dev, torch.float32),
                                  (h // 2, w // 2))
    return sample_saliency(model, schedule, sampling, data_cfg, rgb, audio, noise=noise,
                           generator=generator, training_target=training_target)
