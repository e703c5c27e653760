"""The training and evaluation steps (JAX package `train/train_step.py`;
reference `DiffusionTrainer.prepare_data` + `q_sample` + forward +
`get_lossv2` + backward + clip + step, diffusion_trainer.py:78-137,
347-376).

`make_train_step(model, schedule, cfg)` returns `train_step(optimizer,
batch, generator)`, which takes one optimizer step in place on the
model's device and returns the metrics {total, main, cc, sim, nss,
grad_norm} as 0-d tensors (no host sync). Its random draws are, in order,
the dequantization noise, the timestep (one scalar shared by the batch
under the reference's quirk), the x_T noise and the dropout and DropPath
masks inside the model; all come from the explicit `generator`, and the
first three can be handed in through `draws` (tests pass the JAX
package's, since the two RNGs differ).

`make_eval_step(model, schedule, cfg)` returns `eval_step(batch,
generator)`: `sample_saliency` with the configured sampler, then the
nss + cc + sim scores over the batch's `valid` mask.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from diff_sal_tpu_torch.audio.mel import device_audio_frontend
from diff_sal_tpu_torch.config import ExperimentConfig
from diff_sal_tpu_torch.data.transforms import data_transform
from diff_sal_tpu_torch.diffusion.schedule import DiffusionSchedule, q_sample
from diff_sal_tpu_torch.inference import sample_saliency
from diff_sal_tpu_torch.models.diff_model import VideoSaliencyModel
from diff_sal_tpu_torch.ops.kernels import acc_dtype
from diff_sal_tpu_torch.train.ema import ema_init, ema_update
from diff_sal_tpu_torch.train.losses import eval_scores, training_loss
from diff_sal_tpu_torch.train.optim import Optimizer


def audio_hw_for(cfg: ExperimentConfig) -> Tuple[int, int]:
    """The model's audio example grid is half the saliency-map size
    (reference audio_size = sample_size / 2: cfgs/dataset.json 192x112
    against 384x224), keeping it 16x the coarsest video scale."""
    h, w = cfg.model.decoder.img_size
    return (h // 2, w // 2)


def resolve_audio(batch, hw=None, device=None) -> Optional[torch.Tensor]:
    """The model's audio input from a batch: precomputed log-mel examples
    ("audio"), or raw 16 kHz wave excerpts ("wave", the packed AV
    pipeline) whose VGGish log-mel frontend runs here, in f32 on `device`
    (the wave's own when None), in place of the reference's numpy frontend
    on the loader's workers (saliency_db.py:449-497)."""
    if "audio" in batch:
        return batch["audio"]
    if "wave" in batch:
        wave = torch.as_tensor(batch["wave"])
        return device_audio_frontend(wave.to(device=device, dtype=torch.float32), hw)
    return None


def make_train_step(model: VideoSaliencyModel, schedule: DiffusionSchedule,
                    cfg: ExperimentConfig) -> Callable:
    """Returns train_step(optimizer, batch, generator=None, *, draws=None)
    -> metrics. batch: {"rgb": (B,T,H,W,3), "salmap": (B,H,W,1)[, "audio":
    (B,9,h,w,1) or "wave": (B, samples) at 16 kHz]}; draws: optional
    {"deq", "t", "noise"}."""
    T = schedule.num_timesteps
    tc = cfg.training

    def train_step(optimizer: Optimizer, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, *,
                   draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        draws = draws or {}
        p0 = next(model.parameters())
        dev, f = p0.device, acc_dtype(p0.dtype)
        gdev = generator.device if generator is not None else dev
        x0 = data_transform(cfg.data_transform, batch["salmap"].to(dev, f),
                            generator, noise=draws.get("deq"))
        B = x0.shape[0]
        t = draws.get("t")
        if t is None:
            shape = () if tc.shared_timestep_per_batch else (B,)
            t = torch.randint(0, T, shape, generator=generator, device=gdev)
        t = torch.as_tensor(t, device=dev).long().expand(B)
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=gdev)
        noise = noise.to(dev, x0.dtype)
        x_noisy = q_sample(schedule, x0, t, noise)
        target = x0 if tc.training_target == "x0" else noise
        data = {"rgb": batch["rgb"].to(dev), "input": x_noisy}
        audio = resolve_audio(batch, audio_hw_for(cfg), dev)
        if audio is not None:
            data["audio"] = audio.to(dev)

        model.train()
        pred = model(data, t.to(f), train=True, generator=generator)
        losses = training_loss(cfg.loss, pred, target)
        optimizer.zero_grad()
        losses["total"].backward()
        if tc.ema and optimizer.ema is None:
            optimizer.ema = ema_init(model)
        grad_norm = optimizer.step()
        if optimizer.ema is not None:
            ema_update(optimizer.ema, dict(model.named_parameters()), tc.ema_rate)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_eval_step(model: VideoSaliencyModel, schedule: DiffusionSchedule,
                   cfg: ExperimentConfig) -> Callable:
    """Returns eval_step(batch, generator=None, *, noise=None) -> (scores,
    pred): the configured sampler (DDIM NFE=1 by default), then the
    unweighted scores over the batch's `valid` mask when it has one. The
    predicted maps are returned so a caller scores and saves the same
    maps."""

    def eval_step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                  *, noise: Optional[torch.Tensor] = None
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        dev = next(model.parameters()).device
        pred = sample_saliency(model, schedule, cfg.sampling, cfg.data_transform, batch["rgb"],
                               resolve_audio(batch, audio_hw_for(cfg), dev), noise=noise,
                               generator=generator,
                               training_target=cfg.training.training_target)
        valid = batch.get("valid")
        scores = eval_scores(pred, batch["salmap"].to(pred.device, torch.float32),
                             mask=None if valid is None else valid.to(pred.device))
        return scores, pred

    return eval_step
