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

Across data-parallel ranks (`group`, `parallel/mesh.py`; JAX jits the
same step over a data mesh) each rank holds rows r::W of the global batch.
The step then:
* draws the dequantization noise, the timestep and the x_T noise for the
  global batch from the generator every rank seeds alike, and takes its
  rows, so that the ranks train at one timestep as JAX's one key gives
  (handed-in `draws` are the global batch's too);
* takes the model's dropout and DropPath masks from `mask_generator`, the
  rank's own generator: masks differ between ranks (JAX draws the global
  batch's masks from its one key, an intended difference);
* normalises the decoder's BatchNorms over the global batch
  (`VideoSaliencyModel.set_stats_group`);
* averages the gradients over the ranks before the optimizer's clip and
  Adam (`mesh.average_gradients`), so `grad_norm` is the global norm and
  every rank takes the same update.
Its metrics are the rank's own; the trainer averages them over the ranks
at its log points (`mesh.reduce_means`). The eval step draws x_T for the
global batch likewise and returns its rows' maps and scores.
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
from diff_sal_tpu_torch.parallel import mesh
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
                    cfg: ExperimentConfig, group: mesh.Group = None) -> Callable:
    """Returns train_step(optimizer, batch, generator=None, *, draws=None,
    mask_generator=None) -> metrics. batch: {"rgb": (B,T,H,W,3), "salmap":
    (B,H,W,1)[, "audio": (B,9,h,w,1) or "wave": (B, samples) at 16 kHz]};
    draws: optional {"deq", "t", "noise"}. With a data-parallel `group`
    the batch is this rank's rows, `draws` the global batch's, and
    `mask_generator` (the rank's own) is required; the model's BatchNorms
    are set to the group here."""
    T = schedule.num_timesteps
    tc = cfg.training
    n_ranks, r = mesh.world_size(group), mesh.rank(group)
    if group is not None:
        model.set_stats_group(group)

    def rows(x):
        return x if group is None else x[r::n_ranks]

    def train_step(optimizer: Optimizer, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, *,
                   draws: Optional[Dict[str, torch.Tensor]] = None,
                   mask_generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        draws = draws or {}
        if group is None:
            mask_generator = generator
        elif mask_generator is None:
            raise ValueError("a data-parallel step takes its dropout and DropPath masks from "
                             "the rank's own mask_generator")
        p0 = next(model.parameters())
        dev, f = p0.device, acc_dtype(p0.dtype)
        gdev = generator.device if generator is not None else dev
        deq = draws.get("deq")
        x0 = data_transform(cfg.data_transform, batch["salmap"].to(dev, f), generator,
                            noise=None if deq is None else rows(deq),
                            rows=None if group is None else (r, n_ranks))
        B = x0.shape[0]
        t = draws.get("t")
        if t is None:
            shape = () if tc.shared_timestep_per_batch else (B * n_ranks,)
            t = torch.randint(0, T, shape, generator=generator, device=gdev)
        t = torch.as_tensor(t, device=dev).long()
        t = (t if t.ndim == 0 else rows(t)).expand(B)
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn((B * n_ranks,) + tuple(x0.shape[1:]), generator=generator,
                                device=gdev)
        noise = rows(noise).to(dev, x0.dtype)
        x_noisy = q_sample(schedule, x0, t, noise)
        target = x0 if tc.training_target == "x0" else noise
        data = {"rgb": batch["rgb"].to(dev), "input": x_noisy}
        audio = resolve_audio(batch, audio_hw_for(cfg), dev)
        if audio is not None:
            data["audio"] = audio.to(dev)

        model.train()
        pred = model(data, t.to(f), train=True, generator=mask_generator)
        losses = training_loss(cfg.loss, pred, target)
        optimizer.zero_grad()
        losses["total"].backward()
        if group is not None:
            mesh.average_gradients(optimizer.params, group)
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
                   cfg: ExperimentConfig, group: mesh.Group = None) -> Callable:
    """Returns eval_step(batch, generator=None, *, noise=None) -> (scores,
    pred): the configured sampler (DDIM NFE=1 by default), then the
    unweighted scores over the batch's `valid` mask when it has one. The
    predicted maps are returned so a caller scores and saves the same
    maps. With a data-parallel `group` the batch is this rank's rows: x_T
    (or the handed-in `noise`) is the global batch's, cut to them, and the
    scores are over them (`mesh.reduce_weighted` makes them global). A
    sampler that draws inside its loop (DDPM, DDIM with eta > 0) draws
    there from a generator of the rank's own, seeded from the shared one."""
    n_ranks, r = mesh.world_size(group), mesh.rank(group)
    s = cfg.sampling
    draws_inside = s.sample_type == "ddpm" or (s.sample_type == "ddim" and s.eta > 0)

    def eval_step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                  *, noise: Optional[torch.Tensor] = None
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        dev = next(model.parameters()).device
        if group is not None:
            b = batch["rgb"].shape[0]
            gdev = generator.device if generator is not None else dev
            if noise is None:
                h, w = model.cfg.decoder.img_size
                noise = torch.randn((b * n_ranks, h, w, 1), generator=generator, device=gdev)
            noise = noise[r::n_ranks]
            if draws_inside:
                seed = int(torch.randint(0, 2**62, (), generator=generator, device=gdev))
                generator = torch.Generator(device=gdev).manual_seed(mesh.rank_seed(seed, 0, r))
        pred = sample_saliency(model, schedule, cfg.sampling, cfg.data_transform, batch["rgb"],
                               resolve_audio(batch, audio_hw_for(cfg), dev), noise=noise,
                               generator=generator,
                               training_target=cfg.training.training_target)
        valid = batch.get("valid")
        scores = eval_scores(pred, batch["salmap"].to(pred.device, torch.float32),
                             mask=None if valid is None else valid.to(pred.device))
        return scores, pred

    return eval_step
