"""The training and evaluation loop (JAX package `train/trainer.py`;
reference `DiffusionTrainer`, diffusion_trainer.py): epoch and step loops,
a checkpoint per epoch, best-model selection by the highest validation
nss+cc+sim, TSV logs, prediction maps written to disk, and the 3-split
audio-visual fine-tune protocol (train_av_data, :139-298). The device math
is in `train_step.py`; this module owns orchestration, IO and
bookkeeping.

Random draws come from `torch.Generator`s on the model's device: the
training steps' from one seeded from (training.seed + 1, epoch) at the
start of each epoch, so that a resumed run draws what an uninterrupted one
would; evaluation's from seed 0 (`training.eval_fixed_rng`, the default)
or from a fresh seed per evaluation.

Data parallelism (`group`, the counterpart of JAX's `use_mesh`): every
rank runs this trainer on its own device with the same seeds, so the
models start equal, and its loaders give it rows r::W of each global
batch (`Loader(process_index, process_count)`, each epoch's indices cut to
a multiple of W first so that every rank takes the same number of steps).
The steps draw the global batch's noise and timestep from the shared
epoch generator, and the dropout and DropPath masks from a generator of
the rank's own, seeded from (training.seed + 1, epoch, rank). The logged
metrics are averaged over the ranks at each log point, and `evaluate`
weights every rank's batches into one average over the whole set, so the
ranks agree on every logged value and on the best epoch. Rank 0 alone
writes the TSV logs, the checkpoints and `best.json`, and a barrier
follows each write; `resume`, `restore_best` and `warm_start` read on
every rank. Each rank dumps the maps of its own items.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from diff_sal_tpu_torch.config import ExperimentConfig
from diff_sal_tpu_torch.diffusion.schedule import make_schedule
from diff_sal_tpu_torch.models.diff_model import build_model, param_counts
from diff_sal_tpu_torch.parallel import mesh
from diff_sal_tpu_torch.train.checkpoint import CheckpointManager, partial_load
from diff_sal_tpu_torch.train.ema import swap_in_ema
from diff_sal_tpu_torch.train.optim import make_optimizer_and_schedule
from diff_sal_tpu_torch.train.train_step import make_eval_step, make_train_step
from diff_sal_tpu_torch.utils.logging import (AverageMeterDict, StepTimer, TSVLogger,
                                              save_saliency_image)

ARRAY_KEYS = ("rgb", "salmap", "audio", "wave", "valid")
TRAIN_COLUMNS = ["epoch", "total_step", "loss", "main", "cc", "sim", "nss", "lr"]
VAL_COLUMNS = ["epoch", "total", "kl", "cc", "sim", "nss"]


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The training draws' generator for one epoch, seeded from (seed,
    epoch)."""
    s = int(np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(s)


def rank_generator(seed: int, epoch: int, rank: int, device) -> torch.Generator:
    """A rank's own generator for one epoch (its dropout and DropPath
    masks), seeded from (seed, epoch, rank)."""
    return torch.Generator(device=device).manual_seed(mesh.rank_seed(seed, epoch, rank))


class Trainer:
    def __init__(self, cfg: ExperimentConfig, workdir: str, steps_per_epoch: int,
                 n_epochs: Optional[int] = None, device="cuda", group: mesh.Group = None):
        """`group`: the data-parallel ranks' process group (`parallel/mesh.
        make_mesh`), or None for one process; `cfg.training.batch_size` is
        the global batch, which must divide by the ranks."""
        self.cfg = cfg
        self.group = (mesh.make_mesh_for_batch(cfg.training.batch_size, cfg.mesh.num_model,
                                               group)
                      if group is not None else None)
        self.rank = mesh.rank(self.group)
        self.is_main = self.rank == 0
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.device = torch.device(device)
        d = cfg.diffusion
        self.schedule = make_schedule(d.beta_schedule, d.beta_start, d.beta_end,
                                      d.num_diffusion_timesteps)
        self.steps_per_epoch = steps_per_epoch
        self.n_epochs = n_epochs or cfg.training.n_epochs
        self.ckpt = CheckpointManager(os.path.join(workdir, "weights"))
        self.model = self.optimizer = self.lr_schedule = None
        self.train_step = self.eval_step = None
        self.global_step = 0
        self.epoch = 0
        self.timer: Optional[StepTimer] = None  # the last epoch's data / step times

    # ------------------------------------------------------------------
    def init_state(self, sample_batch: Optional[Mapping] = None, seed: Optional[int] = None):
        """The model from seeded random weights (`build_model`, in train
        mode, on the trainer's device), the optimizer with its lr schedule
        (the one it applies, which `fit` logs) and the steps. The sample
        batch (what JAX's init traces) is not needed to build a torch
        model."""
        seed = self.cfg.training.seed if seed is None else seed
        self.model = build_model(self.cfg.model, seed=seed, device=self.device, train=True)
        print("param counts (M):", param_counts(self.model))
        self.optimizer, self.lr_schedule = make_optimizer_and_schedule(
            self.model, self.cfg.optim, self.steps_per_epoch, self.n_epochs)
        self.train_step = make_train_step(self.model, self.schedule, self.cfg, self.group)
        self.eval_step = make_eval_step(self.model, self.schedule, self.cfg, self.group)
        return self.model

    def _trainable_names(self):
        return [n for n, p in self.model.named_parameters() if p.requires_grad]

    def _require_state(self):
        if self.model is None:
            raise RuntimeError("init_state first")

    def warm_start(self, source_state_dict: Mapping[str, torch.Tensor]):
        """strict=0 partial load (reference model.py:17-22) of the model's
        parameters only, as JAX merges into `state.params` alone: buffers
        (the decoder's BatchNorm statistics) keep their initial values."""
        self._require_state()
        params = {n: p.detach() for n, p in self.model.named_parameters()}
        merged, loaded, skipped = partial_load(params, source_state_dict)
        self.model.load_state_dict(merged, strict=False)
        print(f"warm start: {loaded} parameters loaded, {skipped} kept")

    def resume(self):
        """Model, BatchNorm statistics, Adam's moments, count and EMA from
        the latest checkpoint; training continues after its epoch."""
        self._require_state()
        restored = self.ckpt.restore(map_location=self.device)
        if restored is not None:
            self.model.load_state_dict(restored["state_dict"])
            self.optimizer.load_state_dict(restored["optim_dict"], self._trainable_names())
            self.epoch = int(restored["epoch"]) + 1
            self.global_step = int(restored["step"])
            print(f"resumed at epoch {self.epoch}, step {self.global_step}")

    def restore_best(self):
        """The best checkpoint's state_dict into the model (reference
        test_av_data loads {split}_weights/best.pth, diffusion_trainer.py:
        848-854)."""
        self._require_state()
        restored = self.ckpt.restore_best(map_location=self.device)
        if restored is None:
            raise FileNotFoundError(f"no best checkpoint under {self.ckpt.directory}")
        self.model.load_state_dict(restored["state_dict"])
        print(f"loaded best checkpoint (epoch {int(restored['epoch'])})")

    def _save(self, epoch: int):
        if self.is_main:
            self.ckpt.save(epoch, {
                "state_dict": self.model.state_dict(),
                "optim_dict": self.optimizer.state_dict(self._trainable_names()),
                "epoch": epoch,
                "step": self.optimizer.count,
            })
        mesh.barrier(self.group, self.device)

    def _device_batch(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k]).to(self.device) for k in ARRAY_KEYS if k in batch}

    # ------------------------------------------------------------------
    def _record(self, meters: AverageMeterDict, pending):
        """The pending steps' metrics into the meters: as they are in one
        process, averaged over the ranks (the global batch's) in several."""
        if self.group is None:
            for p in pending:
                meters.update({k: float(v) for k, v in p.items()})
        else:
            for p in mesh.reduce_means(pending, self.group, self.device):
                meters.update(p)

    def fit(self, train_loader, val_loader=None, log_name: str = "train"):
        cfg = self.cfg
        logger = val_logger = None
        if self.is_main:
            logger = TSVLogger(os.path.join(self.workdir, f"{log_name}.log"), TRAIN_COLUMNS)
            val_logger = TSVLogger(os.path.join(self.workdir, f"{log_name}_val.log"),
                                   VAL_COLUMNS)
        try:
            for epoch in range(self.epoch, self.n_epochs):
                train_loader.set_epoch(epoch)
                generator = epoch_generator(cfg.training.seed + 1, epoch, self.device)
                masks = (rank_generator(cfg.training.seed + 1, epoch, self.rank, self.device)
                         if self.group is not None else None)
                meters = AverageMeterDict()
                timer = StepTimer()
                # metrics stay on the device until a log point: a float() per
                # step would wait for the device every step, and the loader's
                # next batch could not overlap the step
                pending = []
                for batch in train_loader:
                    timer.mark_data()
                    if masks is None:
                        metrics = self.train_step(self.optimizer, self._device_batch(batch),
                                                  generator)
                    else:
                        metrics = self.train_step(self.optimizer, self._device_batch(batch),
                                                  generator, mask_generator=masks)
                    pending.append(metrics)
                    self.global_step += 1
                    timer.mark_step()
                    if self.global_step % cfg.training.log_freq == 0:
                        self._record(meters, pending)
                        pending = []
                        if self.is_main:
                            print(f"epoch {epoch} step {self.global_step} "
                                  f"loss {meters.averages()['total']:.4f} data "
                                  f"{timer.data_time.avg:.3f}s step {timer.step_time.avg:.3f}s")
                self._record(meters, pending)
                self.timer = timer
                avg = meters.averages()
                if logger is not None:
                    logger.log(dict(epoch=epoch, total_step=self.global_step,
                                    loss=avg.get("total"), main=avg.get("main"),
                                    cc=avg.get("cc"), sim=avg.get("sim"), nss=avg.get("nss"),
                                    lr=self.lr_schedule(self.global_step)))
                self._save(epoch)
                if val_loader is not None:
                    scores = self.evaluate(val_loader)
                    if self.is_main:
                        val_logger.log(dict(epoch=epoch, **scores))
                        if self.ckpt.update_best(epoch, scores["total"]):
                            print(f"new best at epoch {epoch}: {scores['total']:.4f}")
                    mesh.barrier(self.group, self.device)
                self.epoch = epoch + 1
        finally:
            for lg in (logger, val_logger):
                if lg is not None:
                    lg.close()
        return self.model

    # ------------------------------------------------------------------
    def evaluate(self, loader, save_images_dir: Optional[str] = None, use_ema: bool = False,
                 generator: Optional[torch.Generator] = None) -> Dict[str, float]:
        """Validation / test loop (reference val / test / test_av_data,
        diffusion_trainer.py:642-896): the configured sampler, nss+cc+sim
        averaged over the whole set, each batch weighted by its real items
        (a padded tail batch's "valid" mask). The noise comes from seed 0
        by default (checkpoints ranked on the same noise); with
        `training.eval_fixed_rng=False` from a fresh seed per evaluation,
        as the reference's fresh randn per run (diffusion_trainer.py:
        118-120). Across ranks each rank scores its own rows and one
        all-reduce of (Σ score·n, Σ n) gives every rank the average over the
        whole set; the fresh seed is rank 0's."""
        self._require_state()
        if generator is None:
            seed = (0 if self.cfg.training.eval_fixed_rng
                    else mesh.broadcast_object(int.from_bytes(os.urandom(4), "little"),
                                               self.group))
            generator = torch.Generator(device=self.device).manual_seed(seed)
        meters = AverageMeterDict()
        ema = self.optimizer.ema if use_ema else None
        with swap_in_ema(self.model, ema or {}):
            for batch in loader:
                scores, pred = self.eval_step(self._device_batch(batch), generator)
                n = int(batch["valid"].sum()) if "valid" in batch else batch["rgb"].shape[0]
                meters.update({k: float(v) for k, v in scores.items()}, n)
                if save_images_dir:
                    self._dump_images(batch, pred, save_images_dir)
        if self.group is None:
            return meters.averages()
        # every rank reduces the same keys, scored batches or not
        count = max((m.count for m in meters.meters.values()), default=0)
        sums = {k: meters.meters[k].sum if k in meters.meters else 0.0
                for k in VAL_COLUMNS[1:]}
        return mesh.reduce_weighted(sums, count, self.group, self.device)

    def _dump_images(self, batch, pred: torch.Tensor, out_dir: str):
        """Write the predicted maps with the reference's paths
        (diffusion_trainer.py:884-935): AV '<ds>/<vid>/pred_sal_%06d.jpg',
        visual '<vid>/<gid>.png'; the maps scored are the maps written."""
        pred = pred.float().cpu().numpy()
        for i in range(pred.shape[0]):
            vid = str(batch["video_id"][i])
            gid = int(np.asarray(batch["gt_index"][i]))
            name = "pred_sal_%06d.jpg" % gid if "/" in vid else "%04d.png" % gid
            save_saliency_image(os.path.join(out_dir, vid, name), pred[i])


def rank_loader_kwargs(cfg: ExperimentConfig, group: mesh.Group = None) -> dict:
    """A `Loader`'s batch size and sharding for this rank: its rows of the
    global batch, `batch_size // W` of them."""
    if group is None:
        return {"batch_size": cfg.training.batch_size}
    group = mesh.make_mesh_for_batch(cfg.training.batch_size, cfg.mesh.num_model, group)
    return {"batch_size": cfg.training.batch_size // mesh.world_size(group),
            "process_index": mesh.rank(group), "process_count": mesh.world_size(group)}


def train_av_splits(cfg: ExperimentConfig, data_config: dict, workdir: str,
                    visual_best_params: Optional[Mapping[str, torch.Tensor]] = None,
                    splits: Iterable[str] = ("split1", "split2", "split3"),
                    loader_kwargs: Optional[dict] = None, packed_root: Optional[str] = None,
                    device="cuda", group: mesh.Group = None) -> Dict[str, Trainer]:
    """The 3-split AV fine-tune protocol (reference train_av_data,
    diffusion_trainer.py:139-298): one training per split, each
    warm-started from the visual model's best state_dict. With a
    data-parallel `group` each rank loads its rows of every batch
    (`batch_size // W`).

    `packed_root` switches to the decode-free memmap pipeline
    (`data/packed.PackedAVDataset`: uint8 frames and 16 kHz excerpts; the
    STAViS normalization and the log-mel frontend run in the step)."""
    from diff_sal_tpu_torch.data.av_dataset import build_av_datasets
    from diff_sal_tpu_torch.data.loader import Loader
    from diff_sal_tpu_torch.data.packed import PackedAVDataset

    if packed_root is not None and cfg.model.uint8_norm != "stavis":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, uint8_norm="stavis"))
    loader_kwargs = loader_kwargs or {}
    results = {}
    for split in splits:
        if packed_root is not None:
            train_ds = PackedAVDataset(packed_root, data_config, split, train=True)
            val_ds = PackedAVDataset(packed_root, data_config, split, train=False)
        else:
            train_ds = build_av_datasets(data_config, split, train=True)
            val_ds = build_av_datasets(data_config, split, train=False)
        kw = dict(rank_loader_kwargs(cfg, group), **loader_kwargs)
        train_loader = Loader(train_ds, shuffle=True, **kw)
        val_loader = Loader(val_ds, shuffle=False, **kw)
        t = Trainer(cfg, os.path.join(workdir, split), steps_per_epoch=max(len(train_loader), 1),
                    n_epochs=cfg.training.n_epochs_for_av_data, device=device, group=group)
        t.init_state(next(iter(train_loader)))
        if visual_best_params is not None:
            t.warm_start(visual_best_params)
        t.fit(train_loader, val_loader, log_name=split)
        results[split] = t
    return results
