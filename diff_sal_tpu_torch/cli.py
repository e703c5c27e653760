"""Command-line entry points of the port (JAX package `cli.py`):

    python -m diff_sal_tpu_torch.cli <command> [options]

  train-visual   DHF1k / Hollywood2 / UCF visual pretraining (`Trainer`)
  train-av       the 6-dataset 3-split audio-visual fine-tune
                 (`train_av_splits`)
  pack           one-time pack of a DHF1k tree or the AV corpus into uint8
                 memmaps (`data/packed.py`)
  test           inference and prediction dumping on a visual split
  test-av        per-split AV inference, dumps and optional offline scores
  eval-metrics   offline metric CSV over dumped predictions

The subcommands, options, defaults and choices are the JAX package's, so
any of its command lines parses unchanged. `--pallas` (the port always
runs its hand-written kernels) and `--wandb` (read by neither CLI) are
accepted and change nothing. One option is added: `--device` (default
`cuda`) on the subcommands that build a model; asking for `cuda` where
there is no card raises.

Data parallelism: the subcommands that build a model run on every rank of
a torchrun launch, each rank on its own card (`cuda` means the card of
the rank's LOCAL_RANK), the global `--batch_size` split over the ranks:

    python -m torch.distributed.run --nproc_per_node N \
        -m diff_sal_tpu_torch.cli train-av --packed_root ... --batch_size B

(`parallel/multihost.py` joins the group: NCCL where each rank has a card
of its own, gloo on the CPU or where ranks share a card). `--no_mesh`
means one process on one device, and raises under a launch of more than
one rank, whose ranks would each train alone. Decoding
images (raw datasets, `pack`, `test`, the dumps of `test-av`,
`eval-metrics`) needs PIL or cv2; training from packed trees
(`--packed_root`) needs neither. Checkpoints are the port's
(`train/checkpoint.py`): `--pretrain_path` names a checkpoint directory
(`<workdir>/weights`) whose best checkpoint's state_dict warm-starts the
model.
"""

from __future__ import annotations

import argparse
import json
import os


def _common(p: argparse.ArgumentParser):
    p.add_argument("--path_data", default="VideoSalPrediction/DHF1k_extracted")
    p.add_argument("--workdir", default="experiments/run")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--n_epochs", type=int, default=None)
    p.add_argument("--len_snippet", type=int, default=32)
    p.add_argument("--n_threads", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume_training", action="store_true")
    p.add_argument("--pretrain_path", default=None,
                   help="checkpoint directory (<workdir>/weights) whose best "
                        "state_dict warm-starts the model")
    p.add_argument("--no_mesh", action="store_true",
                   help="one process on one device, no process group; raises "
                        "under a torchrun launch of more than one rank")
    p.add_argument("--wandb", action="store_true",
                   help="accepted for the JAX CLI's command lines; no effect "
                        "(logs are TSV files under the workdir)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 mixed-precision compute (params stay f32)")
    p.add_argument("--pallas", action="store_true",
                   help="accepted for the JAX CLI's command lines; no effect: "
                        "the port always runs its hand-written kernels")
    p.add_argument("--log_freq", type=int, default=None)
    p.add_argument("--decode", default="pil", choices=["pil", "cv2"],
                   help="frame decode backend: pil (reference parity) or "
                        "cv2 (2-3x faster)")
    p.add_argument("--fresh_eval_noise", action="store_true",
                   help="draw fresh starting noise per evaluation (reference "
                        "behavior) instead of the deterministic default")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model and its steps: cuda (the "
                        "default; raises without a card) or cpu")


def _make_cfg(args, audio_visual: bool):
    """The experiment config of a command line, as JAX `_make_cfg`
    (cli.py:52-89) builds it; `--pallas` selects no lowering here."""
    import dataclasses

    from diff_sal_tpu_torch.config import audio_visual_experiment, visual_experiment

    cfg = audio_visual_experiment() if audio_visual else visual_experiment()
    cfg = dataclasses.replace(
        cfg,
        optim=dataclasses.replace(cfg.optim, lr=args.lr),
        training=dataclasses.replace(cfg.training, batch_size=args.batch_size, seed=args.seed),
    )
    if getattr(args, "bf16", False):
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    if getattr(args, "log_freq", None):
        cfg = dataclasses.replace(
            cfg, training=dataclasses.replace(cfg.training, log_freq=args.log_freq))
    if getattr(args, "fresh_eval_noise", False):
        cfg = dataclasses.replace(
            cfg, training=dataclasses.replace(cfg.training, eval_fixed_rng=False))
    return cfg


def _device(args):
    """`--device` as a torch.device; raises for cuda without a card. Under
    a launcher (LOCAL_RANK set) a bare `cuda` is the rank's card."""
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is false; pass "
                           "--device cpu to run on the CPU")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        from diff_sal_tpu_torch.parallel.multihost import rank_device

        dev = rank_device(int(os.environ["LOCAL_RANK"]), "cuda")
    return dev


def _setup(args, cfg):
    """(device, data-parallel group or None) of a command that builds a
    model: one process with `--no_mesh` or without a launcher's
    environment, else this rank of the launch's process group."""
    from diff_sal_tpu_torch.parallel import mesh, multihost

    dev = _device(args)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.no_mesh:
        if world > 1:
            raise RuntimeError(f"--no_mesh under a launch of WORLD_SIZE={world} ranks: each "
                               "rank would train alone on its own data; drop --no_mesh, or "
                               "run one process")
        return dev, None
    if multihost.initialize(device=dev) is None:
        return dev, None
    args.joined_group = True  # main() leaves it
    return dev, mesh.make_mesh(cfg.mesh.num_data, cfg.mesh.num_model)


def _loader(ds, cfg, group, **kw):
    """A `Loader` of this rank's rows of each global batch."""
    from diff_sal_tpu_torch.data.loader import Loader
    from diff_sal_tpu_torch.train.trainer import rank_loader_kwargs

    return Loader(ds, **rank_loader_kwargs(cfg, group), **kw)


def _best_state_dict(path: str, device):
    """The best checkpoint's state_dict under a checkpoint directory, or
    None where it has no best checkpoint."""
    from diff_sal_tpu_torch.train.checkpoint import CheckpointManager

    src = CheckpointManager(path).restore_best(map_location=device)
    return src["state_dict"] if src else None


def _visual_dataset(args, mode: str):
    from diff_sal_tpu_torch.data.video_datasets import (DHF1KDataset, HollywoodDataset,
                                                        UCFDataset)

    ds_cls = {"dhf1k": DHF1KDataset, "holly": HollywoodDataset,
              "ucf": UCFDataset}[args.data_type]
    return ds_cls(args.path_data, args.len_snippet, mode, decode=args.decode)


def cmd_train_visual(args):
    from diff_sal_tpu_torch.train.trainer import Trainer

    cfg = _make_cfg(args, audio_visual=False)
    dev, group = _setup(args, cfg)
    if args.packed_root:
        # the decode-free uint8 memmap pipeline (data/packed.py; pack once
        # with `pack dhf1k`); normalization happens on the device
        from diff_sal_tpu_torch.data.packed import PackedVideoDataset

        train_ds = PackedVideoDataset(args.packed_root, args.len_snippet, "train")
        val_ds = (PackedVideoDataset(args.packed_val_root, args.len_snippet, "val")
                  if args.packed_val_root else None)
    else:
        train_ds = _visual_dataset(args, "train")
        # "val" for every data_type: Hollywood2 / UCF map it to the
        # `testing` tree with GT maps, as the reference's get_val_loader
        # (cfgs/visual.py:96-104)
        val_ds = _visual_dataset(args, "val")
    train_loader = _loader(train_ds, cfg, group, shuffle=True, num_workers=args.n_threads)
    val_loader = (_loader(val_ds, cfg, group, shuffle=False, num_workers=args.n_threads)
                  if val_ds is not None else None)
    t = Trainer(cfg, args.workdir, steps_per_epoch=len(train_loader), n_epochs=args.n_epochs,
                device=dev, group=group)
    t.init_state()
    if args.pretrain_path:
        src = _best_state_dict(args.pretrain_path, dev)
        if src:
            t.warm_start(src)
    if args.resume_training:
        t.resume()
    t.fit(train_loader, val_loader)


def cmd_train_av(args):
    from diff_sal_tpu_torch.train.trainer import train_av_splits

    cfg = _make_cfg(args, audio_visual=True)
    dev, group = _setup(args, cfg)
    with open(args.dataset_json) as f:
        data_config = json.load(f)
    visual = _best_state_dict(args.pretrain_path, dev) if args.pretrain_path else None
    train_av_splits(cfg, data_config, args.workdir, visual, splits=args.splits.split(","),
                    loader_kwargs=dict(num_workers=args.n_threads),
                    packed_root=args.packed_root, device=dev, group=group)


def cmd_pack(args):
    """One-time packing pass: decode the source tree once into uint8 /
    float32 memmaps at the training resolution (data/packed.py). 'dhf1k'
    packs a frames/ + maps/ tree; 'av' packs the 6-dataset corpus named by
    --dataset_json (frames, eyeMaps and 16 kHz-resampled waves)."""
    if args.corpus == "dhf1k":
        from diff_sal_tpu_torch.data.packed import pack_dhf1k_tree

        pack_dhf1k_tree(args.src, args.dst, decode=args.decode)
    else:
        from diff_sal_tpu_torch.data.packed import pack_av_tree

        with open(args.dataset_json) as f:
            data_config = json.load(f)
        # dataset.json carries sample_size as [W, H] (reference schema)
        sw, sh = data_config.get("sample_size", [384, 224])
        pack_av_tree(data_config, args.dst, img_size=(sh, sw), decode=args.decode)
    print(f"packed -> {args.dst}")


def cmd_test(args):
    """Visual test on any of the three datasets (reference `test()`,
    diffusion_trainer.py:714-765, scores the loader get_val_loader builds):
    the best checkpoint's weights where there is one, else the latest
    checkpoint's; dumps '<out_dir>/<vid>/%04d.png' and prints the
    nss+cc+sim scores as JSON."""
    from diff_sal_tpu_torch.train.trainer import Trainer

    cfg = _make_cfg(args, audio_visual=False)
    dev, group = _setup(args, cfg)
    loader = _loader(_visual_dataset(args, "val"), cfg, group, shuffle=False,
                     num_workers=args.n_threads)
    t = Trainer(cfg, args.workdir, steps_per_epoch=1, device=dev, group=group)
    t.init_state()
    try:
        t.restore_best()  # reference test() loads weights/best.pth (:722-729)
    except FileNotFoundError:
        t.resume()
    scores = t.evaluate(loader, save_images_dir=args.out_dir)
    if t.is_main:
        print(json.dumps({k: round(v, 4) for k, v in scores.items()}))


def cmd_test_av(args):
    """AV inference (reference test_av_data, diffusion_trainer.py:823-896):
    per split, that split's best weights over the exhaustive (step-1)
    6-dataset test loaders; with --save_img the maps go to
    '{split}_results/<ds>/<vid>/pred_sal_%06d.jpg', and with --gt_root too
    they are scored offline to CSV. Prints the nss+cc+sim scores."""
    from diff_sal_tpu_torch.data.av_dataset import build_av_datasets
    from diff_sal_tpu_torch.parallel import mesh
    from diff_sal_tpu_torch.train.trainer import Trainer

    cfg = _make_cfg(args, audio_visual=True)
    dev, group = _setup(args, cfg)
    with open(args.dataset_json) as f:
        data_config = json.load(f)
    all_scores = {}
    for split in args.splits.split(","):
        ds = build_av_datasets(data_config, split, train=False, exhaustive=True)
        loader = _loader(ds, cfg, group, shuffle=False, drop_last=False, pad_last=True,
                         num_workers=args.n_threads)
        t = Trainer(cfg, os.path.join(args.workdir, split), steps_per_epoch=1, device=dev,
                    group=group)
        t.init_state()
        t.restore_best()
        result_dir = os.path.join(args.workdir, f"{split}_results")
        scores = t.evaluate(loader, save_images_dir=result_dir if args.save_img else None)
        all_scores[split] = {k: round(v, 4) for k, v in scores.items()}
        mesh.barrier(group, dev)  # every rank's maps are on disk
        if not t.is_main:
            continue
        print(json.dumps({split: all_scores[split]}))
        if args.save_img and args.gt_root:
            from diff_sal_tpu_torch.metrics.offline import evaluate_predictions

            res = evaluate_predictions(result_dir, args.gt_root, "av",
                                       processes=args.processes)
            for task, vals in res.items():
                print(split, task, vals)
    if t.is_main:
        print(json.dumps(all_scores))


def cmd_eval_metrics(args):
    from diff_sal_tpu_torch.metrics.offline import evaluate_predictions

    vid_list = list(range(601, 701)) if args.data_type == "dhf1k" else None
    res = evaluate_predictions(args.prediction_path, args.gt_root, args.data_type, vid_list,
                               processes=args.processes)
    for task, vals in res.items():
        print(task, vals)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="diff_sal_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train-visual")
    _common(p)
    p.add_argument("--data_type", default="dhf1k", choices=["dhf1k", "holly", "ucf"])
    p.add_argument("--packed_root", default=None,
                   help="packed uint8 memmap tree (data/packed.py)")
    p.add_argument("--packed_val_root", default=None)
    p.set_defaults(fn=cmd_train_visual)

    p = sub.add_parser("train-av")
    _common(p)
    p.add_argument("--dataset_json", default="cfgs/dataset.json")
    p.add_argument("--splits", default="split1,split2,split3")
    p.add_argument("--packed_root", default=None,
                   help="packed AV memmap tree (pack with `pack av`); "
                        "frames and the log-mel frontend run on the device")
    p.set_defaults(fn=cmd_train_av)

    p = sub.add_parser("pack")
    p.add_argument("corpus", choices=["dhf1k", "av"])
    p.add_argument("--src", default=None, help="dhf1k source tree")
    p.add_argument("--dst", required=True)
    p.add_argument("--dataset_json", default="cfgs/dataset.json")
    p.add_argument("--decode", default="cv2", choices=["pil", "cv2"])
    p.set_defaults(fn=cmd_pack)

    p = sub.add_parser("test")
    _common(p)
    p.add_argument("--data_type", default="dhf1k", choices=["dhf1k", "holly", "ucf"])
    p.add_argument("--out_dir", default="results")
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser("test-av")
    _common(p)
    p.add_argument("--dataset_json", default="cfgs/dataset.json")
    p.add_argument("--splits", default="split1,split2,split3")
    p.add_argument("--save_img", action="store_true")
    p.add_argument("--gt_root", default=None,
                   help="score dumped images offline to CSV when given")
    p.add_argument("--processes", type=int, default=8)
    p.set_defaults(fn=cmd_test_av)

    p = sub.add_parser("eval-metrics")
    p.add_argument("prediction_path")
    p.add_argument("data_type", choices=["dhf1k", "holly", "ucf", "av"])
    p.add_argument("--gt_root", required=True)
    p.add_argument("--processes", type=int, default=8)
    p.set_defaults(fn=cmd_eval_metrics)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    finally:
        if getattr(args, "joined_group", False):
            from diff_sal_tpu_torch.parallel import multihost

            multihost.shutdown()


if __name__ == "__main__":
    main()
