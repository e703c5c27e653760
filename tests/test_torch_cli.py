"""The port's command line (`python -m diff_sal_tpu_torch.cli`) on the CPU.

- Parser parity: every option of every subcommand of JAX's
  `build_parser()` has the same dest, default, choices, type, nargs,
  requirement and action in the port's parser, whose only extra option is
  `--device` (on the subcommands that build a model); `_make_cfg` gives
  `from_fields` of JAX's config over a set of command lines.
- End to end with `--device cpu` and `_make_cfg` patched to the tiny
  configs (MViT tiny at 64x96, B=2, as tests/test_cli_av.py:63-84):
  `pack dhf1k` and `pack av` write the files JAX's `pack` writes on the
  same raw trees; `train-visual --packed_root` (one epoch) writes a
  checkpoint, `best.json` and logs; `test` on a raw DHF1k tree dumps
  `<vid>/%04d.png` and prints its scores; `train-av --packed_root --splits
  split1` trains split1 and `test-av --save_img --gt_root` loads its best
  weights, dumps `split1_results/<ds>/<vid>/pred_sal_%06d.jpg` and scores
  them; `eval-metrics` on those dumps writes the CSV; `extract_frames` on
  a small AVI written with cv2 writes JAX's PNGs; `--device cuda` without
  a card raises.
- `slow`: JAX's `test-av` and the port's on one tree, the port on JAX's
  weights (the bridge) and JAX's evaluation noise: the printed scores
  within 1e-4.

The port's steps run on one torch thread (tests/test_torch_train_step.py).
"""

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from diff_sal_tpu import cli as jcli
from diff_sal_tpu import config as jc
from diff_sal_tpu.data import extract_frames as jextract
from diff_sal_tpu_torch import cli as pcli
from diff_sal_tpu_torch import config as pc
from diff_sal_tpu_torch.data import extract_frames as pextract
from diff_sal_tpu_torch.data import video_datasets
from diff_sal_tpu_torch.data.av_dataset import AV_DATASET_NAMES
from diff_sal_tpu_torch.data.synthetic import write_packed_av_tree, write_packed_dhf1k_tree
from test_torch_train_step import one_torch_thread
from test_trainer import HW, tiny_cfg

B = 2
AV_FRAMES = 3  # exhaustive test windows per video: AV_FRAMES - 1
AV_VIDEOS = {"diem": "d1", "avad": "a1"}  # the other datasets list no video


def _subparsers(parser):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def _options(parser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_parity():
    j_subs, p_subs = _subparsers(jcli.build_parser()), _subparsers(pcli.build_parser())
    assert list(p_subs) == list(j_subs) == ["train-visual", "train-av", "pack", "test",
                                            "test-av", "eval-metrics"]
    for name, jp in j_subs.items():
        j_opts, p_opts = _options(jp), _options(p_subs[name])
        extra = set(p_opts) - set(j_opts)
        assert extra == ({"device"} if "workdir" in j_opts else set()), (name, extra)
        for dest, ja in j_opts.items():
            pa = p_opts[dest]
            for attr in ("option_strings", "default", "choices", "type", "nargs", "required",
                         "const"):
                assert getattr(pa, attr) == getattr(ja, attr), (name, dest, attr)
            assert type(pa) is type(ja), (name, dest)
        if "device" in p_opts:
            assert p_opts["device"].default == "cuda"
        assert p_subs[name].get_default("fn").__name__ == jp.get_default("fn").__name__


ARGVS = [
    ["train-visual"],
    ["train-visual", "--bf16", "--lr", "0.001", "--batch_size", "2", "--seed", "3",
     "--log_freq", "7", "--fresh_eval_noise", "--pallas", "--no_mesh", "--wandb"],
    ["train-av", "--bf16", "--batch_size", "8"],
    ["test", "--log_freq", "0", "--seed", "5"],
    ["test-av", "--fresh_eval_noise", "--lr", "3e-5"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) for a in ARGVS])
def test_make_cfg_parity(argv):
    av = argv[0] in ("train-av", "test-av")
    j_cfg = jcli._make_cfg(jcli.build_parser().parse_args(argv), audio_visual=av)
    p_cfg = pcli._make_cfg(pcli.build_parser().parse_args(argv), audio_visual=av)
    assert p_cfg == pc.from_fields(j_cfg)


def test_device_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["train-visual", "--packed_root", str(tmp_path)],
                 ["test-av", "--dataset_json", str(tmp_path / "missing.json")]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            pcli.main(argv + ["--workdir", str(tmp_path / "run")])


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _tiny_visual(args, audio_visual):
    assert not audio_visual
    cfg = pc.from_fields(tiny_cfg())
    return dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, batch_size=B,
                                                                 log_freq=1))


def _tiny_av(args, audio_visual):
    assert audio_visual
    cfg = pc.from_fields(tiny_cfg())
    model = dataclasses.replace(cfg.model, audio=pc.VGGishConfig(),
                                spatiotemp=pc.AudioAttnConfig())
    return dataclasses.replace(cfg, model=model, training=dataclasses.replace(
        cfg.training, batch_size=B, log_freq=1, n_epochs_for_av_data=1))


@pytest.fixture(scope="module")
def raw_av(tmp_path_factory):
    """A raw AV tree in cfgs/dataset.json's schema: one short video for
    two datasets (jpg frames, eyeMap jpgs under one maps root shared by
    every dataset, a 22.05 kHz wav), an empty fold list for the rest."""
    from scipy.io import wavfile

    root = tmp_path_factory.mktemp("raw_av")
    rng = np.random.RandomState(7)
    config = {"sample_size": [HW[1], HW[0]], "audio_size": [48, 32], "sample_duration": 16,
              "with_audio": True, "split1": {}}
    ann = root / "ann"
    for name in AV_DATASET_NAMES:
        base = root / name
        base.mkdir()
        fold = base / "fold.txt"
        vid = AV_VIDEOS.get(name)
        with open(fold, "w") as f:
            if vid:
                f.write(f"{vid} {AV_FRAMES} 20.0\n")
        if vid:
            for i in range(1, AV_FRAMES + 1):
                _png(str(base / "video" / vid / ("img_%05d.jpg" % i)),
                     rng.randint(0, 255, (36, 64, 3), dtype=np.uint8))
                _png(str(ann / vid / "maps" / ("eyeMap_%05d.jpg" % i)),
                     rng.randint(1, 255, (36, 64), dtype=np.uint8))
                _png(str(ann / vid / "fixation" / ("eyeMap_%05d.jpg" % i)),
                     ((rng.rand(36, 64) > 0.9) * 255).astype(np.uint8))
            (base / "audio" / vid).mkdir(parents=True)
            wavfile.write(str(base / "audio" / vid / f"{vid}.wav"), 22050,
                          (rng.randn(22050) * 3000).astype(np.int16))
        config[f"video_path_{name}"] = str(base / "video")
        config[f"salmap_path_{name}"] = str(ann)
        config[f"audio_path_{name}"] = str(base / "audio")
        for flag in ("train", "test"):
            config["split1"][f"annotation_path_{name}_{flag}"] = str(fold)
    path = root / "dataset.json"
    path.write_text(json.dumps(config))
    return root, str(path), str(ann)


def _files(root):
    out = {}
    for r, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(r, n), "rb") as f:
                out[os.path.relpath(os.path.join(r, n), root)] = f.read()
    return out


def _run_jax(argv):
    """JAX's subcommand without its compile-cache setup."""
    args = jcli.build_parser().parse_args(argv)
    args.fn(args)


def test_pack_writes_the_jax_packages_files(tmp_path, raw_av):
    src = tmp_path / "dhf1k"
    rng = np.random.RandomState(3)
    for vid in ("1", "2"):
        for i in (1, 2, 3):
            _png(str(src / "frames" / vid / f"{i}.png"), rng.randint(0, 256, (36, 64, 3),
                                                                    dtype=np.uint8))
            if i != 2:  # a frame without a map packs zeros
                _png(str(src / "maps" / vid / ("%04d.png" % i)),
                     rng.randint(0, 256, (36, 64), dtype=np.uint8))
    _, dataset_json, _ = raw_av
    for argv in (["pack", "dhf1k", "--src", str(src)],
                 ["pack", "av", "--dataset_json", dataset_json, "--decode", "pil"]):
        _run_jax(argv + ["--dst", str(tmp_path / "j")])
        pcli.main(argv + ["--dst", str(tmp_path / "p")])
        j, p = _files(tmp_path / "j"), _files(tmp_path / "p")
        assert j and set(p) == set(j) and all(p[k] == j[k] for k in j), sorted(set(p) ^ set(j))
        for d in ("j", "p"):
            for k in j:
                os.remove(tmp_path / d / k)


@pytest.fixture(scope="module")
def visual_run(tmp_path_factory):
    """`train-visual --packed_root` for one epoch (one step, one
    validation batch) on packed trees written with numpy."""
    root = tmp_path_factory.mktemp("visual")
    # train: 49 frames give windows at 0 and 16 (len_snippet 32, stride
    # 16); val: 34 frames give windows at 0 and 1 (stride 1)
    train = write_packed_dhf1k_tree(str(root / "train"), HW, {"1": 49}, seed=1)
    val = write_packed_dhf1k_tree(str(root / "val"), HW, {"601": 34}, seed=2)
    work = str(root / "work")
    mp = pytest.MonkeyPatch()
    mp.setattr(pcli, "_make_cfg", _tiny_visual)
    try:
        with one_torch_thread():
            pcli.main(["train-visual", "--packed_root", train, "--packed_val_root", val,
                       "--workdir", work, "--n_epochs", "1", "--n_threads", "0",
                       "--device", "cpu"])
    finally:
        mp.undo()
    return root, work


def test_train_visual_writes_checkpoint_and_logs(visual_run):
    _, work = visual_run
    weights = os.path.join(work, "weights")
    assert sorted(os.listdir(weights)) == ["0.pth", "best.json"]
    with open(os.path.join(weights, "best.json")) as f:
        assert json.load(f)["step"] == 0
    for name, rows in (("train.log", 2), ("train_val.log", 2)):
        with open(os.path.join(work, name)) as f:
            lines = f.read().splitlines()
        assert len(lines) == rows and all(np.isfinite(float(v)) for v in lines[1].split("\t"))
    sd = torch.load(os.path.join(weights, "0.pth"), weights_only=True)["state_dict"]
    assert any(k.startswith("visual_net.") for k in sd)


def test_test_dumps_maps_and_prints_scores(visual_run, tmp_path, monkeypatch, capsys):
    _, work = visual_run
    data = tmp_path / "dhf1k"
    for v in range(1, 601):  # DHF1k's val split is videos 601-700
        (data / "frames" / str(v)).mkdir(parents=True)
    rng = np.random.RandomState(4)
    for i in range(1, 35):
        _png(str(data / "frames" / "601" / f"{i}.png"),
             rng.randint(0, 256, (36, 64, 3), dtype=np.uint8))
        _png(str(data / "maps" / "601" / ("%04d.png" % i)),
             rng.randint(1, 256, (36, 64), dtype=np.uint8))
    monkeypatch.setattr(pcli, "_make_cfg", _tiny_visual)
    monkeypatch.setattr(video_datasets, "DHF1KDataset",
                        functools.partial(video_datasets.DHF1KDataset, img_size=HW))
    out = tmp_path / "dumps"
    with one_torch_thread():
        pcli.main(["test", "--path_data", str(data), "--workdir", work, "--out_dir", str(out),
                   "--n_threads", "0", "--device", "cpu"])
    scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(scores) == {"total", "kl", "cc", "sim", "nss"}
    assert all(np.isfinite(v) for v in scores.values())
    # windows at 0 and 1, each scored at its 16 frames' centre (1-based 9, 10)
    assert sorted(os.listdir(out / "601")) == ["0009.png", "0010.png"]


@pytest.fixture(scope="module")
def av_run(tmp_path_factory, raw_av):
    """`train-av --packed_root --splits split1` (one epoch: one step, one
    validation batch), then `test-av --save_img --gt_root` on the raw tree
    with split1's best weights."""
    root = tmp_path_factory.mktemp("av")
    folds = {"train": (("v1", 80),), "test": (("v2", 80),)}
    config = write_packed_av_tree(str(root / "packed"), HW, folds, fps=20.0)
    (root / "packed.json").write_text(json.dumps(config))
    work = str(root / "work")
    _, dataset_json, ann = raw_av
    mp = pytest.MonkeyPatch()
    mp.setattr(pcli, "_make_cfg", _tiny_av)
    capture = {}
    try:
        with one_torch_thread():
            pcli.main(["train-av", "--packed_root", str(root / "packed"), "--dataset_json",
                       str(root / "packed.json"), "--splits", "split1", "--workdir", work,
                       "--n_threads", "0", "--device", "cpu"])
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                pcli.main(["test-av", "--dataset_json", dataset_json, "--splits", "split1",
                           "--workdir", work, "--save_img", "--gt_root", ann,
                           "--processes", "1", "--n_threads", "0", "--device", "cpu"])
            capture["test_av"] = buf.getvalue()
    finally:
        mp.undo()
    return work, ann, capture


def test_train_av_then_test_av(av_run):
    work, _, capture = av_run
    weights = os.path.join(work, "split1", "weights")
    assert sorted(os.listdir(weights)) == ["0.pth", "best.json"]
    lines = capture["test_av"].strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"split1"} and all(np.isfinite(v) for v in last["split1"].values())
    # the offline scores, one line per dataset with dumps
    assert sorted(line.split()[1] for line in lines if line.startswith("split1 ")) == sorted(
        AV_VIDEOS)
    results = os.path.join(work, "split1_results")
    for ds, vid in AV_VIDEOS.items():
        names = sorted(os.listdir(os.path.join(results, ds, vid)))
        assert len(names) == AV_FRAMES - 1 and all(
            n.startswith("pred_sal_") and n.endswith(".jpg") for n in names), names
    with open(results + "_metrics.csv") as f:
        assert len(f.read().splitlines()) == 1 + len(AV_VIDEOS)


def test_eval_metrics_writes_the_csv(av_run, capsys):
    work, ann, _ = av_run
    results = os.path.join(work, "split1_results")
    os.remove(results + "_metrics.csv")
    np.random.seed(0)
    pcli.main(["eval-metrics", results, "av", "--gt_root", ann, "--processes", "1"])
    rows = capsys.readouterr().out.strip().splitlines()
    assert sorted(r.split()[0] for r in rows) == sorted(AV_VIDEOS)
    with open(results + "_metrics.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == "Task,AUC_J ,AUC_S ,CC ,NSS ,Sim" and len(lines) == 1 + len(AV_VIDEOS)


def test_extract_frames_writes_the_jax_packages_pngs(tmp_path):
    import cv2

    videos = tmp_path / "videos"
    videos.mkdir()
    rng = np.random.RandomState(5)
    writer = cv2.VideoWriter(str(videos / "7.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                             (32, 24))
    for _ in range(3):
        writer.write(rng.randint(0, 256, (24, 32, 3), dtype=np.uint8))
    writer.release()
    ann = tmp_path / "ann" / "7" / "maps"
    ann.mkdir(parents=True)
    _png(str(ann / "0001.png"), rng.randint(0, 256, (24, 32), dtype=np.uint8))
    jextract.main([str(videos), str(tmp_path / "j"), "--annotation_dir", str(tmp_path / "ann")])
    pextract.main([str(videos), str(tmp_path / "p"), "--annotation_dir", str(tmp_path / "ann")])
    j, p = _files(tmp_path / "j"), _files(tmp_path / "p")
    assert sorted(j) == sorted(p) == ["frames/7/1.png", "frames/7/2.png", "frames/7/3.png",
                                      "maps/7/0001.png"]
    assert all(p[k] == j[k] for k in j)


@pytest.mark.slow
def test_test_av_matches_jax(tmp_path, raw_av, monkeypatch, capsys):
    """JAX's `test-av` and the port's on one raw tree: the port's split1
    checkpoint holds JAX's weights (the bridge), its evaluation takes the
    x_T noise JAX's draws from its keys (PRNGKey(0) split once per batch,
    tests/test_torch_trainer.py), and the scores agree within 1e-4 (the
    printed ones, rounded to 4 decimals, by one printed step at most)."""
    import jax

    from diff_sal_tpu.data.av_dataset import build_av_datasets as j_build
    from diff_sal_tpu.data.loader import Loader as JLoader
    from diff_sal_tpu.train.trainer import Trainer as JTrainer
    from diff_sal_tpu_torch import bridge
    from diff_sal_tpu_torch.train import trainer as ptrainer
    from diff_sal_tpu_torch.train.checkpoint import CheckpointManager

    _, dataset_json, _ = raw_av
    j_cfg = dataclasses.replace(tiny_cfg(), model=dataclasses.replace(
        tiny_cfg().model, audio=jc.VGGishConfig(), spatiotemp=jc.AudioAttnConfig()))
    with open(dataset_json) as f:
        data_config = json.load(f)
    j_loader = JLoader(j_build(data_config, "split1", train=False, exhaustive=True), B,
                       shuffle=False, drop_last=False, pad_last=True, num_workers=0)
    n_batches = len(j_loader)
    t = JTrainer(j_cfg, str(tmp_path / "j" / "split1"), steps_per_epoch=1)
    t.init_state(next(iter(j_loader)))
    t._save(0)
    t.ckpt.update_best(0, 1.0)
    sd = bridge.state_dict_from_flax({"params": t.state.params,
                                      "batch_stats": t.state.batch_stats},
                                     j_cfg.model.visual.num_layers)
    mgr = CheckpointManager(str(tmp_path / "p" / "split1" / "weights"))
    mgr.save(0, {"state_dict": sd, "epoch": 0, "step": 0})
    mgr.update_best(0, 1.0)

    monkeypatch.setattr(jcli, "_make_cfg", lambda args, audio_visual: j_cfg)
    monkeypatch.setattr(pcli, "_make_cfg", _tiny_av)
    raw = {}
    for name, cls in (("j", JTrainer), ("p", ptrainer.Trainer)):
        def evaluate(self, *a, _f=cls.evaluate, _n=name, **kw):
            raw[_n] = _f(self, *a, **kw)
            return raw[_n]
        monkeypatch.setattr(cls, "evaluate", evaluate)
    argv = ["test-av", "--dataset_json", dataset_json, "--splits", "split1", "--n_threads", "0"]
    _run_jax(argv + ["--workdir", str(tmp_path / "j")])
    j_scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    h, w = HW
    rng, noise = jax.random.PRNGKey(0), []
    for _ in range(n_batches):
        rng, key = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(jax.random.split(key, 3)[1], (B, h, w, 1)))))
    init_state = ptrainer.Trainer.init_state

    def with_noise(self, *a, **kw):
        out = init_state(self, *a, **kw)
        step = self.eval_step
        self.eval_step = lambda batch, gen: step(batch, gen, noise=noise.pop(0))
        return out

    monkeypatch.setattr(ptrainer.Trainer, "init_state", with_noise)
    with one_torch_thread():
        pcli.main(argv + ["--workdir", str(tmp_path / "p"), "--device", "cpu"])
    p_scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not noise and set(p_scores["split1"]) == set(j_scores["split1"]) == set(raw["p"])
    for k, v in raw["j"].items():
        assert abs(raw["p"][k] - v) <= 1e-4, (k, raw)
        # printed to 4 decimals: one printed step apart at most
        assert abs(p_scores["split1"][k] - j_scores["split1"][k]) <= 1e-4 + 1e-12, (
            k, p_scores, j_scores)
