"""The port's data feeding against the JAX package's, on the CPU: the
synthetic datasets, DHF1K / Hollywood2 / UCF-Sports, the AV datasets in
their three audio types, both packed formats in both directions, and the
loader's batches. Everything here is numpy (PIL, scipy, cv2 for the 'mel'
resize) on both sides, so every item, batch and index.json is held bit for
bit: same keys, same dtypes, same values.

The trees are the JAX tests' own (tests/test_data.py:22 and :67,
tests/test_packed_av.py:17), written again here at the same sizes, plus
a Hollywood2 and a UCF tree and an AV tree with all-zero maps. The zero-map
resample draws from numpy's global RNG on both sides; it is seeded the
same before each side's item.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from diff_sal_tpu.data import av_dataset as jav
from diff_sal_tpu.data import loader as jloader
from diff_sal_tpu.data import packed as jpacked
from diff_sal_tpu.data import synthetic as jsyn
from diff_sal_tpu.data import video_datasets as jvid
from diff_sal_tpu_torch.data import av_dataset as pav
from diff_sal_tpu_torch.data import loader as ploader
from diff_sal_tpu_torch.data import packed as ppacked
from diff_sal_tpu_torch.data import synthetic as psyn
from diff_sal_tpu_torch.data import video_datasets as pvid


def assert_same(a, b, what=""):
    """Bitwise equality of items or batches: keys, dtypes, values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (what, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (what, type(b))
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def _png(path, arr):
    Image.fromarray(arr).save(path)


# -- trees -------------------------------------------------------------------


@pytest.fixture(scope="module")
def dhf1k_root(tmp_path_factory):
    """tests/test_data.py:22's tree (one 40-frame video at 48x64), with two
    more videos so that the train split's windows span videos."""
    root = tmp_path_factory.mktemp("dhf1k")
    rng = np.random.RandomState(0)
    for vid, n in (("1", 40), ("2", 34), ("10", 50)):
        (root / "frames" / vid).mkdir(parents=True)
        (root / "maps" / vid).mkdir(parents=True)
        for i in range(1, n + 1):
            _png(root / "frames" / vid / f"{i}.png", rng.randint(0, 255, (48, 64, 3), np.uint8))
            _png(root / "maps" / vid / ("%04d.png" % i), rng.randint(0, 255, (48, 64), np.uint8))
    return root


def _av_video(root, rng, vid, n, sr, seconds, zero_maps=()):
    (root / "video" / vid).mkdir(parents=True)
    (root / "ann" / vid / "maps").mkdir(parents=True)
    (root / "audio" / vid).mkdir(parents=True)
    for i in range(1, n + 1):
        Image.fromarray(rng.randint(0, 255, (36, 64, 3), dtype=np.uint8)).save(
            root / "video" / vid / ("img_%05d.jpg" % i))
        m = rng.randint(1, 255, (36, 64), dtype=np.uint8)
        if i in zero_maps:
            m[:] = 0
        Image.fromarray(m).save(root / "ann" / vid / "maps" / ("eyeMap_%05d.jpg" % i))
    from scipy.io import wavfile

    wave = (rng.randn(int(sr * seconds)) * 3000).astype(np.int16)
    wavfile.write(root / "audio" / vid / f"{vid}.wav", sr, wave)


@pytest.fixture(scope="module")
def av_root(tmp_path_factory):
    """tests/test_data.py:67's tree: one 40-frame video, 2 s of 22050 Hz
    int16 audio, a 20 fps fold list."""
    root = tmp_path_factory.mktemp("avad")
    _av_video(root, np.random.RandomState(1), "v001", 40, 22050, 2)
    with open(root / "fold.txt", "w") as f:
        f.write("v001 40 20.0\n")
    return root


@pytest.fixture(scope="module")
def av_tree(tmp_path_factory):
    """tests/test_packed_av.py:17's corpus ('avad', v001 40 frames train,
    v002 30 frames test) plus a second dataset ('diem') whose video has
    all-zero maps at frames 30-45 and whose fold list names a video that
    has no files."""
    root = tmp_path_factory.mktemp("packed_av_src")
    rng = np.random.RandomState(7)
    for vid, n in (("v001", 40), ("v002", 30)):
        _av_video(root, rng, vid, n, 22050, n / 20.0 + 1)
    _av_video(root, rng, "z001", 60, 16000, 4, zero_maps=range(30, 46))
    with open(root / "fold_train.txt", "w") as f:
        f.write("v001 40 20.0\n")
    with open(root / "fold_test.txt", "w") as f:
        f.write("v002 30 20.0\n")
    with open(root / "fold_diem_train.txt", "w") as f:
        f.write("z001 60 25.0\nmissing 10 25.0\n")
    with open(root / "fold_diem_test.txt", "w") as f:
        f.write("z001 60 25.0\n")
    config = {"split1": {}}
    for name in ("avad", "diem"):
        config[f"video_path_{name}"] = str(root / "video")
        config[f"salmap_path_{name}"] = str(root / "ann")
        config[f"audio_path_{name}"] = str(root / "audio")
    config["split1"].update({
        "annotation_path_avad_train": str(root / "fold_train.txt"),
        "annotation_path_avad_test": str(root / "fold_test.txt"),
        "annotation_path_diem_train": str(root / "fold_diem_train.txt"),
        "annotation_path_diem_test": str(root / "fold_diem_test.txt")})
    return root, config


# -- synthetic ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 9])
def test_synthetic_items_equal_jax(seed):
    for kw in ({}, {"img_size": (16, 24), "frames": 4}):
        for cls in ("SyntheticVisualDataset", "SyntheticAVDataset"):
            p = getattr(psyn, cls)(n=3, seed=seed, **kw)
            j = getattr(jsyn, cls)(n=3, seed=seed, **kw)
            assert len(p) == len(j) == 3
            for i in range(3):
                assert_same(p[i], j[i], f"{cls}[{i}]")


# -- visual datasets --------------------------------------------------------


def test_visual_helpers_equal_jax(dhf1k_root):
    for n in range(1, 20):
        assert pvid.center_slice(list(range(n)), 3) == jvid.center_slice(list(range(n)), 3)
    np.testing.assert_array_equal(pvid.IMAGENET_MEAN, jvid.IMAGENET_MEAN)
    np.testing.assert_array_equal(pvid.IMAGENET_STD, jvid.IMAGENET_STD)
    frame = str(dhf1k_root / "frames" / "1" / "3.png")
    gt = str(dhf1k_root / "maps" / "1" / "0003.png")
    for decode in ("pil", "cv2"):
        for hw in ((32, 48), (48, 64), (50, 70)):
            assert_same(pvid.load_rgb_frame(frame, hw, decode),
                        jvid.load_rgb_frame(frame, hw, decode))
            assert_same(pvid.load_gt_map(gt, hw, decode), jvid.load_gt_map(gt, hw, decode))


@pytest.mark.parametrize("len_snippet,decode", [(32, "pil"), (16, "cv2"), (8, "pil")])
def test_dhf1k_equals_jax(dhf1k_root, len_snippet, decode):
    p = pvid.DHF1KDataset(str(dhf1k_root), len_snippet, "train", (32, 48), decode=decode)
    j = jvid.DHF1KDataset(str(dhf1k_root), len_snippet, "train", (32, 48), decode=decode)
    assert p.windows == j.windows and len(p) > 2
    for i in (0, len(p) // 2, len(p) - 1):
        assert_same(p[i], j[i], f"window {i}")


@pytest.mark.parametrize("mode", ["val", "test"])
def test_dhf1k_item_path_equals_jax(dhf1k_root, mode):
    """val / test windows need 601+ videos on disk; as tests/test_data.py
    does, the windows are set by hand and the item path is compared."""
    items = []
    for mod in (pvid, jvid):
        ds = mod.DHF1KDataset.__new__(mod.DHF1KDataset)
        mod.VideoWindowDataset.__init__(ds, 32, mode, (32, 48), 1, 1)
        ds.img_path = os.path.join(str(dhf1k_root), "frames")
        ds.ann_path = os.path.join(str(dhf1k_root), "maps")
        ds.windows = [("1", 0), ("1", 8), ("10", 34)]
        items.append([ds[i] for i in range(3)])
    assert_same(items[0], items[1])


@pytest.fixture(scope="module")
def holly_ucf_root(tmp_path_factory):
    """Hollywood2 (frame_%04d.png, 0-based) and UCF ('<action>-<idx>' dirs,
    '<action>_<idx>_%03d.png', 1-based) trees, training and testing."""
    root = tmp_path_factory.mktemp("holly_ucf")
    rng = np.random.RandomState(4)
    for kind, sub, vid, n in (("holly", "training", "actioncliptrain00001", 40),
                              ("holly", "testing", "actioncliptest00001", 20),
                              ("holly", "testing", "actioncliptest00002", 12),
                              ("ucf", "training", "Diving-Side-001", 36),
                              ("ucf", "testing", "Run-Side-002", 21)):
        base = root / kind / sub / vid
        (base / "images").mkdir(parents=True)
        (base / "maps").mkdir(parents=True)
        for i in range(n):
            if kind == "holly":
                name = "frame_%04d.png" % i
            else:
                idx = vid.split("-")[-1]
                name = "{}_{}_{:03d}.png".format(vid[: -(len(idx) + 1)], idx, i + 1)
            _png(base / "images" / name, rng.randint(0, 255, (24, 32, 3), np.uint8))
            _png(base / "maps" / name, rng.randint(1, 255, (24, 32), np.uint8))
    return root


@pytest.mark.parametrize("cls,mode,len_snippet", [
    ("HollywoodDataset", "train", 16), ("HollywoodDataset", "val", 16),
    ("HollywoodDataset", "test", 8), ("UCFDataset", "train", 32), ("UCFDataset", "val", 16),
    ("UCFDataset", "test", 16)])
def test_hollywood_and_ucf_equal_jax(holly_ucf_root, cls, mode, len_snippet):
    kind = "holly" if cls == "HollywoodDataset" else "ucf"
    path = str(holly_ucf_root / kind)
    p = getattr(pvid, cls)(path, len_snippet, mode, img_size=(24, 32))
    j = getattr(jvid, cls)(path, len_snippet, mode, img_size=(24, 32))
    assert p.windows == j.windows and len(p) > 0
    for i in sorted({0, len(p) // 2, len(p) - 1}):
        assert_same(p[i], j[i], f"window {i}")


# -- AV datasets --------------------------------------------------------------


def test_av_helpers_equal_jax(av_root):
    assert pav.AV_DATASET_NAMES == jav.AV_DATASET_NAMES
    np.testing.assert_array_equal(pav.AV_MEAN, jav.AV_MEAN)
    np.testing.assert_array_equal(pav.AV_STD, jav.AV_STD)
    fold = str(av_root / "fold.txt")
    assert pav.read_fold_list(fold) == jav.read_fold_list(fold)
    for args in ((40, 20.0, 22050, 44100), (17, 29.97, 16000, 9000), (5, 25.0, 48000, 10)):
        for a, b in zip(pav.frame_sample_ranges(*args), jav.frame_sample_ranges(*args)):
            assert_same(a, b)
    for n in (1, 3, 15, 16, 17, 90):
        idx = list(range(7, 7 + n))
        for size in (6, 16):
            assert pav.temporal_center_crop(idx, size) == jav.temporal_center_crop(idx, size)
        assert pav.median_frame_index(idx) == jav.median_frame_index(idx)
    # ROUND_HALF_UP where banker's rounding would go down
    assert pav.median_frame_index([1, 2]) == jav.median_frame_index([1, 2]) == 2
    wav = str(av_root / "audio" / "v001" / "v001.wav")
    assert_same(pav.load_wav(wav), jav.load_wav(wav))


@pytest.mark.parametrize("audio_type,exhaustive", [("mel", False), ("spec", False),
                                                   ("ori", False), ("mel", True)])
def test_av_dataset_equals_jax(av_root, audio_type, exhaustive):
    args = (str(av_root / "video"), str(av_root / "fold.txt"), str(av_root / "ann"),
            str(av_root / "audio"))
    kw = dict(name="avad", img_size=(32, 48), audio_type=audio_type,
              exhaustive_sampling=exhaustive)
    p, j = pav.AVSaliencyDataset(*args, **kw), jav.AVSaliencyDataset(*args, **kw)
    assert len(p) == len(j) == (39 if exhaustive else 1)
    assert p.samples == j.samples
    for i in sorted({0, len(p) - 1}):
        assert_same(p[i], j[i], f"{audio_type}[{i}]")
    np.testing.assert_array_equal(p[0]["audio"].shape,
                                  {"mel": (9, 112, 192, 1), "spec": (257, 219, 1),
                                   "ori": (1, 35280, 1)}[audio_type])


def _host_pair(config, name, train, **kw):
    flag = "train" if train else "test"
    args = (config[f"video_path_{name}"], config["split1"][f"annotation_path_{name}_{flag}"],
            config[f"salmap_path_{name}"], config[f"audio_path_{name}"])
    kw = dict(name=name, img_size=(64, 96), audio_size=(32, 48), **kw)
    return pav.AVSaliencyDataset(*args, **kw), jav.AVSaliencyDataset(*args, **kw)


def test_av_zero_map_resample_equals_jax(av_tree):
    """diem/z001's maps 30-45 are all zero: the exhaustive windows whose
    median frame falls there resample an earlier window from numpy's
    global RNG."""
    _, config = av_tree
    p, j = _host_pair(config, "diem", True, exhaustive_sampling=True)
    assert len(p) == len(j) == 59
    zero = [i for i in range(len(p)) if 30 <= pav.median_frame_index(
        pav.temporal_center_crop(p.samples[i]["frame_indices"], 16)) <= 45]
    assert len(zero) == 16
    for i in zero[-3:] + [len(p) - 1]:
        np.random.seed(100 + i)
        a = p[i]
        np.random.seed(100 + i)
        assert_same(a, j[i], f"resampled item {i}")
        assert a["salmap"].max() > 0


def test_build_av_datasets_equals_jax(av_root):
    config = {"sample_size": [48, 32], "audio_size": [48, 32], "sample_duration": 16,
              "with_audio": True, "audio_type": "mel", "split1": {}}
    for name in jav.AV_DATASET_NAMES:
        config[f"video_path_{name}"] = str(av_root / "video")
        config[f"salmap_path_{name}"] = str(av_root / "ann")
        config[f"audio_path_{name}"] = str(av_root / "audio")
        config["split1"][f"annotation_path_{name}_train"] = str(av_root / "fold.txt")
        config["split1"][f"annotation_path_{name}_test"] = str(av_root / "fold.txt")
    for train, exhaustive in ((True, False), (False, True)):
        p = pav.build_av_datasets(config, "split1", train, exhaustive)
        j = jav.build_av_datasets(config, "split1", train, exhaustive)
        assert len(p) == len(j) > 0
        np.testing.assert_array_equal(p.offsets, j.offsets)
        for i in sorted({0, len(p) // 2, len(p) - 1}):
            assert_same(p[i], j[i], f"concat[{i}]")


# -- packed trees, both directions ---------------------------------------------


def _index(root):
    with open(os.path.join(root, "index.json")) as f:
        return json.load(f)


def _assert_trees_equal(a, b):
    assert _index(a) == _index(b)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        if n.endswith(".npy"):
            assert_same(np.load(os.path.join(a, n)), np.load(os.path.join(b, n)), n)


@pytest.mark.parametrize("decode", ["pil", "cv2"])
def test_pack_dhf1k_both_directions(dhf1k_root, tmp_path, decode):
    kw = dict(img_size=(32, 48), decode=decode)
    pp = ppacked.pack_dhf1k_tree(str(dhf1k_root), str(tmp_path / "p"), **kw)
    jp = jpacked.pack_dhf1k_tree(str(dhf1k_root), str(tmp_path / "j"), **kw)
    _assert_trees_equal(pp, jp)
    for mode in ("train", "val", "test"):
        # the port reads JAX's tree, and JAX reads the port's
        a = ppacked.PackedVideoDataset(jp, len_snippet=16, mode=mode)
        b = jpacked.PackedVideoDataset(pp, len_snippet=16, mode=mode)
        assert a.windows == b.windows and len(a) > 0
        for i in sorted({0, len(a) // 2, len(a) - 1}):
            assert_same(a[i], b[i], f"{mode}[{i}]")


@pytest.mark.parametrize("decode", ["pil", "cv2"])
def test_pack_av_both_directions(av_tree, tmp_path, decode):
    _, config = av_tree
    kw = dict(img_size=(64, 96), datasets=["avad", "diem"], decode=decode)
    pp = ppacked.pack_av_tree(config, str(tmp_path / "p"), **kw)
    jp = jpacked.pack_av_tree(config, str(tmp_path / "j"), **kw)
    _assert_trees_equal(pp, jp)
    assert set(_index(pp)["videos"]) == {"avad__v001", "avad__v002", "diem__z001"}
    for train, exhaustive in ((True, False), (False, False), (False, True)):
        dkw = dict(datasets=["avad", "diem"], exhaustive_sampling=exhaustive)
        a = ppacked.PackedAVDataset(jp, config, "split1", train, **dkw)
        b = jpacked.PackedAVDataset(pp, config, "split1", train, **dkw)
        assert a.samples == b.samples and len(a) > 0
        for i in sorted({0, len(a) // 2, len(a) - 1}):
            np.random.seed(i)
            x = a[i]
            np.random.seed(i)
            assert_same(x, b[i], f"train={train} exhaustive={exhaustive} [{i}]")
            assert x["wave"].shape == (25600,) and x["rgb"].dtype == np.uint8


def test_packed_av_zero_map_resample_equals_jax(av_tree, tmp_path):
    """The packed twin of the zero-map resample (packed.py:391-394): the
    same draws from numpy's global RNG, and the same item."""
    _, config = av_tree
    root = jpacked.pack_av_tree(config, str(tmp_path / "j"), img_size=(64, 96),
                                datasets=["diem"], decode="pil")
    kw = dict(datasets=["diem"], exhaustive_sampling=True)
    a = ppacked.PackedAVDataset(root, config, "split1", True, **kw)
    b = jpacked.PackedAVDataset(root, config, "split1", True, **kw)
    zero = [i for i in range(len(a)) if 30 <= pav.median_frame_index(
        pav.temporal_center_crop(a.samples[i][1], 16)) <= 45]
    assert len(zero) == 16
    for i in zero[-4:]:
        np.random.seed(i)
        x = a[i]
        state = np.random.get_state()[1].copy()
        np.random.seed(i)
        assert_same(x, b[i], f"resampled item {i}")
        np.testing.assert_array_equal(state, np.random.get_state()[1])
        assert x["salmap"].max() > 0


# -- the loader --------------------------------------------------------------------


def test_collate_equals_jax():
    items = [{"x": np.ones((2, 2)), "i": 3, "f": 0.5, "n": np.int64(4), "s": "a"},
             {"x": np.zeros((2, 2)), "i": 4, "f": 1.5, "n": np.int64(5), "s": "b"}]
    assert_same(ploader.collate(items), jloader.collate(items))


@pytest.mark.parametrize("n,bs,kw", [
    (20, 4, dict(shuffle=True, seed=1, process_index=0, process_count=2)),
    (20, 4, dict(shuffle=True, seed=1, process_index=1, process_count=2)),
    (21, 4, dict(shuffle=True, seed=3, process_index=2, process_count=3, drop_last=False)),
    (5, 4, dict(drop_last=False, pad_last=True)),
    (5, 2, dict(shuffle=True, drop_last=False, pad_last=True, seed=7)),
    (16, 4, dict(shuffle=True, seed=0)),
])
@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_equal_jax(n, bs, kw, workers):
    """Per-epoch order, sharding, drop_last / pad_last and the "valid" mask,
    epoch by epoch, through the thread pool or without it."""
    ds = psyn.SyntheticVisualDataset(n=n, img_size=(8, 12), frames=2)
    p = ploader.Loader(ds, bs, num_workers=workers, **kw)
    j = jloader.Loader(ds, bs, num_workers=workers, **kw)
    for epoch in (0, 1, 5):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        assert len(p) == len(j)
        np.testing.assert_array_equal(p._epoch_indices(), j._epoch_indices())
        bp, bj = list(p), list(j)
        assert len(bp) == len(bj) == len(p)
        for a, b in zip(bp, bj):
            assert_same(a, b, f"epoch {epoch}")


def test_loader_stops_its_producer_early():
    """A consumer that stops after one batch leaves no thread running."""
    import threading

    ds = psyn.SyntheticVisualDataset(n=40, img_size=(8, 12), frames=2)
    before = threading.active_count()
    it = iter(ploader.Loader(ds, 2, num_workers=2, prefetch=1))
    next(it)
    it.close()
    for t in threading.enumerate():
        if t is not threading.current_thread() and t.daemon:
            t.join(timeout=10)
    assert threading.active_count() <= before


def test_port_imports_and_reads_packed_trees_without_pil_and_cv2(av_tree, tmp_path):
    """The card's machine has neither PIL nor cv2: every module of the port
    imports without them, and a packed AV tree is read and batched."""
    import subprocess
    import sys

    _, config = av_tree
    root = jpacked.pack_av_tree(config, str(tmp_path / "packed"), img_size=(64, 96),
                                datasets=["avad"], decode="pil")
    code = f"""
import sys, importlib, pkgutil
sys.modules["PIL"] = None
sys.modules["cv2"] = None
import diff_sal_tpu_torch
for m in pkgutil.walk_packages(diff_sal_tpu_torch.__path__, "diff_sal_tpu_torch."):
    importlib.import_module(m.name)
import diff_sal_tpu_torch.train.trainer
from diff_sal_tpu_torch.data.loader import Loader
from diff_sal_tpu_torch.data.packed import PackedAVDataset
ds = PackedAVDataset({root!r}, {config!r}, "split1", True, datasets=["avad"])
batch = next(iter(Loader(ds, 1, num_workers=2)))
assert batch["rgb"].dtype.name == "uint8" and batch["wave"].shape == (1, 25600)
try:
    import PIL
except ImportError:
    print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_raises_an_items_error(workers):
    """An item that raises stops the epoch with its error (the JAX
    package's threaded loader ends the epoch early without one)."""

    class Broken(psyn.SyntheticVisualDataset):
        def __getitem__(self, idx):
            if idx == 5:
                raise KeyError("item 5")
            return super().__getitem__(idx)

    loader = ploader.Loader(Broken(n=8, img_size=(8, 12), frames=2), 2, num_workers=workers)
    got = []
    with pytest.raises(KeyError, match="item 5"):
        for batch in loader:
            got.append(batch["video_id"])
    assert got == [["0", "1"], ["2", "3"]]
