"""In-memory synthetic datasets with the real items' contract (JAX package
`data/synthetic.py`): for tests, benchmarks and overfit runs without data
on disk. The same seed and index give the same item as the JAX
package's. `write_packed_dhf1k_tree` and `write_packed_av_tree` write
synthetic trees on disk in `data/packed.PackedVideoDataset`'s and
`PackedAVDataset`'s layouts, with numpy alone."""

from __future__ import annotations

import json
import os
from typing import Mapping, Sequence, Tuple

import numpy as np


class SyntheticVisualDataset:
    """Items like DHF1KDataset: gaussian-blob saliency maps tied to frame
    content so a model can actually learn the mapping."""

    def __init__(self, n: int = 32, img_size: Tuple[int, int] = (224, 384),
                 frames: int = 16, seed: int = 0, with_audio: bool = False):
        self.n = n
        self.img_size = img_size
        self.frames = frames
        self.seed = seed
        self.with_audio = with_audio

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        h, w = self.img_size
        rng = np.random.RandomState(self.seed * 100003 + idx)
        cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(w // 4, 3 * w // 4)
        yy, xx = np.mgrid[0:h, 0:w]
        blob = np.exp(-(((yy - cy) / (h / 8)) ** 2 + ((xx - cx) / (w / 8)) ** 2))
        rgb = np.broadcast_to(
            blob[None, :, :, None], (self.frames, h, w, 3)
        ).astype(np.float32) + rng.randn(self.frames, h, w, 3).astype(np.float32) * 0.05
        item = {
            "rgb": rgb.astype(np.float32),
            "salmap": blob[..., None].astype(np.float32),
            "video_id": str(idx),
            "gt_index": idx,
        }
        if self.with_audio:
            item["audio"] = rng.randn(9, 112, 192, 1).astype(np.float32)
        return item


class SyntheticAVDataset(SyntheticVisualDataset):
    def __init__(self, *args, **kw):
        super().__init__(*args, with_audio=True, **kw)


def write_packed_dhf1k_tree(root: str, hw: Tuple[int, int], videos: Mapping[str, int],
                            seed: int = 0) -> str:
    """A packed DHF1k tree written with numpy alone, in
    `PackedVideoDataset`'s layout (`data/packed.py`): for each (numeric)
    video id and frame count, uint8 frames at `hw` and uint8 maps in
    1..255, and index.json. Returns `root`."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    index = {"videos": {}, "img_size": list(hw)}
    for vid, n in videos.items():
        np.save(os.path.join(root, f"{vid}_frames.npy"),
                rng.randint(0, 256, (n, *hw, 3), dtype=np.uint8))
        np.save(os.path.join(root, f"{vid}_maps.npy"),
                rng.randint(1, 256, (n, *hw), dtype=np.uint8))
        index["videos"][str(vid)] = n
    with open(os.path.join(root, "index.json"), "w") as f:
        json.dump(index, f)
    return root


def write_packed_av_tree(root: str, hw: Tuple[int, int],
                         folds: Mapping[str, Sequence[Tuple[str, int]]], fps: float,
                         seed: int = 0) -> dict:
    """A packed AV tree written with numpy alone, in `PackedAVDataset`'s
    layout: split1's "train" and "test" folds of (video, frames) pairs,
    uint8 frames at `hw`, uint8 maps in 1..255 (no zero map) and 16 kHz
    float32 waves one second longer than each video, all under "avad".
    Every AV dataset name lists the same fold files; only "avad"'s videos
    are packed, so the others add no window. Returns the dataset.json-style
    config."""
    from diff_sal_tpu_torch.data.av_dataset import AV_DATASET_NAMES

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    index = {"img_size": list(hw), "sr": 16000, "with_audio": True, "videos": {}}
    config = {"split1": {}}
    for kind in ("video", "salmap", "audio"):
        for name in AV_DATASET_NAMES:
            config[f"{kind}_path_{name}"] = str(root)
    for flag, videos in folds.items():
        fold = os.path.join(root, f"fold_{flag}.txt")
        with open(fold, "w") as f:
            for vid, n in videos:
                f.write(f"{vid} {n} {fps}\n")
                key = f"avad__{vid}"
                np.save(os.path.join(root, f"{key}_frames.npy"),
                        rng.randint(0, 256, (n, *hw, 3), dtype=np.uint8))
                np.save(os.path.join(root, f"{key}_maps.npy"),
                        rng.randint(1, 256, (n, *hw), dtype=np.uint8))
                wave_len = int(16000 * (n / fps + 1))
                np.save(os.path.join(root, f"{key}_wave.npy"),
                        (rng.randn(wave_len) * 0.1).astype(np.float32))
                index["videos"][key] = {"dataset": "avad", "video": vid, "n": n,
                                        "n_frames": n, "fps": fps, "wave_len": wave_len}
        for name in AV_DATASET_NAMES:
            config["split1"][f"annotation_path_{name}_{flag}"] = fold
    with open(os.path.join(root, "index.json"), "w") as f:
        json.dump(index, f)
    return config
