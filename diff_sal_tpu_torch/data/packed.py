"""Packed uint8 dataset format: a decode-free input pipeline (JAX package
`data/packed.py`, same on-disk layout: a tree packed by either package is
read by the other).

The reference re-decodes every PNG frame on every epoch (PIL in its
loader's workers, datasets/dhf1k_data.py), ~250 ms of CPU per 16-frame
clip. A one-time packing pass stores each video as a uint8 memmap at the
training resolution; items become memmap slices (~2 ms a clip) and the
normalization runs on the device (`data/transforms.normalize_rgb_u8`,
called by the model's `encode_visual` when it sees uint8).

DHF1k layout under <root>/:
    <vid>_frames.npy   (N, H, W, 3) uint8   raw RGB at img_size
    <vid>_maps.npy     (N, H, W)    uint8   saliency maps
    index.json         {"videos": {vid: n_frames}, "img_size": [H, W]}

AV layout under <root>/ (the 6-dataset corpus):
    <ds>__<vid>_frames.npy  (N, H, W, 3) uint8, the reference's two-stage
                            resize (decode -> 320x240 -> img_size) baked in;
                            STAViS normalization on the device
    <ds>__<vid>_maps.npy    (N, H, W) uint8 eyeMaps
    <ds>__<vid>_wave.npy    (L,) float32, resampled to 16 kHz once
    index.json              {"img_size": [H, W], "sr": 16000,
                             "with_audio": bool, "videos": {"<ds>__<vid>":
                             {"dataset", "video", "n", "n_frames", "fps",
                             "wave_len"}}}

AV items ship a PACKED_WAVE_LEN = 25600-sample padded excerpt ("wave") and
the log-mel frontend runs inside the training and evaluation steps
(`train/train_step.resolve_audio`). Packing is split-independent: every
video named in any fold list is packed once; PackedAVDataset rebuilds the
windows per (split, train) from the fold lists. The reference pads the
excerpt at the file's rate and resamples inside its frontend
(saliency_db.py:477-487); resample-then-pad differs from pad-then-resample
only in the anti-alias filter's tails at the excerpt's ends. Only
audio_type 'mel' is packed.

Packing decodes with cv2 (default) or PIL, each imported where it is used;
reading a packed tree needs neither.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from diff_sal_tpu_torch.audio.mel import PACKED_WAVE_LEN, SAMPLE_RATE, center_pad_excerpt
from diff_sal_tpu_torch.data.av_dataset import (AV_DATASET_NAMES, frame_sample_ranges,
                                                load_wav, median_frame_index, read_fold_list,
                                                temporal_center_crop)
from diff_sal_tpu_torch.data.video_datasets import VideoWindowDataset, center_slice


def _decoder(img_size: Tuple[int, int], decode: str, two_stage: bool):
    """frame loader: path, gray -> uint8 (H, W[, 3]) at img_size; with
    `two_stage` colour frames go through 320x240 first (the AV corpus)."""

    def load(path, gray=False):
        if decode == "cv2":
            import cv2

            arr = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
            if arr is None:  # cv2 returns None instead of raising
                raise FileNotFoundError(path)
            if two_stage and not gray:
                arr = cv2.resize(arr, (320, 240), interpolation=cv2.INTER_LINEAR)
            arr = cv2.resize(arr, (img_size[1], img_size[0]), interpolation=cv2.INTER_LINEAR)
            return arr if gray else arr[:, :, ::-1]
        from PIL import Image

        img = Image.open(path).convert("L" if gray else "RGB")
        if two_stage and not gray:
            img = img.resize((320, 240))
        return np.asarray(img.resize((img_size[1], img_size[0]), Image.BILINEAR))

    return load


def _open(path: str, shape, dtype=np.uint8):
    return np.lib.format.open_memmap(path, mode="w+", dtype=dtype, shape=shape)


def pack_dhf1k_tree(src_root: str, dst_root: str, img_size: Tuple[int, int] = (224, 384),
                    videos: Optional[List[str]] = None, decode: str = "cv2") -> str:
    """One-time pack of a DHF1k-layout tree (frames/<vid>/<i>.png +
    maps/<vid>/%04d.png) into uint8 memmaps at img_size."""
    os.makedirs(dst_root, exist_ok=True)
    frames_root = os.path.join(src_root, "frames")
    vids = videos or sorted(os.listdir(frames_root), key=int)
    index = {"videos": {}, "img_size": list(img_size)}
    load = _decoder(img_size, decode, two_stage=False)
    for vid in vids:
        fdir = os.path.join(frames_root, vid)
        mdir = os.path.join(src_root, "maps", vid)
        n = len(os.listdir(fdir))
        fr = _open(os.path.join(dst_root, f"{vid}_frames.npy"), (n, *img_size, 3))
        mp = _open(os.path.join(dst_root, f"{vid}_maps.npy"), (n, *img_size))
        for i in range(1, n + 1):
            fr[i - 1] = load(os.path.join(fdir, f"{i}.png"))
            map_path = os.path.join(mdir, "%04d.png" % i)
            if os.path.exists(map_path):
                mp[i - 1] = load(map_path, gray=True)
        fr.flush()
        mp.flush()
        index["videos"][vid] = n
    with open(os.path.join(dst_root, "index.json"), "w") as f:
        json.dump(index, f)
    return dst_root


class PackedVideoDataset(VideoWindowDataset):
    """Windows over a packed DHF1k tree; DHF1KDataset's items except that
    "rgb" is uint8 (H, W fixed at pack time), normalized on the device."""

    def __init__(self, packed_root: str, len_snippet: int = 32, mode: str = "train",
                 gt_length: int = 1, alternate: int = 1, videos: Optional[List[str]] = None):
        with open(os.path.join(packed_root, "index.json")) as f:
            index = json.load(f)
        super().__init__(len_snippet, mode, tuple(index["img_size"]), gt_length, alternate)
        self.root = packed_root
        self._frames = {}
        self._maps = {}
        for v in videos or sorted(index["videos"], key=int):
            n = index["videos"][v]
            stride = {"train": self.skip_window, "val": self.gt_length}.get(mode, 1)
            for i in range(0, n - alternate * len_snippet, stride):
                self.windows.append((v, i))
            if mode == "test":
                self.windows.append((v, n - len_snippet))

    def _mmap(self, cache, vid, kind):
        if vid not in cache:
            cache[vid] = np.load(os.path.join(self.root, f"{vid}_{kind}.npy"), mmap_mode="r")
        return cache[vid]

    def __getitem__(self, idx: int):
        v, start = self.windows[idx]
        fr = self._mmap(self._frames, v, "frames")
        indices = [start + self.alternate * i for i in range(self.frame_lens)]
        gt_idx = center_slice(indices, self.gt_length)[0]
        item = {"rgb": np.ascontiguousarray(fr[indices]),  # (16, H, W, 3) uint8
                "video_id": v, "gt_index": gt_idx + 1}
        if self.mode != "test":
            mp = self._mmap(self._maps, v, "maps")
            item["salmap"] = (np.asarray(mp[gt_idx], np.float32) / 255.0)[..., None]
        return item


def pack_av_tree(data_config: dict, dst_root: str, img_size: Tuple[int, int] = (224, 384),
                 datasets: Optional[List[str]] = None, decode: str = "cv2") -> str:
    """One-time pack of the 6-dataset AV corpus (cfgs/dataset.json schema)
    into uint8 / float32 memmaps: the union of the videos over every fold
    list of every split."""
    os.makedirs(dst_root, exist_ok=True)
    names = list(datasets) if datasets else list(AV_DATASET_NAMES)
    with_audio = bool(data_config.get("with_audio", True))
    index = {"img_size": list(img_size), "sr": SAMPLE_RATE, "with_audio": with_audio,
             "videos": {}}
    load = _decoder(img_size, decode, two_stage=True)
    for name in names:
        video_root = data_config[f"video_path_{name}"]
        salmap_root = data_config[f"salmap_path_{name}"]
        audio_root = data_config[f"audio_path_{name}"]
        seen = {}
        for split, folds in data_config.items():
            if not (isinstance(folds, dict) and split.startswith("split")):
                continue
            for key in (f"annotation_path_{name}_train", f"annotation_path_{name}_test"):
                if key in folds:
                    for vid, n_frames, fps in read_fold_list(folds[key]):
                        seen.setdefault(vid, (n_frames, fps))
        for vid, (n_frames, fps) in sorted(seen.items()):
            vdir = os.path.join(video_root, vid)
            mdir = os.path.join(salmap_root, vid, "maps")
            wav_path = os.path.join(audio_root, vid, vid + ".wav")
            if not (os.path.isdir(vdir) and os.path.isdir(mdir)):
                continue
            if with_audio and not os.path.exists(wav_path):
                continue
            key = f"{name}__{vid}"
            # frames present on disk may stop short of the fold list's count
            n = 0
            while os.path.exists(os.path.join(vdir, "img_{:05d}.jpg".format(n + 1))):
                n += 1
            if n == 0:
                continue
            fr = _open(os.path.join(dst_root, f"{key}_frames.npy"), (n, *img_size, 3))
            mp = _open(os.path.join(dst_root, f"{key}_maps.npy"), (n, *img_size))
            for i in range(1, n + 1):
                fr[i - 1] = load(os.path.join(vdir, "img_{:05d}.jpg".format(i)))
                map_path = os.path.join(mdir, "eyeMap_{:05d}.jpg".format(i))
                if os.path.exists(map_path):
                    mp[i - 1] = load(map_path, gray=True)
            fr.flush()
            mp.flush()
            entry = {"dataset": name, "video": vid, "n": n, "n_frames": int(n_frames),
                     "fps": float(fps)}
            if with_audio:
                wave, sr = load_wav(wav_path)
                if sr != SAMPLE_RATE:
                    from scipy.signal import resample_poly

                    g = int(np.gcd(int(sr), SAMPLE_RATE))
                    wave = resample_poly(wave, SAMPLE_RATE // g, int(sr) // g)
                np.save(os.path.join(dst_root, f"{key}_wave.npy"), np.asarray(wave, np.float32))
                entry["wave_len"] = int(len(wave))
            index["videos"][key] = entry
    with open(os.path.join(dst_root, "index.json"), "w") as f:
        json.dump(index, f)
    return dst_root


class PackedAVDataset:
    """Windows over a packed AV tree: AVSaliencyDataset's windows and
    metadata (audio_type 'mel'), with memmap slices for items: "rgb" uint8
    (STAViS normalization on the device: the model's uint8_norm='stavis')
    and "wave", a (25600,) float32 16 kHz excerpt whose log-mel runs in
    the step."""

    def __init__(self, packed_root: str, data_config: dict, split: str, train: bool, *,
                 exhaustive_sampling: bool = False, sample_duration: int = 16,
                 step_duration: int = 90, resample_zero_gt: bool = True,
                 datasets: Optional[List[str]] = None):
        with open(os.path.join(packed_root, "index.json")) as f:
            self.index = json.load(f)
        assert self.index["sr"] == SAMPLE_RATE, self.index["sr"]
        self.root = packed_root
        self.img_size = tuple(self.index["img_size"])
        self.with_audio = bool(self.index.get("with_audio", True))
        self.sample_duration = sample_duration
        self.resample_zero_gt = resample_zero_gt
        if exhaustive_sampling:
            step, step_duration = 1, sample_duration
        else:
            step = max(1, step_duration - sample_duration)

        flag = "train" if train else "test"
        self.samples = []
        self.ranges = {}
        self._mm = {}
        for name in (datasets or AV_DATASET_NAMES):
            fold = data_config[split][f"annotation_path_{name}_{flag}"]
            for vid, n_frames, fps in read_fold_list(fold):
                key = f"{name}__{vid}"
                meta = self.index["videos"].get(key)
                if meta is None or n_frames <= 1:
                    continue
                if self.with_audio:
                    self.ranges[key] = frame_sample_ranges(n_frames, fps, SAMPLE_RATE,
                                                           meta["wave_len"])
                for j in range(1, n_frames, step):
                    self.samples.append((key, list(range(j, min(n_frames + 1, j + step_duration)))))

    def __len__(self):
        return len(self.samples)

    def _load(self, key: str, kind: str):
        ck = (key, kind)
        if ck not in self._mm:
            self._mm[ck] = np.load(os.path.join(self.root, f"{key}_{kind}.npy"), mmap_mode="r")
        return self._mm[ck]

    def __getitem__(self, index: int):
        key, frame_indices = self.samples[index]
        meta = self.index["videos"][key]
        indices = temporal_center_crop(frame_indices, self.sample_duration)
        med = median_frame_index(indices)
        n = meta["n"]

        mp = self._load(key, "maps")
        salmap = (np.asarray(mp[min(med, n) - 1], np.float32) / 255.0)[..., None]
        if salmap.max() == 0 and self.resample_zero_gt:
            # reference quirk (saliency_db.py:390-392), guarded as in
            # AVSaliencyDataset
            return self.__getitem__(int(np.random.randint(0, max(index, 1))))

        fr = self._load(key, "frames")
        # fold lists can promise more frames than were packed: loop-pad with
        # the last packed frame (AVSaliencyDataset._load_rgb)
        rows = [min(i, n) - 1 for i in indices]
        item = {"rgb": np.ascontiguousarray(fr[rows]),  # (16, H, W, 3) uint8
                "salmap": salmap, "video_id": f"{meta['dataset']}/{meta['video']}",
                "gt_index": med, "dataset": meta["dataset"]}
        if self.with_audio:
            wave = self._load(key, "wave")
            starts, ends = self.ranges[key]
            lo, hi = starts[indices[0]], ends[indices[-1]]
            item["wave"] = center_pad_excerpt(np.asarray(wave[lo : hi + 1]),
                                              PACKED_WAVE_LEN).astype(np.float32)
        return item
