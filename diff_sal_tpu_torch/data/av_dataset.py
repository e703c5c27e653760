"""Audio-visual saliency datasets: DIEM, Coutrot1/2, SumMe, ETMD, AVAD
(JAX package `data/av_dataset.py`; reference `datasets/saliency_db.py`
with audio_type 'mel', and the loader factory
`datasets/prepare_data.py:44-151`):

* fold lists `name nframes fps` (read_sal_text, :80-88),
* 90-frame step windows center-cropped to 16 frames for training;
  exhaustive step-1 16-frame windows for test (:269-275),
* frames `img_%05d.jpg` decoded, pre-resized to 320x240, scaled to
  (224, 384), normalized with the STAViS mean / std in 0-255 space
  (dataset.json:74-77),
* GT `maps/eyeMap_%05d.jpg` at the ROUND_HALF_UP median frame; an all-zero
  GT resamples a random earlier index from numpy's global RNG
  (:369-392, behind `resample_zero_gt`, the index <= 1 crash guarded),
* audio by `audio_type` (saliency_db.py:343-368; cfgs/dataset.json:81):
    'mel'  - the excerpt center-padded into 35280 samples, VGGish log-mel
             -> 9 examples -> (9, 112, 192, 1) (audio/mel.py),
    'spec' - standardized log-spectrogram, (257, 219, 1) channel-last,
    'ori'  - the raw excerpt front-padded / truncated, (1, 35280, 1).

Items are channel-last numpy:
  {"rgb": (16, 224, 384, 3), "salmap": (224, 384, 1), "audio": see above,
   "video_id": str, "gt_index": int, "dataset": str}

PIL is imported where frames are decoded, scipy where a WAV is read,
cv2 by the 'mel' audio's resize.
"""

from __future__ import annotations

import os
from decimal import ROUND_HALF_UP, Decimal, localcontext
from typing import Dict, List, Tuple

import numpy as np

from diff_sal_tpu_torch.audio.features import raw_feature, spec_feature
from diff_sal_tpu_torch.audio.mel import clip_audio_to_model_input

AV_DATASET_NAMES = ("diem", "coutrot1", "coutrot2", "summe", "etmd", "avad")
AV_MEAN = np.array([114.7748, 107.7354, 99.475], np.float32)
AV_STD = np.array([38.7568578, 37.88248729, 40.02898126], np.float32)


def read_fold_list(txt_file: str) -> List[Tuple[str, int, float]]:
    """Parse 'name nframes fps' lines (reference read_sal_text)."""
    out = []
    with open(txt_file) as f:
        for line in f:
            w = line.split()
            if len(w) >= 3:
                out.append((w[0], int(w[1]), float(w[2])))
    return out


def frame_sample_ranges(n_frames: int, fps: float, sr: int, n_samples_wav: int):
    """Per-video-frame [start, end] sample indices, centered on each frame
    (reference make_mel_dataset, saliency_db.py:205-221). Index 0 unused."""
    n_samples = sr / fps
    starts = np.zeros(n_frames + 1, dtype=int)
    ends = np.zeros(n_frames + 1, dtype=int)
    for k in range(1, n_frames + 1):
        center = (k - 1) * (1.0 / fps) * sr
        starts[k] = int(max(0, center - n_samples / 2))
        ends[k] = int(min(n_samples_wav, abs(center + n_samples / 2)))
    return starts, ends


def temporal_center_crop(frame_indices: List[int], size: int) -> List[int]:
    """STAViS TemporalCenterCrop with loop padding (reference
    temporal_transforms.py:21-55)."""
    c = len(frame_indices) // 2
    begin = max(0, c - size // 2)
    end = min(begin + size, len(frame_indices))
    out = list(frame_indices[begin:end])
    for i in out:
        if len(out) >= size:
            break
        out.append(i)
    return out


def median_frame_index(frame_indices: List[int]) -> int:
    """ROUND_HALF_UP median (reference saliency_db.py:369-372)."""
    with localcontext() as ctx:
        ctx.rounding = ROUND_HALF_UP
        return int(Decimal(float(np.median(frame_indices))).to_integral_value())


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """PCM WAV -> float64 mono in [-1, 1] and its rate (the reference reads
    it with soundfile; scipy here)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    data = np.asarray(data)
    if data.dtype == np.int16:
        data = data / 32768.0
    elif data.dtype == np.int32:
        data = data / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float64) - 128.0) / 128.0
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data.astype(np.float64), int(sr)


class AVSaliencyDataset:
    """One (dataset, split, train/test) fold of the 6-dataset AV corpus."""

    def __init__(self, video_root: str, fold_list_path: str, salmap_root: str,
                 audio_root: str, *, name: str = "av", with_audio: bool = True,
                 exhaustive_sampling: bool = False, sample_duration: int = 16,
                 step_duration: int = 90, img_size: Tuple[int, int] = (224, 384),
                 audio_size: Tuple[int, int] = (112, 192), resample_zero_gt: bool = True,
                 audio_type: str = "mel"):
        assert audio_type in ("mel", "spec", "ori"), audio_type
        self.name = name
        self.audio_type = audio_type
        self.with_audio = with_audio
        self.img_size = img_size
        self.audio_size = tuple(audio_size)
        self.sample_duration = sample_duration
        self.exhaustive = exhaustive_sampling
        self.resample_zero_gt = resample_zero_gt
        if exhaustive_sampling:
            step, step_duration = 1, sample_duration
        else:
            step = max(1, step_duration - sample_duration)

        self.samples = []
        self.audio: Dict[str, dict] = {}
        for vid, n_frames, fps in read_fold_list(fold_list_path):
            video_path = os.path.join(video_root, vid)
            maps_path = os.path.join(salmap_root, vid, "maps")
            wav_path = os.path.join(audio_root, vid, vid + ".wav")
            if not (os.path.exists(video_path) and os.path.exists(maps_path)):
                continue
            if n_frames <= 1:
                continue
            if with_audio and not os.path.exists(wav_path):
                continue
            if with_audio:
                wav, sr = load_wav(wav_path)
                starts, ends = frame_sample_ranges(n_frames, fps, sr, len(wav))
                self.audio[vid] = {"wav": wav, "sr": sr, "starts": starts, "ends": ends}
            for j in range(1, n_frames, step):
                self.samples.append(dict(
                    video=video_path, maps=maps_path, video_id=vid,
                    frame_indices=list(range(j, min(n_frames + 1, j + step_duration)))))

    def __len__(self):
        return len(self.samples)

    def _load_rgb(self, video_path: str, indices: List[int]) -> np.ndarray:
        from PIL import Image

        frames = []
        for i in indices:
            p = os.path.join(video_path, "img_{:05d}.jpg".format(i))
            if not os.path.exists(p):
                break
            img = Image.open(p).convert("RGB").resize((320, 240))
            img = img.resize((self.img_size[1], self.img_size[0]), Image.BILINEAR)
            arr = np.asarray(img, np.float32)  # 0-255, norm_value=1
            frames.append((arr - AV_MEAN) / AV_STD)
        while len(frames) < len(indices):  # truncated video: loop-pad
            frames.append(frames[-1])
        return np.stack(frames)

    def __getitem__(self, index: int):
        from PIL import Image

        s = self.samples[index]
        indices = temporal_center_crop(s["frame_indices"], self.sample_duration)
        med = median_frame_index(indices)

        gt = Image.open(os.path.join(s["maps"], "eyeMap_{:05d}.jpg".format(med))).convert("L")
        gt = gt.resize((self.img_size[1], self.img_size[0]), Image.BILINEAR)
        salmap = (np.asarray(gt, np.float32) / 255.0)[..., None]
        if salmap.max() == 0 and self.resample_zero_gt:
            # reference quirk (saliency_db.py:390-392), index <= 1 guarded
            return self.__getitem__(int(np.random.randint(0, max(index, 1))))

        item = {"rgb": self._load_rgb(s["video"], indices), "salmap": salmap,
                "video_id": f"{self.name}/{s['video_id']}", "gt_index": med,
                "dataset": self.name}
        if self.with_audio:
            a = self.audio[s["video_id"]]
            excerpt = a["wav"][a["starts"][indices[0]] : a["ends"][indices[-1]] + 1]
            if self.audio_type == "mel":
                item["audio"] = clip_audio_to_model_input(excerpt, a["sr"], hw=self.audio_size)
            elif self.audio_type == "spec":  # (1, 257, n) -> channel-last (257, n, 1)
                item["audio"] = np.moveaxis(spec_feature(excerpt, a["sr"]), 0, -1)
            else:  # "ori": (1, 1, 35280) -> channel-last (1, 35280, 1)
                item["audio"] = np.moveaxis(raw_feature(excerpt), 0, -1)
        return item


class ConcatDataset:
    """Indexable concatenation of datasets."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.datasets[d][idx - self.offsets[d]]


def build_av_datasets(data_config: dict, split: str, train: bool,
                      exhaustive: bool = False) -> ConcatDataset:
    """ConcatDataset over the 6 AV datasets for one split (reference
    prepare_data.py:87-151); `data_config` follows cfgs/dataset.json."""
    flag = "train" if train else "test"
    size = data_config.get("sample_size", [384, 224])
    audio_size = data_config.get("audio_size", [192, 112])
    return ConcatDataset([
        AVSaliencyDataset(
            data_config[f"video_path_{name}"],
            data_config[split][f"annotation_path_{name}_{flag}"],
            data_config[f"salmap_path_{name}"],
            data_config[f"audio_path_{name}"],
            name=name,
            with_audio=data_config.get("with_audio", True),
            exhaustive_sampling=exhaustive,
            sample_duration=data_config.get("sample_duration", 16),
            img_size=(size[1], size[0]),
            audio_size=(audio_size[1], audio_size[0]),
            audio_type=data_config.get("audio_type", "mel"),
        )
        for name in AV_DATASET_NAMES])
