"""Visual-only video saliency datasets: DHF1K, Hollywood2, UCF-Sports
(JAX package `data/video_datasets.py`; reference `datasets/dhf1k_data.py`,
`holly2wood_dataset.py`, `ucf_dataset.py` + `meta_data.py`), producing
channel-last numpy items:

  {"rgb": (16, H, W, 3) float32 ImageNet-normalized,
   "salmap": (H, W, 1) float32 in [0, 1],
   "video_id": str, "gt_index": int}

Windows as in the reference, including the 32 -> 16 truncation for
len_snippet > 16 and the skip_window=16 training stride
(meta_data.py:36-41, dhf1k_data.py:33-56). PIL and cv2 are imported only
where a frame is decoded.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_rgb_frame(path: str, img_size: Tuple[int, int], decode: str = "pil") -> np.ndarray:
    """Load + bilinear resize + ImageNet normalize -> (H, W, 3) f32.

    decode='pil' matches the reference bit for bit (torchvision transforms
    wrap PIL, meta_data.py:27-31); decode='cv2' is ~2-3x faster per frame
    with sub-1% pixel deltas from its other bilinear edge handling."""
    if decode == "cv2":
        import cv2

        arr = cv2.imread(path, cv2.IMREAD_COLOR)  # BGR uint8
        if arr is None:  # cv2 returns None instead of raising
            raise FileNotFoundError(path)
        arr = cv2.resize(arr, (img_size[1], img_size[0]), interpolation=cv2.INTER_LINEAR)
        arr = arr[:, :, ::-1].astype(np.float32) / 255.0
        return (arr - IMAGENET_MEAN) / IMAGENET_STD
    from PIL import Image

    img = Image.open(path).convert("RGB")
    img = img.resize((img_size[1], img_size[0]), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def load_gt_map(path: str, img_size: Tuple[int, int], decode: str = "pil") -> np.ndarray:
    """Load grayscale + bilinear resize -> (H, W, 1) f32 in [0, 1]."""
    if decode == "cv2":
        import cv2

        arr = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if arr is None:
            raise FileNotFoundError(path)
        arr = cv2.resize(arr, (img_size[1], img_size[0]), interpolation=cv2.INTER_LINEAR)
        return (arr.astype(np.float32) / 255.0)[..., None]
    from PIL import Image

    img = Image.open(path).convert("L")
    img = img.resize((img_size[1], img_size[0]), Image.BILINEAR)
    return (np.asarray(img, np.float32) / 255.0)[..., None]


def center_slice(arr: List[int], length: int) -> List[int]:
    c = len(arr) // 2
    start = c - length // 2
    return arr[start : start + length]


class VideoWindowDataset:
    """Window bookkeeping shared by the three visual datasets."""

    def __init__(self, len_snippet: int, mode: str, img_size, gt_length: int,
                 alternate: int, decode: str = "pil"):
        self.len_snippet = len_snippet
        self.decode = decode
        self.mode = mode
        self.img_size = tuple(img_size)
        self.gt_length = gt_length
        self.alternate = alternate
        # reference meta_data.py:36-41: stride 16 for snippets > 16
        self.skip_window = 16 if len_snippet > 16 else len_snippet
        self.frame_lens = 16 if len_snippet > 16 else len_snippet
        self.windows: List[Tuple[str, int]] = []

    def __len__(self):
        return len(self.windows)


class DHF1KDataset(VideoWindowDataset):
    """DHF1k layout: frames/<vid>/<i>.png (1-based), maps/<vid>/%04d.png;
    videos 1-600 train / 601-700 val / 701-1000 test
    (reference dhf1k_data.py:22-56)."""

    def __init__(self, path_data: str, len_snippet: int = 32, mode: str = "train",
                 img_size=(224, 384), gt_length: int = 1, alternate: int = 1,
                 decode: str = "pil"):
        super().__init__(len_snippet, mode, img_size, gt_length, alternate, decode)
        self.img_path = os.path.join(path_data, "frames")
        self.ann_path = os.path.join(path_data, "maps")
        names = sorted(os.listdir(self.img_path), key=int)
        split = {"train": names[:600], "val": names[600:700], "test": names[700:1000]}[mode]
        for v in split:
            n = len(os.listdir(os.path.join(self.img_path, v)))
            stride = {"train": self.skip_window, "val": self.gt_length}.get(mode, 1)
            for i in range(0, n - alternate * len_snippet, stride):
                self.windows.append((v, i))
            if mode == "test":
                self.windows.append((v, n - len_snippet))

    def __getitem__(self, idx: int):
        v, start = self.windows[idx]
        indices = [start + self.alternate * i + 1 for i in range(self.frame_lens)]
        rgb = np.stack([load_rgb_frame(os.path.join(self.img_path, v, f"{i}.png"),
                                       self.img_size, self.decode) for i in indices])
        gt_idx = center_slice(indices, self.gt_length)
        item = {"rgb": rgb, "video_id": v, "gt_index": gt_idx[0]}
        if self.mode != "test":
            item["salmap"] = load_gt_map(os.path.join(self.ann_path, v, "%04d.png" % gt_idx[0]),
                                         self.img_size, self.decode)
        return item


class _TrainTestDirDataset(VideoWindowDataset):
    """Hollywood2 / UCF layout: {training|testing}/<vid>/{images,maps}
    (reference holly2wood_dataset.py / ucf_dataset.py)."""

    zero_based = True  # Hollywood indexes img_list directly from 0

    def __init__(self, path_data: str, len_snippet: int = 32, mode: str = "train",
                 img_size=(224, 384), gt_length: int = 1, alternate: int = 1,
                 decode: str = "pil"):
        super().__init__(len_snippet, mode, img_size, gt_length, alternate, decode)
        self.root = os.path.join(path_data, "training" if mode == "train" else "testing")
        for v in sorted(os.listdir(self.root)):
            n = len(os.listdir(os.path.join(self.root, v, "images")))
            if mode == "train":
                for i in range(0, n - alternate * len_snippet, self.skip_window):
                    self.windows.append((v, i))
            else:
                if n < alternate * len_snippet:
                    continue
                for i in range(0, n - alternate * len_snippet, gt_length):
                    self.windows.append((v, i))
                self.windows.append((v, n - len_snippet))

    def frame_name(self, vid: str, img_list: List[str], i: int) -> str:
        raise NotImplementedError

    def __getitem__(self, idx: int):
        v, start = self.windows[idx]
        img_dir = os.path.join(self.root, v, "images")
        map_dir = os.path.join(self.root, v, "maps")
        img_list = sorted(os.listdir(img_dir))
        offset = 0 if self.zero_based else 1
        indices = [start + self.alternate * i + offset for i in range(self.frame_lens)]
        rgb = np.stack([load_rgb_frame(os.path.join(img_dir, self.frame_name(v, img_list, i)),
                                       self.img_size, self.decode) for i in indices])
        gt_idx = center_slice(indices, self.gt_length)
        item = {"rgb": rgb, "video_id": v, "gt_index": gt_idx[0]}
        if self.mode != "test":
            item["salmap"] = load_gt_map(
                os.path.join(map_dir, self.frame_name(v, img_list, gt_idx[0])),
                self.img_size, self.decode)
        return item


class HollywoodDataset(_TrainTestDirDataset):
    zero_based = True

    def frame_name(self, vid, img_list, i):
        return img_list[i]


class UCFDataset(_TrainTestDirDataset):
    """UCF name mangling: '<action>-<idx>' dirs with frames
    '<action>_<idx>_%03d.png', 1-based (reference ucf_dataset.py:62-72)."""

    zero_based = False

    def frame_name(self, vid, img_list, i):
        vid_index = vid.split("-")[-1]
        vid_name = vid[: -(len(vid_index) + 1)]
        return "{}_{}_{:03d}.png".format(vid_name, vid_index, i)
