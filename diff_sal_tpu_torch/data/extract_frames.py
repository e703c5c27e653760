"""DHF1k AVI -> PNG frame extraction tool (JAX package
`data/extract_frames.py`; reference `util/dhf1k_frames.py`).

    python -m diff_sal_tpu_torch.data.extract_frames <video_dir> <out_dir> \
        [--annotation_dir DIR]

Writes frames/<video_id>/<i>.png (1-based) and copies annotation maps when
given, matching the on-disk layout DHF1KDataset expects.
"""

from __future__ import annotations

import argparse
import os
import shutil


def extract_video(video_path: str, out_dir: str) -> int:
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        i += 1
        cv2.imwrite(os.path.join(out_dir, f"{i}.png"), frame)
    cap.release()
    return i


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("video_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--annotation_dir", default=None)
    args = ap.parse_args(argv)

    frames_root = os.path.join(args.out_dir, "frames")
    for name in sorted(os.listdir(args.video_dir)):
        if not name.lower().endswith((".avi", ".mp4", ".mkv")):
            continue
        vid = os.path.splitext(name)[0]
        n = extract_video(
            os.path.join(args.video_dir, name),
            os.path.join(frames_root, str(int(vid)) if vid.isdigit() else vid),
        )
        print(f"{vid}: {n} frames")

    if args.annotation_dir:
        maps_root = os.path.join(args.out_dir, "maps")
        os.makedirs(maps_root, exist_ok=True)
        for vid in sorted(os.listdir(args.annotation_dir)):
            src = os.path.join(args.annotation_dir, vid, "maps")
            if os.path.isdir(src):
                shutil.copytree(
                    src, os.path.join(maps_root, vid), dirs_exist_ok=True
                )


if __name__ == "__main__":
    main()
