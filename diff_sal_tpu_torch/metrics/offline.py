"""Offline metric evaluation over dumped prediction images (JAX package
`metrics/offline.py`).

Mirrors reference `compute_metrics.py`: per task-directory, per video, pair
each predicted PNG/JPG with its GT map and fixation map, score
AUC-Judd / sAUC / CC / NSS / SIM in a process pool, accumulate per-video
means, and write '<pred_path>_metrics.csv'. Dataset-specific frame-name
pairing for DHF1k / UCF / Hollywood2 and the AV datasets is preserved.
"""

from __future__ import annotations

import csv
import os
import multiprocessing
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from diff_sal_tpu_torch.metrics.saliency import AUC_Judd, AUC_shuffled, CC, NSS, SIM


def _imread(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.float64) / 255.0


def score_pair(paths: Tuple[str, str, Optional[str]]):
    """(pred, gt_map, fixation_or_None) -> (auc_j, auc_s, cc, nss, sim)."""
    pred_path, gt_path, fix_path = paths
    pred = _imread(pred_path)
    gt = _imread(gt_path)
    fix = _imread(fix_path) if fix_path and os.path.exists(fix_path) else None
    auc_j = AUC_Judd(pred, fix) if fix is not None else float("nan")
    auc_s = 0.0  # the reference's compute_metrics.py leaves AUC_Borji / sAUC at 0.0
    cc = CC(pred, gt)
    nss = NSS(pred, fix) if fix is not None else float("nan")
    sim = SIM(pred, gt)
    return auc_j, auc_s, cc, nss, sim


def pair_dhf1k(pred_video_dir: str, gt_video_dir: str):
    pairs = []
    for n in sorted(os.listdir(pred_video_dir)):
        if not n.endswith(".png"):
            continue
        fid = int(n.split(".")[0])
        gt = os.path.join(gt_video_dir, "maps", "%04d.png" % fid)
        fix = os.path.join(gt_video_dir, "fixation", "%04d.png" % fid)
        pairs.append((os.path.join(pred_video_dir, n), gt, fix))
    return pairs


def pair_generic(pred_video_dir: str, gt_maps_dir: str, fix_dir: Optional[str]):
    """Pair by sorted order when frame naming differs (Hollywood-style)."""
    preds = sorted(
        n for n in os.listdir(pred_video_dir) if n.endswith((".png", ".jpg"))
    )
    gts = sorted(n for n in os.listdir(gt_maps_dir))
    pairs = []
    for i, n in enumerate(preds):
        if i >= len(gts):
            break
        fix = os.path.join(fix_dir, gts[i]) if fix_dir else None
        pairs.append(
            (os.path.join(pred_video_dir, n), os.path.join(gt_maps_dir, gts[i]), fix)
        )
    return pairs


def evaluate_predictions(
    pred_path: str,
    gt_root: str,
    data_type: str = "dhf1k",
    vid_list: Optional[Sequence] = None,
    processes: int = 8,
) -> Dict[str, np.ndarray]:
    """Walk <pred_path>/<task>/<vid>/ and score all tasks. Returns
    {task: [auc_j, auc_s, cc, nss, sim]} and writes the CSV next to
    pred_path (reference compute_metrics.py:29-122)."""
    task_names = sorted(os.listdir(pred_path))
    task_metrics: Dict[str, np.ndarray] = {}
    # spawned workers (forking a process that runs threads is unsafe), each
    # starting from the caller's global numpy RNG state, as forked ones do
    # in the JAX package: AUC-Judd's tie-breaking jitter draws from it
    pool = multiprocessing.get_context("spawn").Pool(
        processes, initializer=np.random.set_state, initargs=(np.random.get_state(),))
    try:
        for task in task_names:
            all_metrics = []
            task_dir = os.path.join(pred_path, task)
            vids = vid_list or sorted(os.listdir(task_dir))
            for vid in vids:
                pred_video_dir = os.path.join(task_dir, str(vid))
                if not os.path.isdir(pred_video_dir):
                    continue
                if data_type == "dhf1k":
                    gt_video_dir = os.path.join(gt_root, "%04d" % int(vid))
                    pairs = pair_dhf1k(pred_video_dir, gt_video_dir)
                else:
                    gt_maps = os.path.join(gt_root, str(vid), "maps")
                    fix_dir = os.path.join(gt_root, str(vid), "fixation")
                    pairs = pair_generic(
                        pred_video_dir,
                        gt_maps,
                        fix_dir if os.path.isdir(fix_dir) else None,
                    )
                if not pairs:
                    continue
                results = np.asarray(pool.map(score_pair, pairs))
                all_metrics.append(np.nanmean(results, axis=0))
            if all_metrics:
                task_metrics[task] = np.around(np.nanmean(all_metrics, axis=0), 4)
    finally:
        pool.close()
        pool.join()

    with open(pred_path.rstrip("/") + "_metrics.csv", "w") as f:
        w = csv.writer(f)
        w.writerow(["Task", "AUC_J ", "AUC_S ", "CC ", "NSS ", "Sim"])
        for task, vals in task_metrics.items():
            w.writerow([task] + list(vals))
    return task_metrics


def aggregate_results(result_dir: str, out_csv: str):
    """Collect per-run result txt/csv files into one CSV
    (reference recompute_overall_metrics.py:18-60)."""
    import pandas as pd

    rows = []
    for name in sorted(os.listdir(result_dir)):
        if not name.endswith((".txt", ".csv")):
            continue
        path = os.path.join(result_dir, name)
        try:
            df = pd.read_csv(path)
            df["source"] = name
            rows.append(df)
        except Exception:
            continue
    if rows:
        pd.concat(rows).to_csv(out_csv, index=False)
    return out_csv
