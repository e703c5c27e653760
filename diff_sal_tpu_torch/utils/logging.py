"""Training-time logging (JAX package `utils/logging.py`; the artifact
contract of reference `util/utils.py`): AverageMeter(s), a TSV logger
writing the train and val logs with fixed columns, min-max-to-uint8
normalization and a map dumper (cv2, imported where it writes), an
optional wandb hook (a no-op when wandb is absent, reference
train_dhf1k.py:13-19) and a data / step wall-clock timer.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Dict, Iterable

import numpy as np


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class AverageMeterDict:
    """Keyed meters (reference AverageMeterList generalized)."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = OrderedDict()

    def update(self, values: Dict[str, float], n: int = 1):
        for k, v in values.items():
            self.meters.setdefault(k, AverageMeter()).update(float(v), n)

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def reset(self):
        for m in self.meters.values():
            m.reset()


class TSVLogger:
    """Tab-separated epoch log (reference `Logger`, util/utils.py:73-94)."""

    def __init__(self, path: str, header: Iterable[str]):
        self.path = path
        self.header = list(header)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        new = not os.path.exists(path)
        self._f = open(path, "a")
        if new:
            self._f.write("\t".join(self.header) + "\n")
            self._f.flush()

    def log(self, values: Dict):
        row = [str(values.get(k, "")) for k in self.header]
        self._f.write("\t".join(row) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def normalize_to_uint8(x: np.ndarray) -> np.ndarray:
    """Min-max -> [0, 255] uint8 (reference `normalize_data`,
    util/utils.py:96-101)."""
    x = np.asarray(x, np.float64)
    mn, mx = x.min(), x.max()
    if mx > mn:
        x = (x - mn) / (mx - mn)
    else:
        x = np.zeros_like(x)
    return (x * 255.0).astype(np.uint8)


def save_saliency_image(path: str, pred: np.ndarray):
    """Dump one predicted map (reference `save_img`,
    diffusion_trainer.py:898-935): min-max to uint8, imwrite."""
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, normalize_to_uint8(np.squeeze(pred)))


def maybe_wandb(enabled: bool, **init_kwargs):
    """Optional wandb hook; returns a no-op recorder when unavailable."""
    if enabled:
        try:
            import wandb

            wandb.init(**init_kwargs)
            return wandb
        except Exception:
            pass

    class _Noop:
        def log(self, *a, **k):
            pass

        def finish(self):
            pass

    return _Noop()


class StepTimer:
    """data/step wall-clock meters (reference diffusion_trainer.py:198-222)."""

    def __init__(self):
        self.data_time = AverageMeter()
        self.step_time = AverageMeter()
        self._t = time.time()

    def mark_data(self):
        now = time.time()
        self.data_time.update(now - self._t)
        self._t = now

    def mark_step(self):
        now = time.time()
        self.step_time.update(now - self._t)
        self._t = now
