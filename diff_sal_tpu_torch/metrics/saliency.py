"""Classic saliency metrics: host (numpy) implementations for the offline
evaluator, a copy of the JAX package's `metrics/saliency.py`.

Semantics mirror reference `metrics/metrics.py` (AUC-Judd :7-64, AUC-Borji
:67-130, sAUC :133-175, NSS :178-200, CC :203-224, SIM :227-252) and
`metrics/utils.py` normalize helpers, with two changes:

* the O(n_fix * n_pixels) per-threshold loops are replaced by sort /
  searchsorted formulations (bit-identical results);
* shape matching uses OpenCV bicubic resize, imported in `_resize_to`
  (skimage is not a dependency; boundary handling differs in the last
  ulps only).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def _resize_to(a: np.ndarray, shape) -> np.ndarray:
    if a.shape == tuple(shape):
        return a
    import cv2

    return cv2.resize(
        a.astype(np.float64), (shape[1], shape[0]), interpolation=cv2.INTER_CUBIC
    )


def normalize_map(x: np.ndarray, method: str = "range") -> np.ndarray:
    """'range' -> [0,1]; 'standard' -> zero mean unit std; 'sum' -> sums to 1
    (reference metrics/utils.py:6-40)."""
    x = np.asarray(x, np.float64)
    if method == "range":
        mn, mx = x.min(), x.max()
        return (x - mn) / (mx - mn) if mx > mn else np.zeros_like(x)
    if method == "standard":
        s = x.std()
        return (x - x.mean()) / s if s > 0 else x - x.mean()
    if method == "sum":
        t = x.sum()
        return x / t if t != 0 else x
    raise ValueError(method)


def AUC_Judd(
    saliency_map: np.ndarray,
    fixation_map: np.ndarray,
    jitter: bool = True,
    rng: Optional[np.random.RandomState] = None,
) -> float:
    """Threshold sweep over saliency values at fixations; tp/fp trapezoid.

    Vectorized: for thresholds = sorted fixation saliencies (desc),
    |{S >= thresh}| comes from one searchsorted over the sorted map.
    """
    S = np.asarray(saliency_map, np.float64).copy()
    F = np.asarray(fixation_map) > 0.5
    if not np.any(F):
        return float("nan")
    if S.shape != F.shape:
        S = _resize_to(S, F.shape)
    if jitter:
        r = rng or np.random
        S += r.rand(*S.shape) * 1e-7
    S = normalize_map(S, "range")

    S, F = S.ravel(), F.ravel()
    S_fix = S[F]
    n_fix, n_pixels = len(S_fix), len(S)
    thresholds = np.sort(S_fix)[::-1]
    S_sorted = np.sort(S)
    above = n_pixels - np.searchsorted(S_sorted, thresholds, side="left")
    k = np.arange(n_fix)
    tp = np.concatenate([[0.0], (k + 1) / n_fix, [1.0]])
    fp = np.concatenate([[0.0], (above - k - 1) / (n_pixels - n_fix), [1.0]])
    return float(np.trapezoid(tp, fp))


def _auc_sweep(S_fix: np.ndarray, S_rand: np.ndarray, step_size: float) -> np.ndarray:
    """Per-repeat fixed-step threshold sweep (reference AUC_Borji inner
    loop), vectorized over thresholds and repeats."""
    n_fix = len(S_fix)
    n_rep = S_rand.shape[1]
    auc = np.empty(n_rep)
    sf_sorted = np.sort(S_fix)
    for rep in range(n_rep):
        sr = S_rand[:, rep]
        hi = max(S_fix.max(), sr.max())
        thresholds = np.arange(0, hi, step_size)[::-1]
        sr_sorted = np.sort(sr)
        tp_mid = (n_fix - np.searchsorted(sf_sorted, thresholds, side="left")) / n_fix
        fp_mid = (n_fix - np.searchsorted(sr_sorted, thresholds, side="left")) / n_fix
        tp = np.concatenate([[0.0], tp_mid, [1.0]])
        fp = np.concatenate([[0.0], fp_mid, [1.0]])
        auc[rep] = np.trapezoid(tp, fp)
    return auc


def AUC_Borji(
    saliency_map: np.ndarray,
    fixation_map: np.ndarray,
    n_rep: int = 100,
    step_size: float = 0.1,
    rand_sampler: Optional[Callable] = None,
    rng: Optional[np.random.RandomState] = None,
) -> float:
    S = np.asarray(saliency_map, np.float64)
    F = np.asarray(fixation_map) > 0.5
    if not np.any(F):
        return float("nan")
    if S.shape != F.shape:
        S = _resize_to(S, F.shape)
    S = normalize_map(S, "range")
    S, F = S.ravel(), F.ravel()
    S_fix = S[F]
    n_fix, n_pixels = len(S_fix), len(S)
    r = rng or np.random
    if rand_sampler is None:
        idx = r.randint(0, n_pixels, [n_fix, n_rep])
        S_rand = S[idx]
    else:
        S_rand = rand_sampler(S, F, n_rep, n_fix)
    return float(np.mean(_auc_sweep(S_fix, S_rand, step_size)))


def AUC_shuffled(
    saliency_map: np.ndarray,
    fixation_map: np.ndarray,
    other_map: np.ndarray,
    n_rep: int = 100,
    step_size: float = 0.1,
    rng: Optional[np.random.RandomState] = None,
) -> float:
    """Shuffled AUC: false positives sampled from fixations of other images."""
    other = np.asarray(other_map) > 0.5
    F = np.asarray(fixation_map)
    if other.shape != F.shape:
        raise ValueError("other_map.shape != fixation_map.shape")
    r = rng or np.random

    def sample_other(S, F_, n_rep, n_fix):
        fixated = np.nonzero(other.ravel())[0]
        cols = np.stack(
            [r.permutation(len(fixated))[:n_fix] for _ in range(n_rep)], axis=1
        )
        return S[fixated[cols]]

    return AUC_Borji(
        saliency_map, fixation_map, n_rep, step_size, sample_other, rng=rng
    )


def NSS(saliency_map: np.ndarray, fixation_map: np.ndarray) -> float:
    S = np.asarray(saliency_map, np.float64)
    F = np.asarray(fixation_map) > 0.5
    if S.shape != F.shape:
        S = _resize_to(S, F.shape)
    S = normalize_map(S, "standard")
    return float(S[F].mean())


def CC(saliency_map1: np.ndarray, saliency_map2: np.ndarray) -> float:
    a = np.asarray(saliency_map1, np.float64)
    b = np.asarray(saliency_map2, np.float64)
    if a.shape != b.shape:
        a = _resize_to(a, b.shape)
    a = normalize_map(a, "standard")
    b = normalize_map(b, "standard")
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def SIM(saliency_map1: np.ndarray, saliency_map2: np.ndarray) -> float:
    a = np.asarray(saliency_map1, np.float64)
    b = np.asarray(saliency_map2, np.float64)
    if a.shape != b.shape:
        a = _resize_to(a, b.shape)
    a = normalize_map(normalize_map(a, "range"), "sum")
    b = normalize_map(normalize_map(b, "range"), "sum")
    return float(np.minimum(a, b).sum())
