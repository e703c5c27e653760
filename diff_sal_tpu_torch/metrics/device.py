"""Batched saliency metrics on the device (JAX package `metrics/device.py`).

Torch versions of the numpy metrics in `saliency.py`, for scoring a batch
of maps where they lie, without a copy to the host. The AUC-Judd
threshold sweep is rank-based: with the reference's own tie-breaking
jitter, the trapezoidal AUC equals the Mann-Whitney statistic
  AUC = P(S[fix] > S[non-fix])   (ties at 1/2)
computed here from average ranks via a double argsort and
`searchsorted`, one sort pipeline instead of an O(n_fix * n_pixels) loop.

Fixation maps are dense binary masks; every function is batched over the
leading axis and returns a (B,) tensor on its inputs' device.
"""

from __future__ import annotations

import torch


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def auc_judd(saliency: torch.Tensor, fixations: torch.Tensor) -> torch.Tensor:
    """Batched AUC-Judd with the reference's trapezoid semantics
    (thresholds at the fixation saliencies, trapz over the (fp, tp)
    polyline, including its +0.5 dtp dfp per-segment half-credit over the
    plain Mann-Whitney statistic).

    saliency (B, ...), fixations (B, ...) binary; returns (B,) f32, NaN
    where a sample has no fixations. Ties take average ranks (the
    reference breaks them with 1e-7 jitter instead)."""
    S = _flat(saliency).float()
    F = _flat(fixations) > 0.5
    n = S.shape[1]

    order = torch.argsort(S, dim=1, stable=True)
    inv_order = torch.argsort(order, dim=1, stable=True)
    S_sorted = torch.gather(S, 1, order)
    lo = torch.searchsorted(S_sorted, S_sorted, side="left")
    hi = torch.searchsorted(S_sorted, S_sorted, side="right")
    avg_rank_sorted = (lo + hi - 1).float() / 2.0  # average 0-based ascending rank
    avg_rank = torch.gather(avg_rank_sorted, 1, inv_order)

    n_fix = F.sum(dim=1, keepdim=True).float()
    n_neg = n - n_fix

    # fixation ranks, descending; non-fixations pushed to -inf
    fix_ranks = torch.where(F, avg_rank, torch.full_like(avg_rank, -float("inf")))
    rd = torch.sort(fix_ranks, dim=1, descending=True).values

    k = torch.arange(1, n + 1, dtype=torch.float32, device=S.device)[None, :]  # 1-based
    valid = k <= n_fix
    above = n - rd  # |{S >= s_k}| for distinct values
    one = torch.ones((), dtype=torch.float32, device=S.device)
    tp_mid = torch.where(valid, k / n_fix, one)
    fp_mid = torch.where(valid, (above - k) / n_neg, one)

    # polyline: (0, 0), midpoints, (1, 1)
    zeros = torch.zeros((S.shape[0], 1), dtype=torch.float32, device=S.device)
    ones = torch.ones_like(zeros)
    tp = torch.cat([zeros, tp_mid, ones], dim=1)
    fp = torch.cat([zeros, fp_mid, ones], dim=1)
    auc = torch.sum(0.5 * (tp[:, 1:] + tp[:, :-1]) * (fp[:, 1:] - fp[:, :-1]), dim=1)
    return torch.where(n_fix[:, 0] > 0, auc, torch.full_like(auc, float("nan")))


def nss_fix(saliency: torch.Tensor, fixations: torch.Tensor) -> torch.Tensor:
    """Batched fixation-based NSS: the zero-mean unit-std map (population
    std), averaged at the fixations; NaN without fixations."""
    S = _flat(saliency).float()
    F = _flat(fixations) > 0.5
    mean = S.mean(dim=1, keepdim=True)
    std = S.std(dim=1, correction=0, keepdim=True)
    Z = (S - mean) / std
    n_fix = F.sum(dim=1)
    val = torch.where(F, Z, torch.zeros_like(Z)).sum(dim=1) / n_fix
    return torch.where(n_fix > 0, val, torch.full_like(val, float("nan")))


def cc_maps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Pearson correlation between two maps, (B,)."""
    A, B = _flat(a), _flat(b)
    A = A - A.mean(dim=1, keepdim=True)
    B = B - B.mean(dim=1, keepdim=True)
    num = torch.sum(A * B, dim=1)
    den = torch.sqrt(torch.sum(A * A, dim=1) * torch.sum(B * B, dim=1))
    return num / den


def sim_maps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched histogram intersection after range and sum normalisation."""
    def prep(x):
        x = _flat(x)
        mn = x.min(dim=1, keepdim=True).values
        mx = x.max(dim=1, keepdim=True).values
        x = (x - mn) / (mx - mn)
        return x / torch.sum(x, dim=1, keepdim=True)

    return torch.sum(torch.minimum(prep(a), prep(b)), dim=1)
