"""Saliency losses and eval scores (JAX package `train/losses.py`;
reference `models/sal_losses.py`): MSE (the default training loss), KL
divergence, Pearson CC, histogram similarity, NSS, BCE, the weighted
training loss and the unweighted eval score whose `total = nss + cc + sim`
selects checkpoints.

Maps are (B, ...), flattened per sample. Standard deviations are unbiased
(ddof=1), as torch.std's default and the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from diff_sal_tpu_torch.config import LossConfig

EPS = 2.2204e-16


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _std(x: torch.Tensor) -> torch.Tensor:
    return x.std(dim=1, keepdim=True)


def _reduce(v: torch.Tensor, reduce: bool) -> torch.Tensor:
    return v.mean() if reduce else v


def mse_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Sum over pixels, mean over the batch (reference sal_losses.py:189-192)."""
    return _flat((pred - gt) ** 2).sum(1).mean()


def nss(pred: torch.Tensor, gt: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """Normalized Scanpath Saliency against the continuous gt map, as the
    reference computes it (sal_losses.py:14-35)."""
    p, g = _flat(pred), _flat(gt)
    p = (p - p.mean(1, keepdim=True)) / (_std(p) + EPS)
    return _reduce((p * g).sum(1) / g.sum(1), reduce)


def cc(pred: torch.Tensor, gt: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """Pearson correlation (sal_losses.py:66-100)."""
    p, g = _flat(pred), _flat(gt)
    p = (p - p.mean(1, keepdim=True)) / _std(p)
    g = (g - g.mean(1, keepdim=True)) / _std(g)
    return _reduce((p * g).sum(1) / torch.sqrt((p * p).sum(1) * (g * g).sum(1)), reduce)


def kldiv(pred: torch.Tensor, gt: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """KL divergence between sum-normalized maps (sal_losses.py:103-128)."""
    p, g = _flat(pred), _flat(gt)
    p = p / p.sum(1, keepdim=True)
    g = g / g.sum(1, keepdim=True)
    return _reduce((g * torch.log(EPS + g / (p + EPS))).sum(1), reduce)


def _minmax_norm(x: torch.Tensor) -> torch.Tensor:
    mn = x.min(1, keepdim=True).values
    mx = x.max(1, keepdim=True).values
    return (x - mn) / (mx - mn)


def similarity(pred: torch.Tensor, gt: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """Histogram intersection after min-max and sum normalization
    (sal_losses.py:151-176)."""
    p, g = _minmax_norm(_flat(pred)), _minmax_norm(_flat(gt))
    p = p / p.sum(1, keepdim=True)
    g = g / g.sum(1, keepdim=True)
    return _reduce(torch.minimum(p, g).sum(1), reduce)


def bce_loss(pred_logits: torch.Tensor, label: torch.Tensor, weights) -> torch.Tensor:
    """Weighted per-sample binary cross-entropy on logits, labels scaled by
    1/255 (reference `cross_entropy_loss`, sal_losses.py:48-63)."""
    p, lab = _flat(pred_logits), _flat(label) / 255.0
    per_el = torch.clamp_min(p, 0) - p * lab + torch.log1p(torch.exp(-p.abs()))
    return (per_el.sum(1) * weights).sum()


def training_loss(cfg: LossConfig, pred: torch.Tensor,
                  gt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Weighted train loss (reference `get_lossv2`, sal_losses.py:179-259);
    the default config is MSE only."""
    zero = torch.zeros((), device=pred.device)
    main = zero
    if cfg.loss_kl:
        main = cfg.kl_weight * kldiv(pred, gt)
    elif cfg.loss_ce:
        main = bce_loss(pred, gt, cfg.ce_weight)
    elif cfg.loss_mse:
        main = cfg.mse_weight * mse_loss(pred, gt)
    cc_l = cfg.cc_weight * cc(pred, gt) if cfg.loss_cc else zero
    sim_l = cfg.sim_weight * similarity(pred, gt) if cfg.loss_sim else zero
    nss_l = cfg.nss_weight * nss(pred, gt) if cfg.loss_nss else zero
    return {"total": main + cc_l + sim_l + nss_l, "main": main, "cc": cc_l, "sim": sim_l,
            "nss": nss_l}


def _masked_mean(v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the batch, weighted by a (B,) validity mask when given:
    padded duplicate samples do not count."""
    if mask is None:
        return v.mean()
    m = mask.to(v.dtype)
    return (v * m).sum() / torch.clamp_min(m.sum(), 1.0)


def eval_scores(pred: torch.Tensor, gt: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Unweighted eval metrics; `total = nss + cc + sim` is maximized for
    model selection (reference sal_losses.py:207-233)."""
    cc_v = _masked_mean(cc(pred, gt, reduce=False), mask)
    sim_v = _masked_mean(similarity(pred, gt, reduce=False), mask)
    nss_v = _masked_mean(nss(pred, gt, reduce=False), mask)
    return {"total": nss_v + cc_v + sim_v, "kl": _masked_mean(kldiv(pred, gt, reduce=False), mask),
            "cc": cc_v, "sim": sim_v, "nss": nss_v}
