"""Saliency metrics: the numpy metrics of the offline evaluator
(`saliency.py`), their batched torch versions for evaluation on the
device (`device.py`) and the offline evaluator over dumped prediction
images (`offline.py`)."""

from diff_sal_tpu_torch.metrics.saliency import (  # noqa: F401
    AUC_Borji,
    AUC_Judd,
    AUC_shuffled,
    CC,
    NSS,
    SIM,
    normalize_map,
)
