"""The 'spec' and 'ori' audio feature types (JAX package
`audio/features.py`). The reference supports three audio_type values
(its config fixes 'mel', dataset.json:81): 'spec', a standardized
log-spectrogram (1, 257, 219) (saliency_db.py:403-447), and 'ori', the raw
wave excerpt (1, 1, max_audio_win) (saliency_db.py:499-530). The shipped
model consumes 'mel'."""

from __future__ import annotations

import numpy as np

from diff_sal_tpu_torch.audio.mel import MAX_AUDIO_WIN, center_pad_excerpt


def spec_feature(wave_excerpt: np.ndarray, sample_rate: int) -> np.ndarray:
    """Center-padded excerpt -> log spectrogram (nperseg=512,
    noverlap=353), standardized, (1, 257, n_frames): (1, 257, 219) at the
    standard 35280-sample window."""
    from scipy import signal

    x = np.clip(center_pad_excerpt(wave_excerpt), -1.0, 1.0)
    _, _, spec = signal.spectrogram(x, sample_rate, nperseg=512, noverlap=353)
    spec = np.log(spec + 1e-7)
    spec = (spec - spec.mean()) / (spec.std() + 1e-9)
    return spec[None].astype(np.float32)


def raw_feature(wave_excerpt: np.ndarray, max_win: int = MAX_AUDIO_WIN) -> np.ndarray:
    """Raw wave excerpt front-padded into (1, 1, max_win); the 'ori' type
    truncates from the start rather than centering."""
    out = np.zeros((1, 1, max_win), np.float32)
    n = min(len(wave_excerpt), max_win)
    out[0, 0, :n] = wave_excerpt[:n]
    return out
