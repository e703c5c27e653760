"""VGGish log-mel audio frontend (JAX package `audio/mel.py`; reference
`datasets/torchvggish/` mel_features.py, vggish_input.py, vggish_params.py
with the repo's framing constants, vggish_params.py:34-35):

  wave @16kHz -> STFT (win 400, hop 160, periodic Hann, |rfft 512|)
             -> HTK mel filterbank, 64 bins, 125-7500 Hz
             -> log(mel + 0.01)
             -> frame into examples of 64 frames, hop 11  (-> N x 64 x 64)

plus the saliency_db packaging (saliency_db.py:449-497, 343-354):
center-pad the wave excerpt into max_audio_win = 22050/10*16 samples,
repeat/trim the examples to exactly 9, bilinear-resize each to (112, 192)
-> model input (9, 112, 192, 1).

The numpy half is the host path (datasets, parity). The torch half
(`log_mel_examples`, `device_audio_frontend`) runs the same math batched
on the wave's device, in f32 (f64 for an f64 wave): the packed AV pipeline
ships raw 16 kHz excerpts and the frontend runs inside the training and
evaluation steps. cv2 is imported only by `examples_to_model_audio`.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000
STFT_WINDOW = 400  # 0.025 s
STFT_HOP = 160  # 0.010 s
FFT_LENGTH = 512
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_WINDOW = 64  # frames  (0.64 s)
EXAMPLE_HOP = 11  # frames  (0.11 s)
AUDIO_LEN = 9  # examples per clip
MAX_AUDIO_WIN = int(22050 / 10 * 16)  # center-pad target, 35280 samples
MODEL_AUDIO_HW = (112, 192)
# 16 kHz equivalent of the reference's 35280-sample pad target at the
# corpus's native 22050 Hz: packed waves are resampled to 16 kHz once at
# pack time, so excerpts are padded into this many samples, which the
# frontend turns into exactly AUDIO_LEN examples (158 STFT frames -> 9
# hops of 11)
PACKED_WAVE_LEN = MAX_AUDIO_WIN * SAMPLE_RATE // 22050  # 25600


def periodic_hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi / n * np.arange(n))


@functools.lru_cache(maxsize=None)
def mel_matrix(num_mel_bins: int = NUM_MEL_BINS, num_spectrogram_bins: int = FFT_LENGTH // 2 + 1,
               sample_rate: int = SAMPLE_RATE, lower_hz: float = MEL_MIN_HZ,
               upper_hz: float = MEL_MAX_HZ) -> np.ndarray:
    """HTK triangular mel weights, (num_spectrogram_bins, num_mel_bins);
    DC bin zeroed (reference mel_features.py:114-189)."""
    to_mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)  # noqa: E731
    bins_mel = to_mel(np.linspace(0.0, sample_rate / 2.0, num_spectrogram_bins))
    edges = np.linspace(to_mel(lower_hz), to_mel(upper_hz), num_mel_bins + 2)
    lower, center, upper = edges[:-2], edges[1:-1], edges[2:]
    lower_slope = (bins_mel[:, None] - lower) / (center - lower)
    upper_slope = (upper - bins_mel[:, None]) / (upper - center)
    w = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    w[0, :] = 0.0
    return w


def _frame_np(x: np.ndarray, window: int, hop: int) -> np.ndarray:
    n = 1 + (len(x) - window) // hop
    idx = np.arange(window)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


def log_mel_spectrogram_np(wave16k: np.ndarray) -> np.ndarray:
    """(num_samples,) -> (num_frames, 64) log-mel, reference math in f64."""
    frames = _frame_np(np.asarray(wave16k, np.float64), STFT_WINDOW, STFT_HOP)
    spec = np.abs(np.fft.rfft(frames * periodic_hann(STFT_WINDOW), FFT_LENGTH))
    return np.log(spec @ mel_matrix() + LOG_OFFSET)


def waveform_to_examples_np(wave: np.ndarray, sample_rate: int) -> np.ndarray:
    """wave (any rate, mono or multichannel) -> (N, 64, 64) examples
    (reference vggish_input.py:30-82); scipy's polyphase resampler stands
    in for resampy."""
    wave = np.asarray(wave, np.float64)
    if wave.ndim > 1:
        wave = wave.mean(axis=1)
    if sample_rate != SAMPLE_RATE:
        from scipy.signal import resample_poly

        g = np.gcd(int(sample_rate), SAMPLE_RATE)
        wave = resample_poly(wave, SAMPLE_RATE // g, int(sample_rate) // g)
    log_mel = log_mel_spectrogram_np(wave)
    if len(log_mel) < EXAMPLE_WINDOW:
        raise ValueError(f"wave too short: {len(log_mel)} mel frames < {EXAMPLE_WINDOW}")
    n = 1 + (len(log_mel) - EXAMPLE_WINDOW) // EXAMPLE_HOP
    idx = np.arange(EXAMPLE_WINDOW)[None, :] + EXAMPLE_HOP * np.arange(n)[:, None]
    return log_mel[idx]


def center_pad_excerpt(excerpt: np.ndarray, total: int = MAX_AUDIO_WIN) -> np.ndarray:
    """Zero-pad a wave excerpt centered in `total` samples (reference
    saliency_db.py:477-487); an over-long excerpt keeps its center."""
    out = np.zeros(total, np.float64)
    v = len(excerpt)
    if v == 0:
        return out
    if v > total:
        start = (v - total) // 2
        return np.asarray(excerpt[start : start + total], np.float64)
    lo = total // 2 - v // 2
    out[lo : lo + v] = excerpt
    return out


def repeat_to_audio_len(examples: np.ndarray, audio_len: int = AUDIO_LEN) -> np.ndarray:
    """repeat_interleave + tail-cat to exactly `audio_len` examples
    (reference saliency_db.py:489-497)."""
    n = examples.shape[0]
    if n != audio_len:
        rep = audio_len // n
        if rep != 0:
            examples = np.repeat(examples, rep, axis=0)
        examples = np.concatenate([examples, examples[: audio_len % n]], axis=0)
    return examples[:audio_len]


def examples_to_model_audio(examples: np.ndarray, hw=None) -> np.ndarray:
    """(N, 64, 64) -> (9, H, W, 1) float32 model input: repeat/trim to 9,
    then cv2's bilinear resize per example (the reference's audio transform
    Resize((112, 192)), saliency_db.py:343-354). `hw` defaults to (112,
    192); a reduced-resolution model takes its audio at half its map size."""
    import cv2

    hw = tuple(hw) if hw is not None else MODEL_AUDIO_HW
    examples = repeat_to_audio_len(np.asarray(examples))
    out = np.empty((AUDIO_LEN, *hw, 1), np.float32)
    for i, ex in enumerate(examples):
        out[i, :, :, 0] = cv2.resize(ex.astype(np.float32), (hw[1], hw[0]),
                                     interpolation=cv2.INTER_LINEAR)
    return out


def clip_audio_to_model_input(wave: np.ndarray, sample_rate: int, is_silent: bool = False,
                              hw=None) -> np.ndarray:
    """The whole host path for one clip excerpt -> (9, 112, 192, 1) by
    default."""
    if is_silent:
        ex = waveform_to_examples_np(np.zeros(MAX_AUDIO_WIN), sample_rate)
    else:
        ex = waveform_to_examples_np(center_pad_excerpt(wave), sample_rate)
    return examples_to_model_audio(ex, hw)


# ---------------------------------------------------------------------------
# Device path: batched, on the wave's device.
# ---------------------------------------------------------------------------


def log_mel_examples(wave16k: torch.Tensor) -> torch.Tensor:
    """(B, num_samples) fixed-length 16 kHz waves -> (B, N, 64, 64), in the
    wave's float dtype (f32 unless it is f64), on its device."""
    f = torch.float64 if wave16k.dtype == torch.float64 else torch.float32
    dev = wave16k.device
    frames = wave16k.to(f).unfold(-1, STFT_WINDOW, STFT_HOP)  # (B, frames, 400)
    frames = frames * torch.as_tensor(periodic_hann(STFT_WINDOW), dtype=f, device=dev)
    spec = torch.fft.rfft(frames, FFT_LENGTH).abs()
    log_mel = torch.log(spec @ torch.as_tensor(mel_matrix(), dtype=f, device=dev) + LOG_OFFSET)
    n_frames = log_mel.shape[-2]
    if n_frames < EXAMPLE_WINDOW:
        raise ValueError(f"wave too short: {n_frames} mel frames < {EXAMPLE_WINDOW}")
    return log_mel.unfold(-2, EXAMPLE_WINDOW, EXAMPLE_HOP).transpose(-1, -2)


def device_audio_frontend(wave16k: torch.Tensor,
                          hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(B, num_samples) -> (B, 9, H, W, 1) model audio on the wave's device:
    log-mel examples, repeated or trimmed to 9 as the host path does
    (the standard PACKED_WAVE_LEN excerpt gives exactly 9), then the
    bilinear resize to `hw` (default (112, 192), saliency_db.py:343-354)."""
    from diff_sal_tpu_torch.ops.resize import bilinear_resize

    ex = log_mel_examples(wave16k)  # (B, N, 64, 64)
    n = ex.shape[1]
    if n != AUDIO_LEN:
        rep = AUDIO_LEN // n
        if rep:
            ex = torch.repeat_interleave(ex, rep, dim=1)
        ex = torch.cat([ex, ex[:, : AUDIO_LEN % n]], dim=1)[:, :AUDIO_LEN]
    return bilinear_resize(ex[..., None], tuple(hw) if hw is not None else MODEL_AUDIO_HW)
