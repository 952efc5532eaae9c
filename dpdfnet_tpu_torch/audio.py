"""Host-side audio helpers (counterpart of ``dpdfnet_tpu.audio``): mono
mixdown, resampling, length fitting, 16-bit conversion, the
attenuation limit and the STFT framing.

Resampling takes the JAX package's backend order: ``soxr`` (HQ, the
reference pipeline's resampler) where it imports, else scipy's
Kaiser-windowed polyphase ``resample_poly``; ``DPDFNET_TPU_RESAMPLER``
(``auto`` / ``soxr`` / ``scipy`` / ``native``) forces one.  ``native`` is
the C++ polyphase of ``csrc/dpdfnet_host.cpp`` (``native.py``; the filter of
``resample_poly``), for mono input, where the library builds; scipy
otherwise.
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass

import numpy as np

from .ops.windows import vorbis_window

# frames between the noisy spectrum and its enhanced counterpart in the
# attenuation-limit blend
ATTN_LIMIT_NOISY_FRAME_OFFSET = 4


def to_mono(audio: np.ndarray) -> np.ndarray:
    """Mix down to mono; accepts [S] or [S, C] (channels last, soundfile
    convention)."""
    x = np.asarray(audio, dtype=np.float32)
    if x.ndim == 2:
        x = x.mean(axis=-1, dtype=np.float32)
    elif x.ndim != 1:
        raise ValueError(f"to_mono wants [S] or [S, C] audio, not {x.shape}")
    return x


def _soxr_available() -> bool:
    try:
        import soxr  # noqa: F401
    except ImportError:
        return False
    return True


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Resample between rates (float32 out); a no-op when the rates agree.
    ``soxr`` at its HQ profile where it imports (unless
    ``DPDFNET_TPU_RESAMPLER`` says ``scipy`` or ``native``); the native
    polyphase for mono input under ``DPDFNET_TPU_RESAMPLER=native`` where
    the library builds; else scipy's polyphase ``resample_poly`` in
    float64."""
    if sr_in == sr_out:
        return np.asarray(audio, dtype=np.float32)
    backend = os.environ.get("DPDFNET_TPU_RESAMPLER", "auto")
    if backend in ("auto", "soxr") and _soxr_available():
        import soxr

        return np.asarray(soxr.resample(np.asarray(audio, np.float32), int(sr_in),
                                        int(sr_out), quality="HQ"), dtype=np.float32)
    g = math.gcd(int(sr_in), int(sr_out))
    up, down = sr_out // g, sr_in // g
    x32 = np.asarray(audio, np.float32)
    if backend == "native" and x32.ndim == 1:
        # mono only: the native resampler would read [S, C] as one
        # interleaved signal; multi-channel input takes scipy along axis 0
        from . import native

        y = native.resample(x32, up, down)
        if y is not None:
            return y
    from scipy.signal import resample_poly

    return resample_poly(np.asarray(audio, dtype=np.float64), up, down).astype(np.float32)


def ensure_sample_rate(audio: np.ndarray, sample_rate: int, target: int) -> np.ndarray:
    return resample(audio, sample_rate, target)


def fit_length(audio: np.ndarray, target_len: int) -> np.ndarray:
    """Crop or zero-extend a 1-D signal to exactly ``target_len`` samples."""
    x = np.asarray(audio, dtype=np.float32).reshape(-1)
    if x.shape[0] < target_len:
        return np.pad(x, (0, target_len - x.shape[0]))
    return x[:target_len]


def pcm16_safe(audio: np.ndarray) -> np.ndarray:
    """Float audio as int16, hard-clipped at full scale."""
    scaled = np.asarray(audio, dtype=np.float32) * 32767.0
    return np.clip(scaled, -32767.0, 32767.0).astype(np.int16)


def validate_attn_limit_db(attn_limit_db):
    """Normalise an attenuation-limit argument to float dB (None passes).
    ``inf`` means "no limit"; negative values and NaN are rejected."""
    if attn_limit_db is None:
        return None
    db = float(attn_limit_db)
    if not db >= 0.0:  # single comparison rejects both negatives and NaN
        raise ValueError(
            f"attn_limit_db must be a non-negative dB value, inf, or None; "
            f"got {attn_limit_db!r}.")
    return db


def apply_attn_limit(spec_noisy: np.ndarray, spec_enh: np.ndarray,
                     attn_limit_db) -> np.ndarray:
    """Cap the attenuation by mixing the delayed noisy spectrum back in:
    ``enhanced + alpha * (noisy_delayed - enhanced)``, ``alpha =
    10^(-dB/20)``.  The noisy spectrum ``[B, T, F, 2]`` is delayed by
    ``ATTN_LIMIT_NOISY_FRAME_OFFSET`` frames (the model's 2-frame lookahead
    plus the 2-frame deep-filter delay), silence shifted in at the start.
    The engine applies the same blend on the device."""
    db = validate_attn_limit_db(attn_limit_db)
    enhanced = np.asarray(spec_enh, dtype=np.float32)
    if db is None:
        return enhanced
    noisy = np.asarray(spec_noisy, dtype=np.float32)
    if noisy.shape != enhanced.shape:
        raise ValueError(f"noisy/enhanced spectrogram shapes differ: {noisy.shape} vs "
                         f"{enhanced.shape}.")
    delayed = np.roll(noisy, ATTN_LIMIT_NOISY_FRAME_OFFSET, axis=1)
    delayed[:, :ATTN_LIMIT_NOISY_FRAME_OFFSET] = 0.0
    alpha = np.float32(10.0 ** (-db / 20.0))
    blended = enhanced + alpha * (delayed - enhanced)
    return np.ascontiguousarray(blended, dtype=np.float32)


@dataclass(frozen=True)
class StftConfig:
    """Analysis / synthesis framing, fixed by the window length (50%
    overlap, Vorbis window)."""

    win_len: int

    @property
    def hop_size(self) -> int:
        return self.win_len // 2

    @property
    def window(self) -> np.ndarray:
        return _window_cached(self.win_len)


@functools.lru_cache(maxsize=8)
def _window_cached(win_len: int) -> np.ndarray:
    w = vorbis_window(win_len)
    w.setflags(write=False)
    return w


def make_stft_config(win_len: int) -> StftConfig:
    return StftConfig(win_len=int(win_len))
