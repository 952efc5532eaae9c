"""Host-side audio helpers (counterpart of ``dpdfnet_tpu.audio``): mono
mixdown, resampling, the attenuation-limit argument.

Resampling is scipy's Kaiser-windowed polyphase ``resample_poly``, the
JAX package's branch when ``soxr`` is not installed; its ``native``
branch (the C++ polyphase of ``native/``) waits for the ``native.py``
slice.
"""

from __future__ import annotations

import math

import numpy as np

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


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Resample between rates with scipy's polyphase ``resample_poly``
    (float64 inside, float32 out); a no-op when the rates agree."""
    if sr_in == sr_out:
        return np.asarray(audio, dtype=np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(int(sr_in), int(sr_out))
    up, down = sr_out // g, sr_in // g
    return resample_poly(np.asarray(audio, dtype=np.float64), up, down).astype(np.float32)


def ensure_sample_rate(audio: np.ndarray, sample_rate: int, target: int) -> np.ndarray:
    return resample(audio, sample_rate, target)


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
