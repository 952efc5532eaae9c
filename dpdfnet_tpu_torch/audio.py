"""Audio-level helpers the offline engine needs (counterpart of part of
``dpdfnet_tpu.audio``; resampling and the host-side blend wait for the
package-surface slice)."""

from __future__ import annotations

# frames between the noisy spectrum and its enhanced counterpart in the
# attenuation-limit blend
ATTN_LIMIT_NOISY_FRAME_OFFSET = 4


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
