"""Analysis/synthesis windows and scaling (own copy of ``dpdfnet_tpu.ops.windows``).

The Vorbis window satisfies the COLA identity ``w[n]^2 + w[n+hop]^2 == 1``
at 50% overlap.
"""

from __future__ import annotations

import numpy as np


def vorbis_window(window_len: int) -> np.ndarray:
    half = window_len / 2.0
    n = np.arange(window_len, dtype=np.float64)
    s = np.sin(0.5 * np.pi * (n + 0.5) / half)
    return np.sin(0.5 * np.pi * s * s).astype(np.float32)


def get_wnorm(window_len: int, hop: int) -> float:
    return 1.0 / (window_len ** 2 / (2.0 * hop))
