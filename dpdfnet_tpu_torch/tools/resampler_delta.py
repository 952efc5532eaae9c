"""Resampler backends against each other (counterpart of the repository's
``tools/resampler_delta.py``): scipy's polyphase against the native C++
polyphase (``native.py``) and against soxr HQ, the reference pipeline's
resampler, on a speech-shaped signal for the deployment ratios (48k <-> 16k
for the 16 kHz models, 44.1k <-> 48k for the 48 kHz ones).

    python -m dpdfnet_tpu_torch.tools.resampler_delta [--device cpu]

Prints the RMS difference in dB against the signal on the central region
(the filters' edge transients excluded); SKIPPED where soxr does not
import, and for the native backend where its library does not build.
Resampling runs on the host; ``--device`` is taken, as by every tool of
the port, and names where the caller runs, which changes nothing here.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

RATES = ((48000, 16000), (16000, 48000), (44100, 48000), (48000, 44100))
BACKEND = "DPDFNET_TPU_RESAMPLER"


def delta_db(a: np.ndarray, b: np.ndarray) -> float:
    """RMS of ``a - b`` over the RMS of ``a``, in dB, on the central 3/4."""
    n = min(len(a), len(b))
    lo, hi = n // 8, n - n // 8
    a, b = a[lo:hi].astype(np.float64), b[lo:hi].astype(np.float64)
    d = np.sqrt(np.mean((a - b) ** 2))
    s = np.sqrt(np.mean(a ** 2))
    return float(20 * np.log10(max(d, 1e-12) / max(s, 1e-12)))


def run_backend(x: np.ndarray, sr_in: int, sr_out: int, backend: str) -> np.ndarray:
    from .. import audio

    saved = os.environ.get(BACKEND)
    os.environ[BACKEND] = backend
    try:
        return audio.resample(x, sr_in, sr_out)
    finally:
        if saved is None:
            os.environ.pop(BACKEND, None)
        else:
            os.environ[BACKEND] = saved


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default=None,
                    help="taken by every tool of the port; resampling runs on the host")
    args = ap.parse_args(argv)

    from .. import native
    from ..audio import _soxr_available
    from ..quality import speechlike_test_signal

    for sr_in, sr_out in RATES:
        x = speechlike_test_signal(args.seconds, sr_in, seed=0)[0]
        ref = run_backend(x, sr_in, sr_out, "scipy")
        print(f"{sr_in} -> {sr_out}:")
        if native.available():
            print(f"  native vs scipy: {delta_db(ref, run_backend(x, sr_in, sr_out, 'native')):7.1f} dB")
        else:
            print("  native vs scipy: SKIPPED (native library not built)")
        if _soxr_available():
            print(f"  soxr   vs scipy: {delta_db(ref, run_backend(x, sr_in, sr_out, 'soxr')):7.1f} dB")
        else:
            print("  soxr   vs scipy: SKIPPED (soxr not installed)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
