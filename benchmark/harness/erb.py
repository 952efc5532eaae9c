"""The fixed rectangular ERB filterbanks of DPDFNet (published
``model/utils.py`` ``erb_filter_banks`` and the buffers of
``model/dpdfnet.py``), the benchmark's own copy: the weights it makes
hold them, and both the program and the reference read them from there.
"""

from __future__ import annotations

import numpy as np

_ERB_A = 9.265
_ERB_B = 24.7 * 9.265


def hz2erb(hz):
    return _ERB_A * np.log1p(np.asarray(hz, dtype=np.float64) / _ERB_B)


def erb2hz(erb):
    return _ERB_B * (np.exp(np.asarray(erb, dtype=np.float64) / _ERB_A) - 1.0)


def erb_filter_banks(
    n_filters: int = 32,
    nfft: int = 512,
    fs: int = 16000,
    low_freq: int = 0,
    high_freq: int | None = None,
    min_nb_freqs: int = 2,
) -> np.ndarray:
    """Rectangular ERB filterbank, rows = bands, cols = rfft bins.

    Matches `erb_filter_banks` in the reference bit-for-bit (same rounding
    of band edges, same min-bin spill-over rule).
    """
    high_freq = high_freq if high_freq else fs // 2
    assert high_freq <= fs // 2, "high frequency cannot exceed Nyquist"
    assert 0 <= low_freq < high_freq

    nyq = fs / 2
    freq_width = fs / nfft
    erb_low = hz2erb(0.0)
    erb_high = hz2erb(nyq)
    step = (erb_high - erb_low) / n_filters

    bins = np.zeros(n_filters + 1, dtype=np.int64)
    # The reference fills the first min(33, n+1) edges then forces the last
    # edge to cover all bins; replicate including the 33-entry quirk.
    for i in range(min(33, n_filters + 1)):
        bins[i] = int(round(erb2hz(erb_low + i * step) / freq_width))
    bins[-1] = nfft // 2 + 1

    fbank = np.zeros((n_filters, nfft // 2 + 1), dtype=np.float64)
    freq_over = 0
    for j in range(n_filters):
        alpha, beta = bins[j] + freq_over, bins[j + 1]
        if (beta - alpha) < min_nb_freqs:
            freq_over = min_nb_freqs - (beta - alpha)
            beta = min(beta + freq_over, nfft // 2 + 1)
        else:
            freq_over = 0
        fbank[j, alpha:beta] = 1.0

    assert (fbank.sum(axis=1) > 0).all(), (
        "Some ERB bands are empty; decrease n_filters or increase nfft"
    )
    return np.abs(fbank)


def erb_fb_and_inverse(
    nfft: int, fs: int, n_filters: int, min_nb_freqs: int
) -> tuple[np.ndarray, np.ndarray]:
    """Return (erb_fb [F, E] row-normalised analysis, erb_inv_fb [E, F]).

    Layout matches the registered buffers of the reference model
    (`reference model/dpdfnet.py:419-427`): the analysis matrix is
    applied as ``power @ erb_fb`` and the synthesis as ``mask @ erb_inv_fb``.
    """
    filters = erb_filter_banks(
        n_filters=n_filters, nfft=nfft, fs=fs, low_freq=0, min_nb_freqs=min_nb_freqs
    ).astype(np.float32)
    inv = filters.copy()                       # [E, F] unnormalised
    fwd = filters / filters.sum(-1, keepdims=True)
    return fwd.T.copy(), inv                    # [F, E], [E, F]
