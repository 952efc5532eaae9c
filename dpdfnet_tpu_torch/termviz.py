"""Terminal spectrogram view for the real-time demo (own copy of
``dpdfnet_tpu.termviz``).

Paired noisy | enhanced spectrograms, time scrolling downwards, as
ANSI-colored text, one line per STFT frame: it needs no display server
and works over SSH, inside tmux, and when piped to a file (lines are
self-contained), with no dependency beyond numpy.

Layout per emitted line::

    [noisy: one colored cell per log-spaced band] | [enhanced: same bands]

Color encodes band energy in dB on a perceptual dark->bright ramp using
the xterm-256 palette.  Band pooling is log-spaced (a mel-like
y-axis) over an ``n_fft/2+1``-bin magnitude spectrum.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

# xterm-256 dark->bright perceptual ramp (deep blue -> cyan -> green ->
# yellow -> white), indices into the 6x6x6 color cube.
_RAMP = (16, 17, 18, 19, 20, 26, 32, 38, 44, 50,
         49, 48, 47, 46, 82, 118, 154, 190, 226, 227, 229, 231)
_DB_LO, _DB_HI = -70.0, -5.0


def _band_edges(n_bins: int, bands: int) -> np.ndarray:
    """Log-spaced band edges over [1, n_bins] (DC folded into band 0).

    Strictly increasing: rounding collisions at the low end are resolved by
    bumping each edge past its predecessor (requires n_bins > bands).
    """
    edges = np.round(np.geomspace(1, n_bins, bands + 1)).astype(int)
    for i in range(1, len(edges)):
        edges[i] = max(edges[i], edges[i - 1] + 1)
    return np.minimum(edges, n_bins)


class TerminalSpectrogram:
    """Streaming noisy/enhanced spectrogram printer.

    Feed audio chunks as they flow through the demo; whenever a full hop of
    BOTH signals is buffered, one ANSI line is printed.  The enhanced
    signal lags the noisy one by the model's algorithmic delay — callers
    should feed the *time-aligned* noisy branch (the demo already maintains
    one for its mix slider).
    """

    def __init__(self, sample_rate: int, bands: int = 36,
                 n_fft: int = 512, hop: Optional[int] = None,
                 out=None) -> None:
        self.sr = sample_rate
        self.n_fft = n_fft
        self.hop = hop or (n_fft // 2)
        self.bands = bands
        self._win = np.hanning(n_fft).astype(np.float32)
        self._edges = _band_edges(n_fft // 2 + 1, bands)
        self._buf = [np.zeros(0, np.float32), np.zeros(0, np.float32)]
        self._out = out if out is not None else sys.stderr
        self._header_done = False

    # -------------------------------------------------------------- #

    def _band_db(self, frame: np.ndarray) -> np.ndarray:
        spec = np.fft.rfft(frame * self._win)
        power = (spec.real ** 2 + spec.imag ** 2) / self.n_fft
        e = self._edges
        n = power.shape[0]
        bands = np.array([
            power[min(e[i], n - 1): max(e[i] + 1, e[i + 1])].mean()
            for i in range(self.bands)
        ])
        return 10.0 * np.log10(bands + 1e-12)

    def _cells(self, db: np.ndarray) -> str:
        t = np.clip((db - _DB_LO) / (_DB_HI - _DB_LO), 0.0, 1.0)
        idx = (t * (len(_RAMP) - 1)).astype(int)
        return "".join(f"\x1b[48;5;{_RAMP[i]}m " for i in idx) + "\x1b[0m"

    def header(self) -> str:
        w = self.bands
        lo = f"noisy [{_DB_LO:.0f}..{_DB_HI:.0f} dB]".center(w)[:w]
        hi = "enhanced".center(w)[:w]
        return f"{lo}|{hi}"

    def render_line(self, noisy_frame: np.ndarray,
                    enhanced_frame: np.ndarray) -> str:
        """One ANSI line for one aligned frame pair (exposed for tests)."""
        return (self._cells(self._band_db(noisy_frame)) + "|" +
                self._cells(self._band_db(enhanced_frame)))

    # -------------------------------------------------------------- #

    def feed(self, noisy: np.ndarray, enhanced: np.ndarray) -> int:
        """Buffer aligned chunks; print a line per complete hop.

        Returns the number of lines printed.
        """
        self._buf[0] = np.concatenate([self._buf[0], noisy.ravel()])
        self._buf[1] = np.concatenate([self._buf[1], enhanced.ravel()])
        if not self._header_done:
            print(self.header(), file=self._out)
            self._header_done = True
        printed = 0
        # require max(n_fft, hop) buffered so the hop-advance below always
        # consumes a FULL hop: with hop > n_fft, advancing a shorter buffer
        # would silently drop the deficit and the line rate would depend on
        # the caller's feed chunk size instead of being one line per hop
        need = max(self.n_fft, self.hop)
        while (self._buf[0].shape[0] >= need
               and self._buf[1].shape[0] >= need):
            line = self.render_line(self._buf[0][: self.n_fft],
                                    self._buf[1][: self.n_fft])
            print(line, file=self._out)
            self._buf[0] = self._buf[0][self.hop:]
            self._buf[1] = self._buf[1][self.hop:]
            printed += 1
        return printed
