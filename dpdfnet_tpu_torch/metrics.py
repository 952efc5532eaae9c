"""Speech-quality metrics and evaluation (own copy of ``dpdfnet_tpu.metrics``).

FFT cross-correlation alignment with trimming, SI-SNR, STOI and WB-PESQ,
and a CSV-driven batch evaluator (``enhanced_path``, ``clean_path``
columns -> results.csv).  Host-side NumPy throughout.

STOI is implemented here (Taal et al. 2010: 10 kHz, 1/3-octave bands,
384 ms envelope segments, -15 dB SDR clipping); ``pystoi`` is used
instead where it imports, and WB-PESQ needs the ``pesq`` package.  No
optional package is imported at module top.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import numpy as np

TARGET_SR = 16000


# --------------------------------------------------------------------------- #
# SI-SNR + alignment
# --------------------------------------------------------------------------- #

def si_snr(ref: np.ndarray, est: np.ndarray, eps: float = 1e-8) -> float:
    """Scale-invariant SNR in dB (DC removed), si_snr(ref, est)."""
    ref = np.asarray(ref, np.float64)
    est = np.asarray(est, np.float64)
    ref = ref - ref.mean()
    est = est - est.mean()
    ref_energy = np.sum(ref ** 2) + eps
    alpha = np.dot(est, ref) / ref_energy
    s_target = alpha * ref
    e_noise = est - s_target
    return float(10.0 * np.log10(
        (np.sum(s_target ** 2) + eps) / (np.sum(e_noise ** 2) + eps)))


def align_by_xcorr_trim(
    a: np.ndarray, b: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Align two 1-D signals by FFT cross-correlation; returns trimmed
    (a_aligned, b_aligned, lag) with lag > 0 meaning 'a' lags 'b'."""
    from scipy.signal import correlate

    # correlate(a, b, 'full')[i] pairs a[n] with b[n - (i - (len(b)-1))],
    # so the peak index maps to the delay of `a` relative to `b` directly —
    # no long/short bookkeeping needed.
    corr = correlate(np.asarray(a, np.float64), np.asarray(b, np.float64),
                     mode="full", method="fft")
    lag = int(np.argmax(corr)) - (len(b) - 1)

    off_a, off_b = max(lag, 0), max(-lag, 0)
    overlap = min(len(a) - off_a, len(b) - off_b)
    if overlap <= 0:
        n = min(len(a), len(b))
        return a[:n].astype(np.float32), b[:n].astype(np.float32), 0
    return (a[off_a: off_a + overlap].astype(np.float32),
            b[off_b: off_b + overlap].astype(np.float32), lag)


# --------------------------------------------------------------------------- #
# STOI (implemented here; pystoi preferred when present)
# --------------------------------------------------------------------------- #

_STOI_SR = 10000
_STOI_NFFT = 512
_STOI_WIN = 256
_STOI_HOP = 128
_STOI_NBANDS = 15
_STOI_MINFREQ = 150.0
_STOI_N = 30            # frames per envelope segment (384 ms)
_STOI_BETA = -15.0      # SDR clipping (dB)
_STOI_DYN_RANGE = 40.0  # silent-frame removal threshold (dB)


def _thirdoct_matrix(sr: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, sr, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    cf = min_freq * (2.0 ** (k / 3.0))
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_i = int(np.argmin((f - lo[i]) ** 2))
        hi_i = int(np.argmin((f - hi[i]) ** 2))
        obm[i, lo_i:hi_i] = 1.0
    return obm


def _stft_mag(x: np.ndarray) -> np.ndarray:
    win = np.hanning(_STOI_WIN + 2)[1:-1]
    n = (len(x) - _STOI_WIN) // _STOI_HOP + 1
    if n <= 0:
        return np.zeros((0, _STOI_NFFT // 2 + 1))
    idx = np.arange(n)[:, None] * _STOI_HOP + np.arange(_STOI_WIN)[None, :]
    frames = x[idx] * win
    return np.abs(np.fft.rfft(frames, n=_STOI_NFFT, axis=-1))


def _remove_silent_frames(x, y):
    win = np.hanning(_STOI_WIN + 2)[1:-1]
    n = (len(x) - _STOI_WIN) // _STOI_HOP + 1
    idx = np.arange(n)[:, None] * _STOI_HOP + np.arange(_STOI_WIN)[None, :]
    xf = x[idx] * win
    energy = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    mask = energy > (energy.max() - _STOI_DYN_RANGE)
    xr = np.zeros_like(x)
    yr = np.zeros_like(y)
    pos = 0
    for i in np.nonzero(mask)[0]:
        s = i * _STOI_HOP
        xr[pos: pos + _STOI_WIN] += xf[i]
        yr[pos: pos + _STOI_WIN] += y[idx[i]] * win
        pos += _STOI_HOP
    return xr[: pos + _STOI_WIN - _STOI_HOP], yr[: pos + _STOI_WIN - _STOI_HOP]


def stoi(clean: np.ndarray, degraded: np.ndarray, sr: int,
         extended: bool = False) -> float:
    """Short-Time Objective Intelligibility (Taal et al. 2010).

    Delegates to pystoi when it is installed; otherwise this
    implementation is used.
    """
    try:
        from pystoi.stoi import stoi as _pystoi

        return float(_pystoi(clean, degraded, sr, extended=extended))
    except ImportError:
        pass
    if extended:
        raise NotImplementedError(
            "extended STOI requires the optional 'pystoi' package")

    from .audio import resample

    x = np.asarray(clean, np.float64)
    y = np.asarray(degraded, np.float64)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    if sr != _STOI_SR:
        x = resample(x, sr, _STOI_SR).astype(np.float64)
        y = resample(y, sr, _STOI_SR).astype(np.float64)

    x, y = _remove_silent_frames(x, y)
    X = _stft_mag(x)
    Y = _stft_mag(y)
    if X.shape[0] < _STOI_N:
        raise ValueError("signal too short for STOI (needs >= 384 ms speech)")

    obm = _thirdoct_matrix(_STOI_SR, _STOI_NFFT, _STOI_NBANDS, _STOI_MINFREQ)
    Xb = np.sqrt((X ** 2) @ obm.T)         # [T, bands]
    Yb = np.sqrt((Y ** 2) @ obm.T)

    c = 10.0 ** (-_STOI_BETA / 20.0)
    d_sum = 0.0
    count = 0
    for m in range(_STOI_N, Xb.shape[0] + 1):
        xs = Xb[m - _STOI_N: m]            # [N, bands]
        ys = Yb[m - _STOI_N: m]
        alpha = np.sqrt(
            np.sum(xs ** 2, axis=0) / (np.sum(ys ** 2, axis=0) + 1e-12))
        ys_n = ys * alpha
        ys_c = np.minimum(ys_n, xs * (1.0 + c))
        xm = xs - xs.mean(axis=0)
        ym = ys_c - ys_c.mean(axis=0)
        num = np.sum(xm * ym, axis=0)
        den = (np.linalg.norm(xm, axis=0) * np.linalg.norm(ym, axis=0) + 1e-12)
        d_sum += float(np.sum(num / den))
        count += _STOI_NBANDS
    return d_sum / max(count, 1)


# --------------------------------------------------------------------------- #
# PESQ (external dependency only)
# --------------------------------------------------------------------------- #

def wb_pesq(clean: np.ndarray, degraded: np.ndarray, sr: int) -> float:
    """Wide-band PESQ via the optional ITU reference 'pesq' package."""
    try:
        from pesq import pesq as _pesq
    except ImportError:
        raise ImportError(
            "WB-PESQ requires the optional 'pesq' package (ITU-T P.862 "
            "reference implementation); install it or use SI-SNR/STOI."
        ) from None
    return float(_pesq(sr, clean, degraded, "wb"))


# --------------------------------------------------------------------------- #
# CSV-driven evaluator
# --------------------------------------------------------------------------- #

def _to_mono_f(x: np.ndarray) -> np.ndarray:
    if x.ndim == 1:
        return x.astype(np.float32)
    return np.mean(x, axis=1).astype(np.float32)


def load_audio_mono_16k(path: str, target_sr: int = TARGET_SR) -> np.ndarray:
    from .audio import resample
    from .audio_io import read_audio

    data, sr = read_audio(path)
    arr = np.asarray(data)
    if np.issubdtype(arr.dtype, np.integer):
        # integers rescale before the float cast in _to_mono_f (read_audio
        # returns float32; this guards a raw-PCM reader)
        arr = arr.astype(np.float32) / np.iinfo(arr.dtype).max
    data = _to_mono_f(arr)
    data = np.clip(data, -1.0, 1.0)
    if sr != target_sr:
        data = resample(data, sr, target_sr)
    return data.astype(np.float32)


def evaluate_csv(csv_path: str, out_path: Optional[str] = None) -> str:
    """Align + score (SI-SNR, STOI, WB-PESQ) per CSV row; writes results.csv."""
    import pandas as pd

    meta_path = os.path.abspath(csv_path)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"metadata CSV not found: {meta_path}")
    base_dir = os.path.dirname(meta_path)
    if out_path is None:
        out_path = os.path.join(base_dir, "results.csv")
    elif not os.path.isabs(out_path) and os.path.dirname(out_path) == "":
        out_path = os.path.join(base_dir, out_path)

    df = pd.read_csv(meta_path)
    required = {"enhanced_path", "clean_path"}
    if not required.issubset(df.columns):
        raise ValueError(f"CSV must contain columns: {required}")

    def resolve(p: str) -> str:
        return p if os.path.isabs(p) else os.path.normpath(
            os.path.join(base_dir, p))

    results = []
    for _, row in df.iterrows():
        rec = dict(
            enhanced_path=str(row["enhanced_path"]),
            clean_path=str(row["clean_path"]),
            aligned_lag_samples=np.nan, overlap_seconds=np.nan,
            si_snr_db=np.nan, stoi=np.nan, wb_pesq=np.nan, error="",
        )
        try:
            enh = load_audio_mono_16k(resolve(rec["enhanced_path"]))
            cln = load_audio_mono_16k(resolve(rec["clean_path"]))
            if len(enh) == 0 or len(cln) == 0:
                raise ValueError("Empty audio after load/resample")
            cln_al, enh_al, lag = align_by_xcorr_trim(cln, enh)
            rec["aligned_lag_samples"] = int(lag)
            rec["overlap_seconds"] = round(len(cln_al) / TARGET_SR, 6)
            if len(cln_al) < TARGET_SR // 2:
                raise ValueError("Aligned overlap too short for metrics (<0.5 s).")
            rec["si_snr_db"] = round(si_snr(cln_al, enh_al), 6)
            rec["stoi"] = stoi(cln_al, enh_al, TARGET_SR)
            try:
                rec["wb_pesq"] = wb_pesq(cln_al, enh_al, TARGET_SR)
            except ImportError:
                rec["error"] = "pesq package not installed (wb_pesq skipped)"
        except Exception as e:  # noqa: BLE001 — per-row error reporting
            rec["error"] = f"{type(e).__name__}: {e}"
        results.append(rec)

    out_df = pd.DataFrame(results, columns=[
        "enhanced_path", "clean_path", "aligned_lag_samples",
        "overlap_seconds", "si_snr_db", "stoi", "wb_pesq", "error"])
    out_df.to_csv(out_path, index=False)
    return out_path


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Align enhanced/clean audio via cross-correlation, then "
                    "compute SI-SNR, STOI and WB-PESQ over the overlap.")
    parser.add_argument("csv", help="CSV with enhanced_path and clean_path columns")
    parser.add_argument("--out", default=None,
                        help="Output CSV (default: results.csv next to input)")
    args = parser.parse_args(argv)
    try:
        out = evaluate_csv(args.csv, args.out)
    except Exception as exc:  # noqa: BLE001
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    print(f"Wrote results to: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
