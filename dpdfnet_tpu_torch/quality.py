"""Precision-tier deviation (counterpart of ``speechlike_test_signal`` and
``tier_deviation`` in ``dpdfnet_tpu.quality``).

``tier_deviation`` enhances a deterministic speech-shaped signal with each
quality tier and reports its deviation from the ``highest`` tier: max-abs, RMS
relative to the reference output, RMS relative to the input in dB, and
two perceptual proxies at 16 kHz, STOI (1.0 is transparent) and SI-SNR
in dB (``metrics.py``), as the JAX function does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .utils.device import DeviceLike


def speechlike_test_signal(seconds: float, sr: int, seed: int = 0,
                           batch: int = 1) -> np.ndarray:
    """Deterministic speech-shaped test input ``[batch, seconds * sr]``: a
    pitch-modulated harmonic stack (F0 about 120 Hz with vibrato, -12 dB
    per octave) in pink-ish noise at about -25 dBFS; the same numbers as
    the JAX package's function for the same arguments."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    out = np.zeros((batch, t.shape[0]), np.float32)
    for b in range(batch):
        f0 = 100.0 + 40.0 * rng.random() + 8.0 * np.sin(
            2 * np.pi * (2.0 + rng.random()) * t)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        sig = sum(np.sin(k * phase + rng.random() * 6.28) / k ** 1.5
                  for k in range(1, 13))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * (1.5 + rng.random()) * t) ** 2
        noise = np.cumsum(rng.normal(size=t.shape[0]))
        noise = noise - np.convolve(noise, np.ones(64) / 64.0, "same")
        noise /= max(1e-9, np.abs(noise).max())
        out[b] = (0.05 * sig * env + 0.01 * noise).astype(np.float32)
    return out


def tier_deviation(model: str = "dpdfnet8_48khz_hr", *, seconds: float = 4.0,
                   batch: int = 2, seed: int = 0, contract: Optional[float] = 0.7,
                   tiers=("high", "fast", "turbo"), params=None,
                   device: DeviceLike = None) -> dict:
    """Per-tier output deviation from the ``highest`` tier.

    Weights: ``params`` when given, else ``init_params(cfg, seed)``, with
    every >= 2-D weight rescaled to spectral norm ``contract`` (a trained
    checkpoint's stable dynamics rather than raw random init's).  Returns
    ``{"_ref_rms", "_input_rms", tier: {"rel_rms", "max_abs",
    "rms_vs_input_db", "stoi_vs_highest", "sisnr_vs_highest_db"}}``, the
    last two the mean over the batch of each utterance's STOI and SI-SNR
    against the ``highest`` output, both resampled to 16 kHz.  Runs on
    ``device`` (the card unless the CPU is asked for)."""
    from . import metrics
    from .audio import ensure_sample_rate
    from .config import get_config
    from .models.params import contract_params, init_params
    from .runtime.engine import engine_from_quality

    cfg = get_config(model)
    if params is None:
        params = init_params(cfg, seed=seed, device="cpu")
    if contract is not None:
        params = contract_params(params, factor=contract)
    wav = speechlike_test_signal(seconds, cfg.sample_rate, seed=seed, batch=batch)

    ref = engine_from_quality(cfg, params, "highest", device=device).enhance_waveforms(wav)
    ref_rms = float(np.sqrt(np.mean(ref ** 2)))
    in_rms = float(np.sqrt(np.mean(wav ** 2)))
    out = {"_ref_rms": ref_rms, "_input_rms": in_rms}
    ref16 = [ensure_sample_rate(r, cfg.sample_rate, 16000) for r in ref]
    for tier in tiers:
        y = engine_from_quality(cfg, params, tier, device=device).enhance_waveforms(wav)
        d = y - ref
        d_rms = float(np.sqrt(np.mean(d ** 2)))
        y16 = [ensure_sample_rate(yi, cfg.sample_rate, 16000) for yi in y]
        out[tier] = {
            "rel_rms": d_rms / max(ref_rms, 1e-12),
            "max_abs": float(np.abs(d).max()),
            "rms_vs_input_db": float(20.0 * np.log10(max(d_rms, 1e-12) / max(in_rms, 1e-12))),
            "stoi_vs_highest": float(np.mean([metrics.stoi(r, yi, 16000)
                                              for r, yi in zip(ref16, y16)])),
            "sisnr_vs_highest_db": float(np.mean([metrics.si_snr(r, yi)
                                                  for r, yi in zip(ref16, y16)])),
        }
    return out
