"""Quality gates (counterpart of ``dpdfnet_tpu.quality``).

- The reference-ONNX gate: ``enhance_reference_onnx`` runs the reference's
  exported streaming graph (``onnxruntime``) through the reference's own
  offline pipeline, and ``validate_vs_onnx`` scores the port and that graph
  on a noisy / clean corpus and fails when the PESQ delta exceeds its
  tolerance (``python -m dpdfnet_tpu_torch eval --vs-onnx``,
  ``python -m dpdfnet_tpu_torch.tools.validate_quality``).  It needs
  ``onnxruntime``, the reference's ``.onnx`` graph and, for the verdict,
  ``pesq``; nothing is downloaded.
- Precision-tier deviation: ``tier_deviation`` enhances a deterministic
  speech-shaped signal with each quality tier and reports its deviation
  from the ``highest`` tier: max-abs, RMS relative to the reference
  output, RMS relative to the input in dB, and two perceptual proxies at
  16 kHz, STOI (1.0 is transparent) and SI-SNR in dB (``metrics.py``), as
  the JAX function does.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .audio import ensure_sample_rate, to_mono
from .utils.device import DeviceLike


_ONNX_SESSIONS: dict = {}


def _onnx_session(onnx_path: str):
    """One CPU ``onnxruntime.InferenceSession`` per graph path, built once:
    loading and optimising a graph takes seconds, and the gate calls per
    corpus row.  Raises ``ImportError`` without ``onnxruntime``."""
    sess = _ONNX_SESSIONS.get(onnx_path)
    if sess is None:
        import onnxruntime as ort

        sess = ort.InferenceSession(onnx_path, providers=["CPUExecutionProvider"])
        _ONNX_SESSIONS[onnx_path] = sess
    return sess


def enhance_reference_onnx(audio: np.ndarray, sr: int, onnx_path: str,
                           model_sr: int) -> np.ndarray:
    """Enhance ``audio`` (at ``sr``) with the reference's exported streaming
    graph, in the reference's offline pipeline: resample to ``model_sr``,
    pad one window, reflect-padded ``center=True`` STFT, one session call
    per frame with the state the graph's metadata assembles (zeros, then
    the ERB and spectral norm inits), COLA iSTFT, a shift of ``2 *
    win_len`` samples, resample back and fit to the input's length.  The
    window is ``(F - 1) * 2`` for a graph whose input has a concrete
    frequency axis of F bins, else 20 ms of ``model_sr``.  The same NumPy
    operations in the same order as the JAX function, so the two agree
    bit for bit on one session.

    The shift of ``2 * win_len`` zero-fills the end of the window-padded
    signal, so the last ``win_len`` samples of the output are zeros.  The
    engine (``Engine.enhance_waveforms``, both packages) ends on the
    iSTFT's edge instead, so on the same model the two differ there (the
    engine's last sample is 3e-3 to 5e-3 on ``dpdfnet2``) and agree before
    it; ``validate_vs_onnx`` aligns each output to the clean signal by
    cross-correlation over the whole clip."""
    from .audio import fit_length, make_stft_config

    sess = _onnx_session(onnx_path)
    meta = sess.get_modelmeta().custom_metadata_map
    state = np.zeros(int(meta["state_size"]), np.float32)
    e = int(meta["erb_norm_state_size"])
    s = int(meta["spec_norm_state_size"])
    state[:e] = [float(v) for v in meta["erb_norm_init"].split(",")]
    state[e:e + s] = [float(v) for v in meta["spec_norm_init"].split(",")]

    x = ensure_sample_rate(to_mono(audio), sr, model_sr)
    win_len = int(round(model_sr * 0.02))
    in0 = sess.get_inputs()[0].shape
    if len(in0) >= 2 and isinstance(in0[-2], int) and in0[-2] > 1:
        win_len = (int(in0[-2]) - 1) * 2
    cfg = make_stft_config(win_len)
    xp = np.pad(x, (0, cfg.win_len))
    pad = cfg.win_len // 2
    xr = np.pad(xp, (pad, pad), mode="reflect")
    T = (len(xr) - cfg.win_len) // cfg.hop_size + 1
    idx = np.arange(T)[:, None] * cfg.hop_size + np.arange(cfg.win_len)
    spec = np.fft.rfft(xr[idx] * cfg.window, axis=-1)
    spec_ri = np.stack([spec.real, spec.imag], -1).astype(np.float32)[None]

    in_names = [i.name for i in sess.get_inputs()]
    out_names = [o.name for o in sess.get_outputs()]
    frames = []
    for t in range(T):
        o, state = sess.run(out_names[:2], {
            in_names[0]: spec_ri[:, t: t + 1], in_names[1]: state})
        frames.append(o)
    out = np.concatenate(frames, axis=1)[0]
    comp = out[..., 0] + 1j * out[..., 1]
    win = cfg.window
    yframes = np.fft.irfft(comp, n=cfg.win_len, axis=-1) * win
    total = cfg.win_len + cfg.hop_size * (T - 1)
    y = np.zeros(total)
    wss = np.zeros(total)
    w2 = win ** 2
    for t in range(T):
        y[t * cfg.hop_size: t * cfg.hop_size + cfg.win_len] += yframes[t]
        wss[t * cfg.hop_size: t * cfg.hop_size + cfg.win_len] += w2
    y = y / np.where(wss > 1e-11, wss, 1.0)
    y = y[pad: total - pad]
    y = np.concatenate([y[cfg.win_len * 2:], np.zeros(cfg.win_len * 2)])
    y = ensure_sample_rate(y.astype(np.float32), model_sr, sr)
    return fit_length(y, len(to_mono(audio)))


def validate_vs_onnx(csv_path: str, onnx_path: str, *, model: str = "dpdfnet8_48khz_hr",
                     out_csv: Optional[str] = None, pesq_tolerance: float = 0.01,
                     quality: str = "high", device: DeviceLike = None) -> int:
    """Score the port (``api.enhance`` of ``model`` at ``quality`` on
    ``device``; ``None`` is the card) and the reference graph
    (:func:`enhance_reference_onnx`) on a noisy / clean corpus; 0 iff the
    mean PESQ delta is within ``pesq_tolerance``, else 1 (also for an
    empty corpus).

    ``csv_path`` has ``noisy_path,clean_path`` columns, paths relative to
    the CSV.  Each output is resampled to 16 kHz, aligned to the clean
    signal by cross-correlation and scored (SI-SNR, STOI, WB-PESQ; a
    clip that PESQ rejects scores NaN).  Each metric is averaged over the
    rows that both systems scored, and the gate fails loudly when no row
    has a PESQ pair.  ``out_csv`` gets one row per clip.  The CSV columns
    and printed tags are the JAX package's, ``*_tpu`` for this package
    and ``*_onnx`` for the reference, so both packages' results compare
    column for column.

    The session is built before the corpus is read, so a missing
    ``onnxruntime`` or graph fails before any clip is enhanced."""
    import csv as csv_mod

    from . import api, metrics
    from .audio_io import read_audio
    from .zoo import get_model_info

    _onnx_session(onnx_path)
    model_sr = get_model_info(model).sample_rate
    base = os.path.dirname(os.path.abspath(csv_path))
    with open(csv_path, newline="") as f:
        corpus = list(csv_mod.DictReader(f))
    if not corpus:
        print("empty corpus CSV")
        return 1

    rows = []
    for row in corpus:
        noisy, sr = read_audio(os.path.join(base, row["noisy_path"]))
        clean = metrics.load_audio_mono_16k(os.path.join(base, row["clean_path"]))
        ours = api.enhance(noisy, sr, model=model, quality=quality, device=device)
        ref = enhance_reference_onnx(noisy, sr, onnx_path, model_sr)

        rec = {"noisy_path": row["noisy_path"]}
        for tag, out in (("tpu", ours), ("onnx", ref)):
            x = ensure_sample_rate(to_mono(out), sr, 16000)
            c_al, x_al, _ = metrics.align_by_xcorr_trim(clean, x)
            rec[f"sisnr_{tag}"] = metrics.si_snr(c_al, x_al)
            rec[f"stoi_{tag}"] = metrics.stoi(c_al, x_al, 16000)
            try:
                rec[f"pesq_{tag}"] = metrics.wb_pesq(c_al, x_al, 16000)
            except Exception:  # noqa: BLE001
                # no pesq package, or a clip it rejects (NoUtterancesError
                # on near-silent audio): NaN, which the gate below reads
                rec[f"pesq_{tag}"] = float("nan")
        rows.append(rec)

    if out_csv:
        with open(out_csv, "w", newline="") as f:
            w = csv_mod.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)

    deltas = {}
    for m in ("pesq", "stoi", "sisnr"):
        # only rows both systems scored: a PESQ failure can hit one
        # system's output and not the other's
        a = np.array([r[f"{m}_tpu"] for r in rows], np.float64)
        b = np.array([r[f"{m}_onnx"] for r in rows], np.float64)
        both = np.isfinite(a) & np.isfinite(b)
        if both.any():
            ours_m, ref_m = float(a[both].mean()), float(b[both].mean())
        else:
            ours_m = ref_m = float("nan")
        deltas[m] = ours_m - ref_m
        print(f"{m}: tpu {ours_m:.4f}  onnx {ref_m:.4f}  delta {deltas[m]:+.4f}")
    if np.isnan(deltas["pesq"]):
        print("FAIL: PESQ unavailable (install the ITU 'pesq' package, or "
              "every clip was rejected by it) — the PESQ gate cannot be "
              "evaluated")
        return 1
    if abs(deltas["pesq"]) > pesq_tolerance:
        print(f"FAIL: |PESQ delta| {abs(deltas['pesq']):.4f} > {pesq_tolerance}")
        return 1
    print("PASS")
    return 0


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
