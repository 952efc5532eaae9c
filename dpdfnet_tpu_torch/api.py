"""High-level offline API (counterpart of ``dpdfnet_tpu.api``):
``enhance`` / ``enhance_batch`` / ``enhance_file`` / ``download`` /
``available_models``.

Models are resolved by name through the zoo and built into a cached
``Engine`` per (model, checkpoint, quality tier, device).  Every entry
point takes ``device=None``, which means ``cuda`` and raises when no GPU
is present; pass ``device="cpu"`` for the plain PyTorch path.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .audio_io import read_audio as _read_audio
from .utils.device import DeviceLike, resolve_device
from .zoo import (
    DEFAULT_MODEL,
    available_model_entries,
    download_model,
    download_models,
    load_model_params,
    resolve_model,
)

_ENGINE_CACHE: Dict[str, object] = {}
_ENGINE_LOCK = threading.Lock()
_ENGINE_BUILD_LOCKS: Dict[str, threading.Lock] = {}


def available_models() -> List[Dict[str, Any]]:
    return available_model_entries()


def download(
    model: Optional[str] = None,
    *,
    force: bool = False,
    quiet: bool = False,
    verbose: bool = False,
) -> Union[Path, Dict[str, Path]]:
    if quiet and verbose:
        raise ValueError("quiet=True and verbose=True are mutually exclusive.")
    notifier = (lambda _message: None) if quiet else None
    if model is None:
        resolved_all = download_models(
            models=None, force=force, verbose=verbose, notifier=notifier)
        return {item.info.name: item.params_path.parent for item in resolved_all}
    resolved = download_model(
        model=model, force=force, verbose=verbose, notifier=notifier)
    return resolved.params_path.parent


def clear_engine_cache() -> None:
    """Drop every cached engine (their weights stay alive while a caller
    holds the engine)."""
    with _ENGINE_LOCK:
        _ENGINE_CACHE.clear()
        _ENGINE_BUILD_LOCKS.clear()


def _get_engine(
    model: str,
    checkpoint_path: Optional[Union[str, Path]] = None,
    verbose: bool = False,
    quality: str = "high",
    device: DeviceLike = None,
):
    """Build (and cache) an Engine for a model, quality tier and device.

    Per-key build locks: a build can include a download, which must not
    stall callers of other, cached models; the global lock guards only the
    cache and lock-registry lookups."""
    from .runtime.engine import engine_from_quality

    dev = resolve_device(device)
    key = f"{model}:{checkpoint_path}:{quality}:{dev}"
    with _ENGINE_LOCK:
        eng = _ENGINE_CACHE.get(key)
        if eng is not None:
            return eng
        build_lock = _ENGINE_BUILD_LOCKS.setdefault(key, threading.Lock())
    with build_lock:
        with _ENGINE_LOCK:
            eng = _ENGINE_CACHE.get(key)
            if eng is not None:
                return eng
        resolved = resolve_model(model=model, checkpoint_path=checkpoint_path,
                                 auto_download=True, verbose=verbose)
        params = load_model_params(resolved, device=dev)
        eng = engine_from_quality(resolved.cfg, params, quality, device=dev)
        with _ENGINE_LOCK:
            _ENGINE_CACHE[key] = eng
        return eng


def enhance(
    audio: np.ndarray,
    sample_rate: int,
    *,
    model: str = DEFAULT_MODEL,
    checkpoint_path: Optional[Union[str, Path]] = None,
    attn_limit_db: Optional[float] = None,
    quality: str = "high",
    verbose: bool = False,
    progress_callback: Optional[Callable[[int, int], None]] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Enhance one utterance; returns float32 audio at the input sample rate.

    ``quality`` selects the tier (``runtime.engine.QUALITY_TIERS``):
    ``highest`` / ``high`` float32, ``fast`` TF32 GEMMs and convs,
    ``turbo`` bfloat16 activations.  With ``progress_callback(done,
    total)`` the engine runs segment by segment and reports after each
    one (the same output)."""
    from .audio import ensure_sample_rate, fit_length, to_mono

    waveform = to_mono(np.asarray(audio, dtype=np.float32))
    sr_in = int(sample_rate)
    engine = _get_engine(model, checkpoint_path, verbose, quality, device)
    cfg = engine.cfg
    x = ensure_sample_rate(waveform, sr_in, cfg.sample_rate)
    y = engine.enhance_waveforms(x, attn_limit_db=attn_limit_db,
                                 progress_callback=progress_callback)
    out = ensure_sample_rate(y, cfg.sample_rate, sr_in)
    return fit_length(out, waveform.shape[0]).astype(np.float32, copy=False)


def enhance_batch(
    audios: List[np.ndarray],
    sample_rates: Union[int, List[int]],
    *,
    model: str = DEFAULT_MODEL,
    checkpoint_path: Optional[Union[str, Path]] = None,
    attn_limit_db: Optional[float] = None,
    quality: str = "high",
    verbose: bool = False,
    device: DeviceLike = None,
) -> List[np.ndarray]:
    """Enhance many utterances in one padded batch (the throughput path)."""
    from .audio import ensure_sample_rate, fit_length, to_mono

    if isinstance(sample_rates, bool):
        raise TypeError("sample_rates must be an int or a list of ints")
    if isinstance(sample_rates, (int, np.integer)):
        sample_rates = [int(sample_rates)] * len(audios)
    if len(sample_rates) != len(audios):
        raise ValueError("sample_rates must match audios length")

    engine = _get_engine(model, checkpoint_path, verbose, quality, device)
    cfg = engine.cfg
    monos = [to_mono(np.asarray(a, dtype=np.float32)) for a in audios]
    at_sr = [ensure_sample_rate(m, int(sr), cfg.sample_rate)
             for m, sr in zip(monos, sample_rates)]
    if not at_sr:
        return []
    S = max(a.shape[0] for a in at_sr)
    batch = np.zeros((len(at_sr), S), np.float32)
    for i, a in enumerate(at_sr):
        batch[i, : a.shape[0]] = a
    lengths = np.array([a.shape[0] for a in at_sr])
    y = engine.enhance_waveforms(batch, attn_limit_db=attn_limit_db, lengths=lengths)
    outs = []
    for i, (m, sr) in enumerate(zip(monos, sample_rates)):
        o = ensure_sample_rate(y[i, : lengths[i]], cfg.sample_rate, int(sr))
        outs.append(fit_length(o, m.shape[0]).astype(np.float32, copy=False))
    return outs


def enhance_file(
    input_path: Union[str, Path],
    output_path: Optional[Union[str, Path]] = None,
    *,
    model: str = DEFAULT_MODEL,
    checkpoint_path: Optional[Union[str, Path]] = None,
    attn_limit_db: Optional[float] = None,
    quality: str = "high",
    verbose: bool = False,
    progress_callback: Optional[Callable[[int, int], None]] = None,
    device: DeviceLike = None,
) -> Path:
    """Enhance one audio file into a 16-bit wav (default
    ``<stem>_enhanced.wav`` beside the input); returns the output path."""
    from .audio import pcm16_safe
    from .audio_io import write_wav

    in_path = Path(input_path).expanduser().resolve()
    if not in_path.is_file():
        raise FileNotFoundError(f"Input file not found: {in_path}")

    audio, sr = _read_audio(in_path)
    enhanced = enhance(
        audio=audio, sample_rate=int(sr), model=model,
        checkpoint_path=checkpoint_path, attn_limit_db=attn_limit_db,
        quality=quality, verbose=verbose,
        progress_callback=progress_callback, device=device,
    )
    if output_path is None:
        out_path = in_path.with_name(f"{in_path.stem}_enhanced.wav")
    else:
        out_path = Path(output_path).expanduser().resolve()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(out_path, pcm16_safe(enhanced), int(sr), subtype="PCM_16")
    return out_path
