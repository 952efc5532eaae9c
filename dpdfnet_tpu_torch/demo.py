"""Real-time enhancement demo (counterpart of ``dpdfnet_tpu.demo``), on
the port's ``StreamEnhancer``:

- **live mode** (needs the optional ``sounddevice`` package and audio
  hardware): microphone -> ``StreamEnhancer`` -> speakers, with a
  noisy / enhanced mix, attack / release output AGC, and the per-chunk
  inference-ms EMA printed in place;
- **file mode** (headless, when ``input_path`` is given): streams a wav
  through the enhancer in real-time-sized chunks and reports the same
  latency statistics and the real-time factor, without audio hardware or
  a display.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

# output AGC: target peak and attack / release rates, and the latency EMA
_AGC_TARGET = 0.3
_AGC_ATTACK = 0.35
_AGC_RELEASE = 0.02
_EMA_ALPHA = 0.9


class OutputAGC:
    """Simple attack/release automatic gain control on output chunks."""

    def __init__(self) -> None:
        self._gain = 1.0

    def __call__(self, chunk: np.ndarray) -> np.ndarray:
        peak = float(np.max(np.abs(chunk))) if chunk.size else 0.0
        if peak > 1e-6:
            desired = min(4.0, _AGC_TARGET / peak)
            rate = _AGC_ATTACK if desired < self._gain else _AGC_RELEASE
            self._gain += rate * (desired - self._gain)
        return np.clip(chunk * self._gain, -1.0, 1.0)


def _mix(noisy: np.ndarray, enhanced: np.ndarray, mix: float) -> np.ndarray:
    n = min(noisy.shape[0], enhanced.shape[0])
    return (1.0 - mix) * noisy[:n] + mix * enhanced[:n]


def run_demo(
    model: str = "dpdfnet2",
    input_path: Optional[Path] = None,
    output_path: Optional[Path] = None,
    mix: float = 1.0,
    chunk_ms: float = 10.0,
    verbose: bool = False,
    max_seconds: Optional[float] = None,
    spectrogram: bool = False,
    device=None,
) -> int:
    """Stream ``input_path`` (file mode) or the microphone (live mode)
    through a ``StreamEnhancer`` of ``model`` on ``device`` (``None``:
    cuda); returns the exit code."""
    from .stream import StreamEnhancer

    se = StreamEnhancer(model=model, verbose=verbose, device=device)
    sr = se._model_sr
    chunk = max(1, int(sr * chunk_ms / 1000.0))

    viz = None
    if spectrogram:
        from .termviz import TerminalSpectrogram

        # ~12 lines/s: window 32 ms, one line per ~80 ms of audio
        viz = TerminalSpectrogram(sr, n_fft=1 << max(9, (sr // 32000) + 9),
                                  hop=int(sr * 0.08))
    if input_path is None:
        return _run_live(se, sr, chunk, mix, viz)
    return _run_file(se, sr, chunk, mix, Path(input_path), output_path,
                     max_seconds, viz)


def _run_file(se, sr, chunk, mix, input_path: Path,
              output_path: Optional[Path], max_seconds, viz=None) -> int:
    from .audio import ensure_sample_rate, pcm16_safe, to_mono
    from .audio_io import read_audio, write_wav

    audio, in_sr = read_audio(input_path)
    x = ensure_sample_rate(to_mono(audio), in_sr, sr)
    if max_seconds is not None:
        x = x[: int(max_seconds * sr)]

    agc = OutputAGC()
    ema_ms = None
    outs = []
    # Delay the noisy branch by the model's in-line processing delay so
    # the mix is time-aligned with the enhanced output: streaming output
    # sample i is the enhanced input sample i - 4*hop (2-frame lookahead
    # + 2-frame DF delay).  The one-window analysis latency only delays
    # when samples emerge, not their place in the output timeline.
    align = 4 * se._hop_size
    noisy_delayed = np.concatenate([np.zeros(align, np.float32), x])
    consumed = 0

    def emit(enhanced):
        nonlocal consumed
        if not enhanced.size:
            return
        nz = noisy_delayed[consumed: consumed + enhanced.size]
        nz = np.pad(nz, (0, enhanced.size - nz.size))
        consumed += enhanced.size
        if viz is not None:
            viz.feed(nz, enhanced)
        outs.append(agc(_mix(nz, enhanced, mix)))

    t_start = time.perf_counter()
    for pos in range(0, len(x), chunk):
        t0 = time.perf_counter()
        enhanced = se.process(x[pos: pos + chunk])
        dt_ms = (time.perf_counter() - t0) * 1e3
        ema_ms = dt_ms if ema_ms is None else (
            _EMA_ALPHA * ema_ms + (1 - _EMA_ALPHA) * dt_ms)
        emit(enhanced)
    emit(se.flush())          # the tail gets the same mix/AGC/viz path
    wall = time.perf_counter() - t_start
    y = np.concatenate([o for o in outs if o.size]) if outs else np.zeros(0)

    audio_s = len(x) / sr
    ema_txt = "n/a" if ema_ms is None else f"{ema_ms:.2f} ms"
    print(f"streamed {audio_s:.2f}s in {wall:.2f}s "
          f"(RTF {audio_s / max(wall, 1e-9):.1f}x, "
          f"avg chunk inference {ema_txt}, "
          f"budget {1000.0 * chunk / sr:.1f} ms/chunk)")
    if output_path is not None:
        write_wav(output_path, pcm16_safe(y), sr)
        print(f"wrote: {output_path}")
    return 0


def _run_live(se, sr, chunk, mix, viz=None) -> int:
    try:
        import sounddevice as sd
    except ImportError:
        print(
            "Live mode requires the optional 'sounddevice' package and audio "
            "hardware; use `--input file.wav` for the headless file mode.",
            file=sys.stderr,
        )
        return 2

    agc = OutputAGC()
    state = {"ema": None, "backlog": np.zeros(0, np.float32)}

    def callback(indata, outdata, frames, time_info, status):
        t0 = time.perf_counter()
        enhanced = se.process(indata[:, 0].astype(np.float32))
        dt = (time.perf_counter() - t0) * 1e3
        state["ema"] = dt if state["ema"] is None else (
            _EMA_ALPHA * state["ema"] + (1 - _EMA_ALPHA) * dt)
        state["backlog"] = np.concatenate([state["backlog"], enhanced])
        out = np.zeros(frames, np.float32)
        n = min(frames, state["backlog"].shape[0])
        out[:n] = state["backlog"][:n]
        state["backlog"] = state["backlog"][n:]
        noisy = indata[:n, 0]
        if viz is not None and n:
            viz.feed(noisy, out[:n])
        mixed = agc(_mix(noisy, out[:n], mix)) if n else out[:0]
        outdata[:, 0] = 0.0
        outdata[: mixed.shape[0], 0] = mixed
        print(f"\rinference: {state['ema']:.2f} ms/chunk", end="",
              file=sys.stderr)

    with sd.Stream(samplerate=sr, blocksize=chunk, channels=1,
                   dtype="float32", callback=callback):
        print("live enhancement running — Ctrl-C to stop", file=sys.stderr)
        try:
            while True:
                time.sleep(0.5)
        except KeyboardInterrupt:
            print(file=sys.stderr)
    return 0
