"""Standalone consumer of an exported streaming artifact (the port's
counterpart of ``examples/consume_stablehlo.py``).

    python -m dpdfnet_tpu_torch.tools.consume_exported <artifact.stream.pt2> <in.wav> <out.wav>

A ``<model>.stream.pt2`` artifact (``dpdfnet_tpu_torch.export.export_stream``)
plus its JSON sidecar is a complete deployment contract: this script runs
it with ``torch``, ``numpy`` and the standard library, and imports of the
package only ``dpdfnet_tpu_torch.ops.gru_kernels``, which registers the
kernel ops (``torch.ops.dpdfnet.*``) the artifact's graph calls, as a
StableHLO artifact needs jaxlib's runtime for its kernels.  No model code,
no weights file.  Everything else comes from the artifact and the sidecar:

  - the streaming step (spec [1,1,F,2], state [1,S]) -> (out, state);
  - state_size and the EMA-norm init segments -> the initial state;
  - n_fft / hop / wnorm / sample_rate -> framing, windowing, scaling;
  - platforms -> the device the step runs on, precision -> the cuBLAS /
    cuDNN math it runs under (TF32 only under "default").

The last line printed lists the ``dpdfnet_tpu_torch`` modules the process
loaded.
"""

import json
import sys
import wave
from pathlib import Path

import numpy as np
import torch

import dpdfnet_tpu_torch.ops.gru_kernels  # noqa: F401  (registers torch.ops.dpdfnet.*)


def vorbis_window(n: int) -> np.ndarray:
    # sin(pi/2 * sin^2(pi (n+0.5) / N)), the model family's fixed window
    s = np.sin(np.pi * (np.arange(n) + 0.5) / n)
    return np.sin(0.5 * np.pi * s * s).astype(np.float32)


def initial_state(meta: dict) -> np.ndarray:
    state = np.zeros(int(meta["state_size"]), np.float32)
    offset = 0
    for key, size_key in (("erb_norm_init", "erb_norm_state_size"),
                          ("spec_norm_init", "spec_norm_state_size")):
        seg = np.array([float(v) for v in meta[key].split(",")], np.float32)
        n = int(meta[size_key])
        if seg.shape[0] != n:
            raise ValueError(f"{key}: {seg.shape[0]} values, {size_key} says {n}")
        state[offset: offset + n] = seg
        offset += n
    return state


def read_wav_mono(path: str):
    with wave.open(path, "rb") as w:
        sr, n, ch, width = w.getframerate(), w.getnframes(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported wav sample width: {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x.astype(np.float32), sr


def write_wav_mono(path: str, x: np.ndarray, sr: int) -> None:
    pcm = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def main(argv) -> int:
    if len(argv) != 4:
        print(__doc__)
        return 2
    artifact, in_wav, out_wav = argv[1], argv[2], argv[3]
    meta = json.loads(Path(artifact + ".json").read_text())
    step = torch.export.load(artifact).module()
    device = torch.device(meta["platforms"][0])
    tf32 = meta.get("precision", "high") == "default"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32

    win, hop, wnorm = int(meta["n_fft"]), int(meta["hop"]), float(meta["wnorm"])
    window = vorbis_window(win)
    audio, sr = read_wav_mono(in_wav)
    if sr != int(meta["sample_rate"]):
        raise SystemExit(f"input is {sr} Hz but the artifact expects {meta['sample_rate']} Hz: "
                         "resample first")
    if win != 2 * hop:
        raise SystemExit("this model family uses 50% overlap")

    state = torch.from_numpy(initial_state(meta))[None].to(device)       # [1, S]
    ola = np.zeros(hop, np.float32)
    committed = []
    n_frames = max(0, (audio.shape[0] - win) // hop + 1)
    with torch.no_grad():
        # causal streaming: one window in, one hop out, state carried
        for t in range(n_frames):
            spec = np.fft.rfft(audio[t * hop: t * hop + win] * window).astype(np.complex64)
            spec_in = np.stack([spec.real, spec.imag], -1)[None, None] * np.float32(wnorm)
            out, state = step(torch.from_numpy(spec_in.astype(np.float32)).to(device), state)
            out = out[0, 0].float().cpu().numpy() / wnorm                  # [F, 2]
            y = np.fft.irfft(out[:, 0] + 1j * out[:, 1], n=win).astype(np.float32) * window
            # Vorbis COLA at 50% overlap: the first hop is complete
            committed.append(y[:hop] + ola)
            ola = y[hop:].copy()
    enhanced = np.concatenate(committed) if committed else np.zeros(0, np.float32)
    write_wav_mono(out_wav, enhanced, sr)
    print(f"wrote {enhanced.shape[0]} samples to {out_wav} ({n_frames} frames on {device}, "
          f"state {state.shape[1]} floats)")
    print("modules " + json.dumps(sorted(m for m in sys.modules
                                          if m.startswith("dpdfnet_tpu_torch"))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
