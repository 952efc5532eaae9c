"""Audio file I/O (own copy of ``dpdfnet_tpu.audio_io``).

A NumPy RIFF/WAVE reader and writer (PCM 8/16/24/32, IEEE float 32/64,
any channel count) that writes the same bytes as the JAX package's
writer; ``soundfile`` for FLAC / OGG / AIFF / AU and ``pydub`` or an
``ffmpeg`` binary for compressed containers, each only where it is
installed.  PCM16 and float32 WAV files are read, and float audio is
written as PCM16, by the native C++ codec (``native.py``) where it builds,
with the same samples and bytes as the NumPy forms.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np

_SF_EXTENSIONS = frozenset({".flac", ".ogg", ".aiff", ".aif", ".au", ".snd"})
_WAV_EXTENSIONS = frozenset({".wav", ".wave"})
# Compressed containers, decoded by pydub or an ffmpeg binary where either
# is available.
_FFMPEG_EXTENSIONS = frozenset({".mp3", ".m4a", ".aac", ".wma", ".opus"})
SUPPORTED_EXTENSIONS = _WAV_EXTENSIONS | _SF_EXTENSIONS | _FFMPEG_EXTENSIONS

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file -> (float32 samples [S] or [S, C], sample_rate).
    The native decoder reads PCM16 and float32 where it builds; NumPy reads
    the rest."""
    from . import native

    got = native.wav_read(path)
    if got is not None:
        return got
    data = Path(path).read_bytes()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"Not a RIFF/WAVE file: {path}")

    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        cid = data[pos: pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        if pos + 8 + size > len(data):
            # size field runs past EOF: truncated/corrupt file.  Refuse
            # rather than decode silently shortened audio.
            raise ValueError(
                f"Truncated WAVE file {path}: chunk {cid!r} claims {size} "
                f"bytes but only {len(data) - pos - 8} remain")
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            if size < 16:
                raise ValueError(
                    f"Malformed WAVE file {path}: fmt chunk is {size} bytes "
                    f"(needs >= 16)")
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            if fmt[0] == _WAVE_FORMAT_EXTENSIBLE and size >= 40:
                sub = struct.unpack_from("<H", body, 24)[0]
                fmt = (sub,) + fmt[1:]
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)

    if fmt is None or payload is None:
        raise ValueError(f"Missing fmt/data chunk in WAVE file: {path}")
    wformat, channels, sr, _, _, bits = fmt
    bytes_per = max(1, bits // 8)
    if len(payload) % (bytes_per * max(1, channels)):
        raise ValueError(
            f"Malformed WAVE file {path}: data chunk ({len(payload)} bytes) "
            f"is not a whole number of {channels}-channel {bits}-bit frames")

    if wformat == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(payload, np.uint8).reshape(-1, 3)
            ints = (raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            x = ints.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(payload, "<i4").astype(np.float32) / float(1 << 31)
        elif bits == 8:
            x = (np.frombuffer(payload, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"Unsupported PCM bit depth: {bits}")
    elif wformat == _WAVE_FORMAT_IEEE_FLOAT:
        x = np.frombuffer(payload, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"Unsupported WAVE format tag: {wformat:#x}")

    if channels > 1:
        x = x.reshape(-1, channels)
    return x, int(sr)


def write_wav(
    path: Union[str, Path],
    audio: np.ndarray,
    sample_rate: int,
    *,
    subtype: str = "PCM_16",
) -> None:
    """Write float32 audio ([S] or [S, C]) as PCM_16 or FLOAT wav; int16
    input is written as it is."""
    x = np.asarray(audio)
    if subtype == "PCM_16" and x.dtype != np.int16:
        from . import native

        if native.wav_write(path, np.asarray(x, np.float32), sample_rate):
            return
    channels = 1 if x.ndim == 1 else x.shape[1]
    if subtype == "PCM_16":
        if x.dtype != np.int16:
            x = np.clip(x.astype(np.float32), -1.0, 1.0)
            x = (x * 32767.0).astype("<i2")
        payload = x.astype("<i2").tobytes()
        wformat, bits = _WAVE_FORMAT_PCM, 16
    elif subtype == "FLOAT":
        payload = x.astype("<f4").tobytes()
        wformat, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    else:
        raise ValueError(f"Unsupported subtype: {subtype}")

    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    fmt = struct.pack("<HHIIHH", wformat, channels, int(sample_rate),
                      byte_rate, block_align, bits)
    out = b"".join([
        b"RIFF", struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload)), b"WAVE",
        b"fmt ", struct.pack("<I", len(fmt)), fmt,
        b"data", struct.pack("<I", len(payload)), payload,
    ])
    Path(path).write_bytes(out)


def read_audio(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Read any supported audio file -> (float32 samples, sample_rate)."""
    p = Path(path)
    suffix = p.suffix.lower()
    if suffix in _WAV_EXTENSIONS:
        return read_wav(p)
    if suffix in _SF_EXTENSIONS:
        try:
            import soundfile as sf
        except ImportError:
            raise ImportError(
                f"Reading {suffix!r} requires the optional 'soundfile' package; "
                f"convert to .wav or install soundfile."
            ) from None
        audio, sr = sf.read(str(p), always_2d=False)
        return np.asarray(audio, dtype=np.float32), int(sr)
    if suffix in _FFMPEG_EXTENSIONS:
        return _read_compressed(p, suffix)
    supported = ", ".join(sorted(SUPPORTED_EXTENSIONS))
    raise ValueError(
        f"Unsupported audio format {suffix!r} for file: {p}\n"
        f"Supported extensions: {supported}"
    )


def _read_compressed(p: Path, suffix: str) -> Tuple[np.ndarray, int]:
    """Decode mp3/m4a/aac/wma/opus through pydub, else through an ffmpeg
    binary on PATH."""
    try:
        from pydub import AudioSegment
    except ImportError:
        pass
    else:
        seg = AudioSegment.from_file(str(p))
        sr = int(seg.frame_rate)
        samples = np.array(seg.get_array_of_samples(), dtype=np.float32)
        samples /= float(1 << (seg.sample_width * 8 - 1))
        if seg.channels > 1:
            samples = samples.reshape(-1, seg.channels)
        return samples, sr

    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise ImportError(
            f"Reading {suffix!r} files requires either the 'pydub' package "
            f"(with ffmpeg) or an 'ffmpeg' binary on PATH.\n"
            f"Install one of them, or convert the file to .wav/.flac."
        ) from None
    # -map 0:a:0 pins decoding to the first audio stream, so for files with
    # several audio streams the stdout payload and the parsed stream line
    # cannot disagree.
    probe = subprocess.run(
        [ffmpeg, "-hide_banner", "-i", str(p), "-map", "0:a:0",
         "-f", "f32le", "-acodec", "pcm_f32le", "-"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, check=False)
    if probe.returncode != 0:
        raise ValueError(
            f"ffmpeg failed to decode {p}: "
            f"{probe.stderr.decode('utf-8', 'replace')[-500:]}")
    # Rate/layout of the decoded payload: parse the *output* stream line
    # (which describes exactly what was written to stdout), falling back to
    # the whole stderr if ffmpeg's section header ever changes.
    import re

    _, _, out_section = probe.stderr.partition(b"Output #0")
    m = re.search(rb"(\d+) Hz, ([^,]+),", out_section or probe.stderr)
    if m is None:
        raise ValueError(f"could not parse ffmpeg stream info for {p}")
    sr = int(m.group(1))
    layout = m.group(2).decode().strip()
    channels = _ffmpeg_layout_channels(layout)
    if channels is None:
        raise ValueError(
            f"unrecognised ffmpeg channel layout {layout!r} for {p}; "
            f"convert the file to wav/flac or install pydub.")
    samples = np.frombuffer(probe.stdout, dtype="<f4").astype(np.float32)
    if channels > 1:
        samples = samples[: len(samples) - len(samples) % channels]
        samples = samples.reshape(-1, channels)
    return samples, sr


def _ffmpeg_layout_channels(layout: str):
    """Channel count from an ffmpeg stream-info layout token.

    ffmpeg prints either ``N channels``, a simple name (``mono``,
    ``stereo``, ``quad``), or a dotted layout (``5.1``, ``7.1(wide)``,
    ``2.1``) whose channel count is the sum of its parts.  Returns None
    for anything unrecognised (callers fail loudly rather than deinterleave
    with a guessed count).
    """
    import re

    named = {"mono": 1, "stereo": 2, "downmix": 2, "quad": 4,
             "quad(side)": 4, "hexagonal": 6, "octagonal": 8}
    base = layout.split("(", 1)[0].strip()
    if layout in named:
        return named[layout]
    if base in named:
        return named[base]
    m = re.match(r"(\d+)\s+channels?$", layout)
    if m:
        return int(m.group(1))
    m = re.match(r"(\d+)\.(\d+)$", base)
    if m:
        return int(m.group(1)) + int(m.group(2))
    return None
