"""ctypes bindings for the native host library (counterpart of
``dpdfnet_tpu.native``).

``csrc/dpdfnet_host.cpp`` holds the host side of the data path in C++:
WAV read and write, a polyphase resampler and the streaming overlap-add;
it is the port's own copy of the JAX package's ``native/dpdfnet_host.cpp``
(the same bytes, so both libraries run the same C++).  The port builds it
itself, on first use, with ``g++ -O3 -fPIC -std=c++17 -shared`` into
``utils.compile_cache.build_dir()`` (by default the
git-ignored ``dpdfnet_tpu_torch/_build/``), as ``libdpdfnet_host-<hash of
the source>.so``, so an edited source is rebuilt.  ``DPDFNET_TPU_NATIVE_LIB``
names a library to load instead; ``DPDFNET_TPU_NATIVE=0`` turns the
library off.  Every entry returns ``None`` (``wav_write``: ``False``) when
the library cannot be built or loaded, and its callers (``audio``,
``audio_io``, ``stream``) take their NumPy forms then.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .utils import compile_cache

SOURCE = Path(__file__).resolve().parent / "csrc" / "dpdfnet_host.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("bits", ctypes.c_int32),
        ("format", ctypes.c_int32),
        ("frames", ctypes.c_int64),
    ]


def lib_path() -> Path:
    """Where the library built from :data:`SOURCE` lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return compile_cache.build_dir() / f"libdpdfnet_host-{h.hexdigest()[:12]}.so"


def build() -> Optional[Path]:
    """Compile the library if it is missing; its path, or ``None`` when
    there is no source or no ``g++``, or the compiler fails."""
    if not SOURCE.is_file():
        return None
    out = lib_path()
    if out.is_file():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        rc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                            timeout=120).returncode
    except (OSError, subprocess.TimeoutExpired):
        rc = 1
    if rc != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded once per process; ``None`` when it is
    turned off or cannot be built or loaded."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("DPDFNET_TPU_NATIVE") in ("0", "false", "False"):
        return None
    env = os.environ.get("DPDFNET_TPU_NATIVE_LIB")
    path = Path(env) if env else build()
    if path is None or not path.is_file():
        return None
    try:
        lib = ctypes.CDLL(str(path))
        _bind(lib)
    except (OSError, AttributeError):
        # unloadable, or a library without one of the entries
        return None
    _LIB = lib
    return _LIB


def _bind(lib: ctypes.CDLL) -> None:
    """Declare every entry's signature (AttributeError on a missing one)."""
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.dpdfnet_resample_out_len.restype = ctypes.c_int64
    lib.dpdfnet_resample_out_len.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.dpdfnet_resample.restype = ctypes.c_int64
    lib.dpdfnet_resample.argtypes = [f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, f32p,
                                     ctypes.c_int64]
    lib.dpdfnet_ola_commit.restype = None
    lib.dpdfnet_ola_commit.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64, f32p, f32p]
    lib.dpdfnet_wav_info.restype = ctypes.c_int
    lib.dpdfnet_wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavInfo)]
    lib.dpdfnet_wav_read.restype = ctypes.c_int
    lib.dpdfnet_wav_read.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64]
    lib.dpdfnet_wav_write.restype = ctypes.c_int
    lib.dpdfnet_wav_write.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_int32,
                                      ctypes.c_int32]


def available() -> bool:
    return load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resample(x: np.ndarray, up: int, down: int) -> Optional[np.ndarray]:
    """Polyphase resampling of mono ``x`` by ``up / down`` (the filter of
    scipy's ``resample_poly``)."""
    lib = load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    out_len = lib.dpdfnet_resample_out_len(x.shape[0], up, down)
    y = np.empty(out_len, np.float32)
    n = lib.dpdfnet_resample(_fptr(x), x.shape[0], up, down, _fptr(y), out_len)
    if n < 0:
        return None
    return y[:n]


def ola_commit(frames: np.ndarray, tail: np.ndarray) -> Optional[np.ndarray]:
    """50%-overlap overlap-add of ``frames [T, win]`` after the carried
    ``tail [win / 2]`` (float32, updated in place to the last frame's
    second half); returns the ``T * win / 2`` committed samples."""
    lib = load()
    if lib is None:
        return None
    if tail.dtype != np.float32 or not tail.flags.c_contiguous:
        raise ValueError("ola_commit: tail must be a contiguous float32 array "
                         "(it is updated in place)")
    frames = np.ascontiguousarray(frames, np.float32)
    T, win = frames.shape
    if tail.shape != (win // 2,):
        raise ValueError(f"ola_commit: tail {tail.shape} for frames of {win}")
    out = np.empty(T * (win // 2), np.float32)
    lib.dpdfnet_ola_commit(_fptr(frames), T, win, _fptr(tail), _fptr(out))
    return out


def wav_read(path) -> Optional[Tuple[np.ndarray, int]]:
    """``(float32 samples [S] or [S, C], sample_rate)`` of a PCM16 or
    float32 WAV file; ``None`` for anything the library does not read."""
    lib = load()
    if lib is None:
        return None
    info = _WavInfo()
    if lib.dpdfnet_wav_info(str(path).encode(), ctypes.byref(info)) != 0:
        return None
    total = info.frames * info.channels
    buf = np.empty(total, np.float32)
    if lib.dpdfnet_wav_read(str(path).encode(), _fptr(buf), total) != 0:
        return None
    if info.channels > 1:
        buf = buf.reshape(-1, info.channels)
    return buf, int(info.sample_rate)


def wav_write(path, audio: np.ndarray, sample_rate: int) -> bool:
    """Write float audio ``[S]`` or ``[S, C]`` as a PCM16 WAV file; whether
    the library wrote it."""
    lib = load()
    if lib is None:
        return False
    x = np.ascontiguousarray(audio, np.float32)
    frames = x.shape[0]
    channels = 1 if x.ndim == 1 else x.shape[1]
    rc = lib.dpdfnet_wav_write(str(path).encode(), _fptr(x), frames, channels,
                               int(sample_rate))
    return rc == 0
