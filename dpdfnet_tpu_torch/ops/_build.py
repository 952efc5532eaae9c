"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, in
``utils.compile_cache.build_dir()`` (by default ``dpdfnet_tpu_torch/_build/``,
listed in ``.gitignore``), on first use.  All missing libraries are built
by parallel ``nvcc`` processes.  A library's file name carries a hash of
its sources and flags, so an edited source is rebuilt.  Libraries are
loaded with ``ctypes``; nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from ..utils import compile_cache

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"

# library name -> (main source, headers it includes)
SOURCES: Dict[str, tuple] = {
    "dprnn_inter": ("dprnn_inter.cu", ("dprnn_inter.cuh", "gru64_warp.cuh", "gru64_walk.cuh")),
    "dprnn_inter_v2": ("dprnn_inter_v2.cu", ("gru64_walk.cuh",)),
    "dprnn_intra": ("dprnn_intra.cu", ("dprnn_intra.cuh", "gru64_warp.cuh", "gru64_walk.cuh")),
    "dprnn_intra_v2": ("dprnn_intra_v2.cu", ("dprnn_intra.cuh", "gru64_warp.cuh",
                                             "gru64_walk.cuh")),
    "dprnn_stack": ("dprnn_stack.cu", ("gru64_warp.cuh", "gru64_walk.cuh")),
    "gru_bidir": ("gru_bidir.cu", ("gru64_warp.cuh", "gru64_walk.cuh")),
    "gru_scan": ("gru_scan.cu", ("gru64_walk.cuh", "proj_gemm.cuh")),
    "relayout_fm": ("relayout_fm.cu", ()),
    "intra_step_ablation": ("intra_step_ablation.cu", ("dprnn_intra.cuh", "gru64_warp.cuh",
                                                       "gru64_walk.cuh")),
    "inter_step_ablation": ("inter_step_ablation.cu", ("dprnn_inter.cuh", "gru64_warp.cuh",
                                                       "gru64_walk.cuh")),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()       # one build and load at a time (a mesh's threads)


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    main, headers = SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (main,) + tuple(headers):
        h.update((CSRC / f).read_bytes())
    return compile_cache.build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library in ``names`` (default: all), one
    ``nvcc`` per source, all started together.  Returns the build seconds
    per library built; raises with the compiler's output on failure.
    The ``-Xptxas -v`` report lands beside each library as ``.log``."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    compile_cache.build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp, out)
    seconds: Dict[str, float] = {}
    failures = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"--- nvcc {n} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report (registers, shared memory, spills) for ``name``."""
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed; threads that ask
    at once build and load it once."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                build([name])
                lib = _LOADED[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
