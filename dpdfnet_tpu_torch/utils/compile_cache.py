"""Where the port's compiled artifacts go (counterpart of
``dpdfnet_tpu.utils.compile_cache``).

The JAX package points XLA's persistent compilation cache at a directory.
The port's compiled artifacts are its libraries: the CUDA kernels
(``ops/_build.py``, one ``nvcc`` build per source, keyed by a hash of the
sources and flags) and the native host library (``native.py``, keyed by a
hash of its source).  Both build once per directory and are reused from
there, so this module names that directory:

- the default is the package's own ``dpdfnet_tpu_torch/_build/`` (listed in
  ``.gitignore``);
- ``enable(path)``, or ``DPDFNET_TPU_COMPILE_CACHE=/path``, moves it, e.g.
  for an installed package whose directory is read-only;
- ``DPDFNET_TPU_COMPILE_CACHE=0`` keeps the default.  The libraries are
  built either way, never skipped.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

DEFAULT_DIR = Path(__file__).resolve().parent.parent / "_build"

_dir: Optional[Path] = None


def enable(path: Optional[Union[str, Path]] = None) -> Path:
    """Build into ``path`` from now on, when given; return the directory in
    use (:func:`build_dir`)."""
    global _dir
    if path is not None:
        _dir = Path(path).expanduser()
    return build_dir()


def build_dir() -> Path:
    """The directory the kernel and native libraries build into and load
    from: the one :func:`enable` set, else ``DPDFNET_TPU_COMPILE_CACHE``
    unless it is ``0``, else :data:`DEFAULT_DIR`."""
    if _dir is not None:
        return _dir
    env = os.environ.get("DPDFNET_TPU_COMPILE_CACHE")
    if env and env != "0":
        return Path(env).expanduser()
    return DEFAULT_DIR
