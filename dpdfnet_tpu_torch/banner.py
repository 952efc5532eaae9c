"""Framed ANSI banner for CLI runs (own copy of ``dpdfnet_tpu.banner``;
suppressed when stderr is not a TTY or ``NO_BANNER`` is set)."""

from __future__ import annotations

import os
import sys
from typing import Optional

_ART = r"""
 ____  ____  ____  _____ _   _      _     _____ ____  _   _
|  _ \|  _ \|  _ \|  ___| \ | | ___| |_  |_   _|  _ \| | | |
| | | | |_) | | | | |_  |  \| |/ _ \ __|   | | | |_) | | | |
| |_| |  __/| |_| |  _| | |\  |  __/ |_    | | |  __/| |_| |
|____/|_|   |____/|_|   |_| \_|\___|\__|   |_| |_|    \___/
"""

_CYAN = "\033[36m"
_DIM = "\033[2m"
_RESET = "\033[0m"


def print_banner(
    model_name: Optional[str] = None,
    sample_rate: Optional[int] = None,
    description: Optional[str] = None,
    version: Optional[str] = None,
    device: Optional[str] = None,
) -> None:
    if os.environ.get("NO_BANNER"):
        return
    if not sys.stderr.isatty():
        return
    lines = [ln for ln in _ART.splitlines() if ln.strip()]
    width = max(len(ln) for ln in lines) + 4
    bar = "+" + "-" * width + "+"
    print(_CYAN + bar + _RESET, file=sys.stderr)
    for ln in lines:
        print(_CYAN + "|  " + ln.ljust(width - 2) + "|" + _RESET, file=sys.stderr)
    info = "speech enhancement, PyTorch + CUDA"
    if version:
        info += f"  v{version}"
    if device:
        info += f"  on {device}"
    print(_CYAN + "|  " + _DIM + info.ljust(width - 2) + _RESET + _CYAN + "|"
          + _RESET, file=sys.stderr)
    if model_name:
        detail = f"model: {model_name}"
        if sample_rate:
            detail += f" @ {sample_rate // 1000} kHz"
        print(_CYAN + "|  " + detail.ljust(width - 2) + "|" + _RESET,
              file=sys.stderr)
    if description:
        print(_CYAN + "|  " + _DIM + description[: width - 2].ljust(width - 2)
              + _RESET + _CYAN + "|" + _RESET, file=sys.stderr)
    print(_CYAN + bar + _RESET, file=sys.stderr)
