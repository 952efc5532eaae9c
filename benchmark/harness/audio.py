"""The audio of every mix: noise at a speech level under a 4 Hz
syllable-rate envelope, made on the device from the seed in a few large
calls and returned on the host, where the program's callers hold it.
The work the program does does not depend on it."""

from __future__ import annotations

import math

import numpy as np
import torch

_CHUNK = 1 << 25


def make(rows: int, samples: int, sr: int, level: float, seed: int, device) -> np.ndarray:
    """``[rows, samples]`` of enveloped noise from ``seed``, made on the
    device in chunks of ``_CHUNK`` samples and returned on the host."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    phase = torch.rand((rows, 1), generator=g, device=device) * (2 * math.pi)
    out = np.empty((rows, samples), np.float32)
    step = max(1, _CHUNK // rows)
    for a in range(0, samples, step):
        b = min(samples, a + step)
        t = torch.arange(a, b, device=device, dtype=torch.float32) / sr
        env = 0.6 + 0.4 * torch.sin(2 * math.pi * 4.0 * t[None] + phase)
        x = torch.randn((rows, b - a), generator=g, device=device)
        out[:, a:b] = (x * env * level).cpu().numpy()
    return out
