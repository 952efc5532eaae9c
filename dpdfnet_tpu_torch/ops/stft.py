"""STFT / iSTFT with the DFT as one GEMM (counterpart of ``dpdfnet_tpu.ops.stft``).

Offline framing is *center*: reflect-pad ``win//2`` on both sides, frames
every ``hop`` samples (``torch.stft(center=True)`` convention).  The
windowed real DFT and its inverse + synthesis window are single matrices,
so the front and back ends are each one matrix product.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def frame_signal(x: Tensor, win: int, hop: int, *, center: bool) -> Tensor:
    """Slice ``x: [B, S]`` into overlapping frames ``[B, T, win]``."""
    if center:
        x = F.pad(x[:, None], (win // 2, win // 2), mode="reflect")[:, 0]
    return x.unfold(-1, win, hop)


def dft_matrices(n_fft: int, window: np.ndarray) -> np.ndarray:
    """Windowed real DFT as one matrix ``[win, 2*(n_fft//2+1)]``:
    ``frames @ W`` gives the real parts then the imaginary parts."""
    Fb = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(Fb)[None, :]
    arg = -2.0 * np.pi * n * k / n_fft
    real = np.cos(arg) * window[:, None]
    imag = np.sin(arg) * window[:, None]
    return np.concatenate([real, imag], axis=1).astype(np.float32)


def stft_matmul(x: Tensor, window: Tensor, hop: int, *, center: bool = True,
                dft: Tensor | None = None) -> Tensor:
    """STFT ``[B, S] -> [B, T, F, 2]`` with the DFT as a single GEMM."""
    win = window.shape[0]
    if dft is None:
        dft = torch.as_tensor(dft_matrices(win, window.cpu().numpy()), device=x.device)
    frames = frame_signal(x, win, hop, center=center)
    Fb = win // 2 + 1
    out = frames @ dft.to(x.dtype)                               # [B, T, 2F]
    return torch.stack([out[..., :Fb], out[..., Fb:]], dim=-1)


def idft_matrices(n_fft: int, window: np.ndarray) -> np.ndarray:
    """Inverse real DFT + synthesis window as one matrix ``[2F, win]``."""
    Fb = n_fft // 2 + 1
    n = np.arange(n_fft)[None, :]
    k = np.arange(Fb)[:, None]
    arg = 2.0 * np.pi * k * n / n_fft
    scale = np.full((Fb, 1), 2.0 / n_fft)
    scale[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        scale[-1] = 1.0 / n_fft
    real = np.cos(arg) * scale
    imag = -np.sin(arg) * scale
    m = np.concatenate([real, imag], axis=0)
    return (m * window[None, :]).astype(np.float32)


def istft_matmul(spec: Tensor, window: Tensor, hop: int, *, center: bool = True,
                 idft: Tensor | None = None) -> Tensor:
    """Inverse STFT ``[B, T, F, 2] -> [B, S]``: one GEMM, overlap-add,
    window-sum-square normalisation."""
    win = window.shape[0]
    if idft is None:
        idft = torch.as_tensor(idft_matrices(win, window.cpu().numpy()),
                               device=spec.device)
    B, T = spec.shape[:2]
    flat = torch.cat([spec[..., 0], spec[..., 1]], dim=-1)       # [B, T, 2F]
    frames = flat @ idft.to(spec.dtype)                          # [B, T, win]
    total = win + hop * (T - 1)
    out = _overlap_add(frames, hop, total)
    wss = _window_sumsquare(window.cpu().numpy(), T, hop)
    wss = torch.as_tensor(np.where(wss > 1e-11, wss, 1.0), dtype=out.dtype,
                          device=out.device)
    out = out / wss
    if center:
        return out[:, win // 2: total - win // 2]
    return out


def _overlap_add(frames: Tensor, hop: int, total: int) -> Tensor:
    """Overlap-add ``frames: [B, T, win]`` into ``[B, total]``; at 50%
    overlap two strided half-frame planes are summed."""
    B, T, win = frames.shape
    out = frames.new_zeros((B, total))
    if win == 2 * hop:
        out[:, : T * hop] += frames[:, :, :hop].reshape(B, T * hop)
        out[:, hop: hop + T * hop] += frames[:, :, hop:].reshape(B, T * hop)
        return out
    idx = (torch.arange(T, device=frames.device)[:, None] * hop
           + torch.arange(win, device=frames.device)[None, :]).reshape(-1)
    return out.index_add_(1, idx, frames.reshape(B, -1))


@functools.lru_cache(maxsize=32)
def _window_sumsquare_cached(win_key: bytes, T: int, hop: int) -> np.ndarray:
    window = np.frombuffer(win_key, dtype=np.float32)
    total = window.shape[0] + hop * (T - 1)
    wss = np.zeros(total, dtype=np.float64)
    w2 = window.astype(np.float64) ** 2
    for t in range(T):
        wss[t * hop: t * hop + window.shape[0]] += w2
    return wss.astype(np.float32)


def _window_sumsquare(window: np.ndarray, T: int, hop: int) -> np.ndarray:
    return _window_sumsquare_cached(np.asarray(window, np.float32).tobytes(), T, hop)
