"""Auxiliary signal utilities of the reference's op zoo (counterpart of
``dpdfnet_tpu.ops.extras``).

Power-law compression, a gradient-robust complex angle, local-SNR targets
(the training aid ``train.lsnr_loss`` uses) and the comb-filter matrix.
None is used by the DPDFNet forward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def as_complex(x: Tensor) -> Tensor:
    """``[..., 2]`` real / imaginary stack -> complex tensor."""
    if x.is_complex():
        return x
    if x.shape[-1] != 2:
        raise ValueError(f"Last dimension needs length 2 (re + im), got {tuple(x.shape)}")
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x: Tensor) -> Tensor:
    if x.is_complex():
        return torch.stack([x.real, x.imag], dim=-1)
    return x


def to_db(x: Tensor) -> Tensor:
    return 10.0 * torch.log10(x + 1e-10)


def get_magnitude(x: Tensor) -> Tensor:
    return as_complex(x).abs()


def power_law_compression(signal: Tensor, alpha: float) -> Tensor:
    return torch.sign(signal) * torch.abs(signal) ** alpha


def power_law_decompression(signal: Tensor, alpha: float) -> Tensor:
    return torch.sign(signal) * torch.abs(signal) ** (1.0 / alpha)


class _Angle(torch.autograd.Function):
    """``atan2(imag, real)`` whose backward divides by the squared magnitude
    clamped at 1e-10 (reference ``angle``, model/utils.py:104-116).  The
    gradient is torch's complex convention, ``dL/dre + i dL/dim``; the JAX
    package's is its conjugate, so the two agree through real inputs."""

    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        ctx.save_for_backward(x)
        return torch.atan2(x.imag, x.real)

    @staticmethod
    def backward(ctx, grad: Tensor) -> Tensor:
        (x,) = ctx.saved_tensors
        ginv = grad / torch.clamp(x.real.square() + x.imag.square(), min=1e-10)
        return torch.complex(-x.imag * ginv, x.real * ginv)


def angle(x: Tensor) -> Tensor:
    """Phase of the complex ``x`` with the gradient made robust at zero
    magnitude."""
    return _Angle.apply(x)


# --------------------------------------------------------------------------- #
# Local SNR target (training aid)
# --------------------------------------------------------------------------- #

def _local_energy(x: Tensor, ws: int) -> Tensor:
    """Hann-weighted sliding energy over the frame axis:
    ``x [B, 1, T, F, 2] -> [B, 1, T]``."""
    if ws % 2 == 0:
        ws += 1
    half = ws // 2
    e = x.square().sum(dim=(-1, -2))                              # [B, 1, T]
    e = F.pad(e, (half, half))
    # torch.hann_window's periodic window, taken from numpy as the JAX
    # package does (a window of length 1 is [1.0])
    w_np = np.ones(1) if ws == 1 else np.hanning(ws + 1)[:-1]
    w = torch.as_tensor(w_np, dtype=e.dtype, device=e.device)
    return (e.unfold(-1, ws, 1) * w).sum(dim=-1) / ws


def local_snr(clean: Tensor, noise: Tensor, window_size: int, db: bool = False,
              window_size_ns: Optional[int] = None, eps: float = 1e-12
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-frame SNR from clean / noise spectrograms ``[B, T, F, 2]``;
    returns ``(snr, e_speech, e_noise)``."""
    c = as_real(clean)
    n = as_real(noise)
    c = c[:, None] if c.dim() == 4 else c
    n = n[:, None] if n.dim() == 4 else n
    e_speech = _local_energy(c, window_size)
    ws_ns = window_size if window_size_ns is None else window_size_ns
    e_noise = _local_energy(n, ws_ns)
    snr = e_speech / torch.clamp(e_noise, min=eps)
    if db:
        snr = 10.0 * torch.log10(torch.clamp(snr, min=eps))
    return snr, e_speech, e_noise


class LocalSnrTarget:
    """Frame-level SNR training target (reference ``LocalSnrTarget``)."""

    def __init__(self, fft_size: int, hop_size: int, sr: int, ws: int = 20,
                 db: bool = True, ws_ns: Optional[int] = None,
                 target_snr_range: Optional[Tuple[float, float]] = None):
        self.fft_size = fft_size
        self.hop_size = hop_size
        self.sr = sr
        self.ws = self._calc_ws(ws)
        self.ws_ns = self.ws * 2 if ws_ns is None else self._calc_ws(ws_ns)
        self.db = db
        self.range = target_snr_range

    def _calc_ws(self, ws_ms: int) -> int:
        ws = ws_ms - self.fft_size / self.sr * 1000
        ws = 1 + ws / (self.hop_size / self.sr * 1000)
        return max(int(round(ws)), 1)

    def __call__(self, clean: Tensor, noise: Tensor, max_bin: Optional[int] = None
                 ) -> Tensor:
        if max_bin is not None:
            # real-stacked [..., F, 2] first: on a complex [B, T, F] input
            # the [..., :max_bin, :] slice would cut the time axis
            clean = as_real(clean)[..., :max_bin, :]
            noise = as_real(noise)[..., :max_bin, :]
        snr = local_snr(clean, noise, window_size=self.ws, db=self.db,
                        window_size_ns=self.ws_ns)[0]
        if self.range is not None:
            snr = torch.clamp(snr, self.range[0], self.range[1])
        return snr[:, 0] if snr.dim() == 3 else snr


def create_comb_filter_matrix(
    pitch_min: int = 65, pitch_max: int = 500, nfft: int = 512,
    sample_rate: int = 16000, max_order: Optional[int] = None,
    output_domain: str = "freq", symmetric: bool = False,
) -> np.ndarray:
    """Comb-filter dictionary over candidate pitches (reference
    ``create_comb_filter_matrix``; NumPy, computed once)."""
    if output_domain not in ("time", "freq"):
        raise ValueError(f"output_domain must be 'time' or 'freq', got {output_domain!r}")
    max_order_v = max_order if max_order is not None else 10 ** 9
    n_pitch = int(pitch_max) - int(pitch_min) + 1
    cf = np.zeros((n_pitch, nfft + 1), np.float64)
    for i, f0 in enumerate(range(int(pitch_min), int(pitch_max) + 1)):
        delay = int(sample_rate / f0)
        order = min(int((nfft // 2) / delay), max_order_v)
        # torch.hann_window(N) is the periodic Hann, np.hanning(N + 1)[:-1]
        w = np.hanning((order + 1) * 2 + 1)[:-1][order + 1:]
        w = w / w.sum()
        for o, wv in enumerate(w):
            cf[i, (nfft // 2) - o * delay] = wv
    if symmetric:
        cf[:, nfft // 2 + 1:] = np.flip(cf[:, : nfft // 2], axis=-1)
        cf /= cf.sum(-1, keepdims=True)
    if output_domain == "time":
        return cf.astype(np.float32)
    # magnitude response via the STFT of the impulse responses
    x = cf[:, :-1]
    win = np.hanning(nfft + 1)[:-1]
    mag = np.abs(np.fft.rfft(x * win, n=nfft, axis=-1))
    mn = mag.min(axis=1, keepdims=True)
    mx = mag.max(axis=1, keepdims=True)
    return ((mag - mn) / np.maximum(mx - mn, 1e-12)).astype(np.float32)
