"""Training: the loss family and a train step (counterpart of
``dpdfnet_tpu.train``).

The losses DPDFNet / DeepFilterNet train with: compressed spectral MSE,
multi-resolution STFT loss, SI-SNR and the LSNR auxiliary.  The train step
takes a ``torch.optim`` optimizer over :func:`trainable_parameters`:

    params = dp.init_params(cfg, seed=0)          # on cuda
    opt = torch.optim.Adam(trainable_parameters(params), lr=1e-3)
    step = make_train_step(cfg, opt)
    loss, aux = step(params, noisy, clean)         # [B, S] waveforms, updates params

The CUDA kernels are inference-only (no backward): the step runs its
forward and backward inside ``gru_kernels.force_disabled()``, so every
recurrence takes its plain, differentiable PyTorch version, on the card as
on the CPU.  The ERB filterbanks ``erb_fb`` / ``erb_inv_fb`` are model
constants and are never trained.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .config import ModelConfig
from .models import state as state_lib
from .models.dpdfnet import forward_spec
from .ops import gru_kernels
from .ops import stft as stft_ops
from .ops.extras import LocalSnrTarget
from .ops.windows import vorbis_window
from .runtime.engine import _math_mode
from .utils.tree import tree_leaves

Tensor = torch.Tensor

FROZEN_KEYS = ("erb_fb", "erb_inv_fb")     # constant filterbank buffers


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #

def spectral_loss(est: Tensor, ref: Tensor, compression: float = 0.6,
                  factor_complex: float = 1.0, factor_magnitude: float = 1.0,
                  eps: float = 1e-8) -> Tensor:
    """Compressed spectral loss (DeepFilterNet2 Eq. 2 family) on ``[B, T, F,
    2]`` spectra: a magnitude term on ``|X|^c`` and a complex term on the
    phase-preserving compressed spectrum ``X |X|^(c-1)``."""
    def mag(x):
        return torch.sqrt(x[..., 0].square() + x[..., 1].square() + eps)

    me, mr = mag(est), mag(ref)
    me_c, mr_c = me ** compression, mr ** compression
    loss_m = (me_c - mr_c).square().mean()
    ce = est * (me_c / torch.clamp(me, min=eps))[..., None]
    cr = ref * (mr_c / torch.clamp(mr, min=eps))[..., None]
    loss_c = (ce - cr).square().mean()
    return factor_magnitude * loss_m + factor_complex * loss_c


def multi_res_spectral_loss(est_wav: Tensor, ref_wav: Tensor,
                            fft_sizes: Sequence[int] = (512, 1024, 2048),
                            compression: float = 0.6) -> Tensor:
    """Multi-resolution STFT loss over periodic Hann windows of several sizes."""
    total = 0.0
    for n_fft in fft_sizes:
        w = torch.as_tensor(np.hanning(n_fft + 1)[:-1].astype(np.float32),
                            device=est_wav.device)
        se = stft_ops.stft(est_wav, w, n_fft // 4, center=True)
        sr = stft_ops.stft(ref_wav, w, n_fft // 4, center=True)
        total = total + spectral_loss(se, sr, compression=compression)
    return total / len(fft_sizes)


def si_snr_loss(est: Tensor, ref: Tensor, eps: float = 1e-8) -> Tensor:
    """Negative SI-SNR (dB) over ``[B, S]`` waveforms."""
    est = est - est.mean(dim=-1, keepdim=True)
    ref = ref - ref.mean(dim=-1, keepdim=True)
    alpha = (est * ref).sum(-1, keepdim=True) / ((ref * ref).sum(-1, keepdim=True) + eps)
    target = alpha * ref
    noise = est - target
    snr = 10.0 * torch.log10((target.square().sum(-1) + eps) / (noise.square().sum(-1) + eps))
    return -snr.mean()


def lsnr_loss(lsnr_pred: Tensor, clean_spec: Tensor, noise_spec: Tensor,
              cfg: ModelConfig) -> Tensor:
    """MSE between the model's LSNR head and the frame-level SNR target."""
    tgt = LocalSnrTarget(fft_size=cfg.n_fft, hop_size=cfg.hop, sr=cfg.sample_rate, ws=20,
                         db=True, target_snr_range=(cfg.lsnr_min, cfg.lsnr_max))
    target = tgt(clean_spec, noise_spec)
    n = min(lsnr_pred.shape[1], target.shape[1])
    return (lsnr_pred[:, :n] - target[:, :n]).square().mean()


# --------------------------------------------------------------------------- #
# Train step
# --------------------------------------------------------------------------- #

def enhancement_loss(params, cfg: ModelConfig, noisy_wav: Tensor, clean_wav: Tensor,
                     *, factor_lsnr: float = 5e-4) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full forward + loss on ``[B, S]`` waveforms: compressed spectral +
    LSNR auxiliary.  Returns ``(loss, {"spec": ..., "lsnr": ...})``."""
    window = torch.as_tensor(vorbis_window(cfg.win_len), device=noisy_wav.device)
    spec_n = stft_ops.stft(noisy_wav, window, cfg.hop, center=True) * cfg.wnorm
    spec_c = stft_ops.stft(clean_wav, window, cfg.hop, center=True) * cfg.wnorm
    st = state_lib.init_state(cfg, batch=noisy_wav.shape[0], device=noisy_wav.device)
    out, _, lsnr = forward_spec(params, cfg, spec_n, st)
    # The model output at frame t is the enhanced INPUT frame t-4: the
    # 2-frame lookahead delay plus the deep filter's 2-frame coefficient
    # delay (same 4-frame total the offline path trims as 2*win_len and
    # audio.ATTN_LIMIT_NOISY_FRAME_OFFSET encodes).  Aligning with only
    # the lookahead would train the DF stage as a 2-frame-ahead predictor.
    delay = cfg.lookahead + 2
    out_al = out[:, delay:]
    tgt = spec_c[:, : out_al.shape[1]]
    l_spec = spectral_loss(out_al, tgt)
    l_lsnr = lsnr_loss(lsnr, spec_c, spec_n - spec_c, cfg)
    loss = l_spec + factor_lsnr * l_lsnr
    return loss, {"spec": l_spec, "lsnr": l_lsnr}


def _frozen(path: str) -> bool:
    return bool(set(FROZEN_KEYS) & set(path.split("/")))


def trainable_parameters(params) -> List[Tensor]:
    """The leaves a train step trains, each set to require grad: every leaf
    but the ERB filterbanks, which stay constants (a band trained negative
    would feed log10 a negative power)."""
    out = []
    for path, leaf in tree_leaves(params):
        if not _frozen(path):
            out.append(leaf.requires_grad_(True))
    return out


def make_train_step(cfg: ModelConfig, optimizer: torch.optim.Optimizer, mesh=None):
    """A train step ``step(params, noisy, clean) -> (loss, aux)`` on
    ``[B, S]`` waveforms on the params' device: zero the grads, run
    :func:`enhancement_loss` and its backward with the kernels off
    (``gru_kernels.force_disabled``) in full float32 (TF32 off), then
    ``optimizer.step()``, which updates ``params`` in place.  Build
    ``optimizer`` over :func:`trainable_parameters` of the same tree: a
    filterbank that requires grad raises.  ``mesh`` (the JAX step's
    batch-sharded form) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...): the batch-sharded train step is part of the "
            "multi-device item of ROADMAP.md queue 1 and is not ported yet")

    def step(params, noisy: Tensor, clean: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
        for path, leaf in tree_leaves(params):
            if _frozen(path) and leaf.requires_grad:
                raise ValueError(f"{path} is a constant filterbank and must not require "
                                 "grad; build the optimizer over trainable_parameters(params)")
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad(), gru_kernels.force_disabled(), _math_mode("highest"):
            loss, aux = enhancement_loss(params, cfg, noisy, clean)
            loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step
