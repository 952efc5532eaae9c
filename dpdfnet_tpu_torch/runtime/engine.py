"""Offline enhancement engine (counterpart of ``dpdfnet_tpu.runtime.engine``).

The offline pipeline runs on the engine's device:

1. pad ``win_len`` zeros (the reference alignment);
2. STFT as one DFT GEMM, scaled by ``wnorm``;
3. ``forward_spec`` over 112-frame segments with the state carried from
   segment to segment (live activations bounded by one segment);
4. the attenuation-limit blend with the 4-frame-shifted noisy spectrum;
5. iSTFT GEMM, then the ``2*win_len`` alignment (2-frame lookahead +
   2-frame DF delay).

Utterance lengths are bucketed on a geometric ladder so a corpus of varied
lengths sees a handful of shapes.

Quality tiers (``QUALITY_TIERS``, the JAX package's ``{name: (precision,
compute dtype)}``) on the card:

- ``highest`` and ``high``: float32 activations, cuBLAS / cuDNN in full
  float32 (TF32 off);
- ``fast``: float32 activations, cuBLAS / cuDNN with TF32 tensor-core math
  (10-bit mantissa, finer than the bf16 pass of the TPU's ``default``);
- ``turbo``: bfloat16 activations from the spectrum after the float32
  STFT to the network's output (convs, linears, DPRNN planes), bf16
  cuBLAS / cuDNN with float32 accumulation; the attenuation-limit blend,
  the iSTFT and the streaming FFTs run in float32.

The hand-written kernels compute in float32 FMA in every tier (bfloat16
planes in and out on ``turbo``).  Each call sets its tier's math mode for
cuBLAS / cuDNN and restores the caller's settings on the way out.

The streaming path (``init_stream_state`` / ``process_frames``) takes
sample frames ``[B, T, win]`` and returns windowed time frames ready for
overlap-add, with the state kept on the engine's device between calls.
The mesh and the stepped/progress path are later slices.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np
import torch

from .. import audio as audio_lib
from ..config import ModelConfig
from ..models import state as state_lib
from ..models.dpdfnet import forward_spec
from ..ops import stft as stft_ops
from ..ops.nn import rounded
from ..ops.windows import vorbis_window
from ..utils.device import DeviceLike, resolve_device
from ..utils.tree import tree_map

QUALITY_TIERS = {
    # name -> (matmul precision, compute dtype), as dpdfnet_tpu's table
    "highest": ("highest", None),
    "high": ("high", None),
    "fast": ("default", None),
    "turbo": ("default", "bf16"),
}
_PRECISIONS = ("highest", "high", "default")

# frames per forward_spec call in throughput mode: the JAX package's
# power-of-two ladder, so both packages split a chunk the same way
_STREAM_T_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _stream_dft_gemm() -> bool:
    """Streaming front/back DFT as the offline path's DFT / iDFT GEMMs
    instead of ``torch.fft.rfft`` / ``irfft`` (``DPDFNET_TPU_STREAM_DFT_GEMM=1``,
    default off, as in the JAX package).  Either way the op sequence per
    frame does not depend on the chunking."""
    return os.environ.get("DPDFNET_TPU_STREAM_DFT_GEMM", "0") not in ("0", "false", "False")


def _state_f32_hiddens() -> bool:
    """Carry the DPRNN inter-GRU hiddens in float32 under bf16 compute
    (``DPDFNET_TPU_STATE_F32H``, default on, read when a stream state is
    made, as in the JAX package): the kernels take and return float32
    hiddens, so a bf16 state would round them at every frame."""
    return os.environ.get("DPDFNET_TPU_STATE_F32H", "1") not in ("0", "false", "False")


def engine_from_quality(cfg, params, quality: str = "high", **kwargs):
    """Build an Engine from a named quality tier (see QUALITY_TIERS)."""
    if quality not in QUALITY_TIERS:
        raise ValueError(f"Unknown quality {quality!r}; choose from "
                         f"{sorted(QUALITY_TIERS)}")
    precision, dtype = QUALITY_TIERS[quality]
    if dtype == "bf16":
        kwargs.setdefault("compute_dtype", torch.bfloat16)
    return Engine(cfg, params, precision=precision, **kwargs)


@contextlib.contextmanager
def _math_mode(precision: str):
    """cuBLAS / cuDNN math for one engine call: TF32 on under ``"default"``
    (``fast``, ``turbo``), off otherwise (cuDNN convs default to TF32);
    bf16 GEMMs accumulate in float32.  The caller's settings come back
    on exit, so a tier never leaks into other code or engines."""
    tf32 = precision == "default"
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
             m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (m.allow_tf32, torch.backends.cudnn.allow_tf32,
         m.allow_bf16_reduced_precision_reduction) = saved


class Engine:
    """Holds params on one device for one model configuration."""

    def __init__(self, cfg: ModelConfig, params, *, precision: str = "high",
                 compute_dtype: torch.dtype = torch.float32, seg_frames: int = 112,
                 bucket_s: float = 1.0, fuse: bool = True, device: DeviceLike = None):
        if precision not in _PRECISIONS:
            raise ValueError(f"precision {precision!r}: choose from {_PRECISIONS}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.precision = precision
        self.compute_dtype = compute_dtype
        self._wnorm = rounded(cfg.wnorm, compute_dtype)
        # weights stay float32 on the device; bf16 compute casts them at use
        params = tree_map(lambda _, x: torch.as_tensor(x, dtype=torch.float32,
                                                       device=self.device), params)
        if fuse:
            from ..models.fuse import prepare_inference_params

            params = prepare_inference_params(params, cfg)
        self.params = params
        self.seg_frames = int(seg_frames)
        self.bucket_samples = max(cfg.hop, int(round(bucket_s * cfg.sample_rate)))
        window = vorbis_window(cfg.win_len)
        self._window = torch.as_tensor(window, device=self.device)
        self._dft = torch.as_tensor(stft_ops.dft_matrices(cfg.win_len, window),
                                    device=self.device)
        self._idft = torch.as_tensor(stft_ops.idft_matrices(cfg.win_len, window),
                                     device=self.device)

    def bucket_len(self, S: int) -> int:
        """Padded length for ``S`` samples: x1.5 geometric ladder of
        ``bucket_s`` multiples, clearing ``S`` by at least ``win_len`` (the
        front end pads win_len, the back end drops 2*win_len)."""
        need = max(S + self.cfg.win_len, 1)
        S_pad = self.bucket_samples
        while S_pad < need:
            S_pad = -(-(S_pad * 3 // 2) // self.bucket_samples) * self.bucket_samples
        return S_pad

    @torch.inference_mode()
    def _offline(self, wav: torch.Tensor, alpha: float) -> torch.Tensor:
        cfg = self.cfg
        b = wav.shape[0]
        x = torch.nn.functional.pad(wav, (0, cfg.win_len))
        spec = stft_ops.stft_matmul(x, self._window, cfg.hop, center=True, dft=self._dft)
        spec = self._scale_spec(spec)
        st = state_lib.init_state(cfg, batch=b, dtype=spec.dtype, device=self.device)
        T = spec.shape[1]
        seg = self.seg_frames
        if T <= seg:
            out, _, _ = forward_spec(self.params, cfg, spec, st, precision=self.precision)
        else:
            n_seg = -(-T // seg)
            spec_p = torch.nn.functional.pad(spec, (0, 0, 0, 0, 0, n_seg * seg - T))
            outs = []
            for i in range(n_seg):
                o, st, _ = forward_spec(self.params, cfg,
                                        spec_p[:, i * seg:(i + 1) * seg].contiguous(), st,
                                        precision=self.precision)
                outs.append(o)
            out = torch.cat(outs, dim=1)[:, :T]
        # attenuation limit: blend the 4-frame-shifted noisy spec; alpha == 0
        # passes the enhanced spec through.  Blend and iSTFT in float32.
        k = audio_lib.ATTN_LIMIT_NOISY_FRAME_OFFSET
        aligned = torch.nn.functional.pad(spec, (0, 0, 0, 0, k, 0))[:, :-k]
        out = alpha * aligned.float() + (1.0 - alpha) * out.float()
        y = stft_ops.istft_matmul(out / cfg.wnorm, self._window, cfg.hop, center=True,
                                  idft=self._idft)
        return y[:, 2 * cfg.win_len:]

    def _scale_spec(self, spec: torch.Tensor) -> torch.Tensor:
        """The float32 spectrum at the compute dtype, times wnorm rounded to
        that dtype (the JAX package's order: cast, then scale)."""
        return spec.to(self.compute_dtype) * self._wnorm

    # ------------------------------------------------------------------ #
    # Streaming path (sample frames in, overlap-add-ready frames out)
    # ------------------------------------------------------------------ #

    def _stream_ends(self):
        """(front, back): sample frames ``[B, T, win]`` -> wnorm-scaled spec
        ``[B, T, F, 2]`` at the compute dtype, and network output spec ->
        windowed float32 time frames ``[B, T, win]``.  The rfft pair by
        default; the DFT / iDFT GEMMs (windows and irfft scaling inside the
        matrices) under ``DPDFNET_TPU_STREAM_DFT_GEMM``.  The transforms run
        in float32 (``torch.fft`` takes no bfloat16): the front casts after
        its transform, the back upcasts before its own."""
        cfg = self.cfg
        window, wnorm, F = self._window, cfg.wnorm, cfg.win_len // 2 + 1
        if _stream_dft_gemm():
            def front(frames):
                out = frames @ self._dft
                return self._scale_spec(torch.stack([out[..., :F], out[..., F:]], dim=-1))

            def back(out):
                out = out.float() / wnorm
                return torch.cat([out[..., 0], out[..., 1]], dim=-1) @ self._idft
        else:
            def front(frames):
                spec = torch.fft.rfft(frames * window, dim=-1)
                return self._scale_spec(torch.stack([spec.real, spec.imag], dim=-1))

            def back(out):
                out = out.float() / wnorm
                y = torch.fft.irfft(torch.complex(out[..., 0], out[..., 1]),
                                    n=cfg.win_len, dim=-1)
                return y * window
        return front, back

    def init_stream_state(self, batch: int = 1):
        """Fresh state for ``batch`` streams on the engine's device, at the
        compute dtype; under bf16 compute the DPRNN inter-GRU hiddens stay
        float32 unless ``DPDFNET_TPU_STATE_F32H=0`` (the kernels carry them
        in float32; the conv tails and delay lines join the bf16 planes)."""
        st = state_lib.init_state(self.cfg, batch=batch, dtype=self.compute_dtype,
                                  device=self.device)
        if self.compute_dtype != torch.float32 and _state_f32_hiddens():
            for key in ("dprnn_erb", "dprnn_df"):
                st[key] = [h.float() for h in st[key]]
        return st

    def process_frames(self, frames: np.ndarray, st, mode: str = "exact"):
        """Process ``[B, T, win_len]`` sample frames; returns windowed time
        frames ``[B, T, win_len]`` (numpy) ready for overlap-add, and the
        new state (on the device).  One host-to-device copy of the frames
        and one device-to-host copy of the output per call.

        ``mode``:
            ``"exact"`` (default): front end, ``forward_spec`` and back end
            once per frame at T == 1, so the op sequence per frame is the
            same for every chunking and the output is bit-identical however
            the stream is cut.
            ``"throughput"``: one ``forward_spec`` per bucket of the
            power-of-two ladder (the JAX package's split, chunk for chunk);
            the same math, with float reduction orders that depend on the
            chunking (about 1e-5 from exact).
        """
        frames = np.asarray(frames, dtype=np.float32)
        B, T, _ = frames.shape
        if mode not in ("exact", "throughput"):
            raise ValueError(f"unknown streaming mode {mode!r}")
        if T == 0:
            return np.zeros((B, 0, self.cfg.win_len), np.float32), st
        front, back = self._stream_ends()
        outs = []
        with _math_mode(self.precision), torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
            if mode == "exact":
                spans = [(t, 1) for t in range(T)]
            else:
                spans, pos = [], 0
                while pos < T:
                    step = max(b for b in _STREAM_T_BUCKETS if b <= T - pos)
                    spans.append((pos, step))
                    pos += step
            for pos, step in spans:
                out, st, _ = forward_spec(self.params, self.cfg,
                                          front(x[:, pos:pos + step]), st,
                                          precision=self.precision)
                outs.append(back(out))
            y = torch.cat(outs, dim=1).cpu().numpy()
        return y, st

    def enhance_waveforms(self, wavs: np.ndarray, attn_limit_db: Optional[float] = None,
                          lengths: Optional[np.ndarray] = None,
                          progress_callback=None) -> np.ndarray:
        """Enhance a batch of waveforms at the model sample rate.

        Args:
            wavs: ``[S]`` or ``[B, S]`` float32 at ``cfg.sample_rate``.
            attn_limit_db: optional attenuation limit (dB).
            lengths: optional per-utterance valid lengths (defaults to S);
                output past each length is zeroed.
            progress_callback: not supported in this slice.

        Returns:
            Enhanced float32 audio (numpy) with the same shape as ``wavs``.
        """
        if progress_callback is not None:
            raise NotImplementedError(
                "progress reporting (the segment-stepped offline path) is not "
                "ported yet (ROADMAP.md queue 1, '_run_offline_stepped')")
        squeeze = np.ndim(wavs) == 1
        x = np.atleast_2d(np.asarray(wavs, dtype=np.float32))
        B, S = x.shape
        value = audio_lib.validate_attn_limit_db(attn_limit_db)
        alpha = 0.0 if value is None else float(np.float32(10.0 ** (-value / 20.0)))

        S_pad = self.bucket_len(S)
        xp = np.zeros((B, S_pad), np.float32)
        xp[:, :S] = x
        with _math_mode(self.precision):
            y = self._offline(torch.from_numpy(xp).to(self.device), alpha)
        y = y.cpu().numpy()

        out = np.zeros_like(x)
        n = min(S, y.shape[1])
        out[:, :n] = y[:B, :n]
        if lengths is not None:
            for i, ln in enumerate(np.asarray(lengths).reshape(-1)):
                out[i, int(ln):] = 0.0
        return out[0] if squeeze else out
