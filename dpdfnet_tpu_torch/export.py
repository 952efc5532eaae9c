"""Model export: the streaming step and the offline pipeline as
``torch.export`` artifacts (counterpart of ``dpdfnet_tpu.export``).

- ``<model>.stream.pt2``: the single-frame streaming step
  ``(spec [B,1,F,2], flat_state [B,S]) -> (spec_e, flat_state')`` with the
  weights baked in, in the reference's flat state layout, saved with
  ``torch.export.save``; beside it the JAX package's JSON sidecar
  ``<path>.json`` (``state_size``, the norm-init segments, framing), with
  one key added: ``precision``.  An exported program does not carry
  cuBLAS / cuDNN's TF32 settings, which JAX bakes into its program, so
  the loader applies the tier's (:func:`load_exported` does);
- ``<model>.offline.pt2``: ``Engine._offline`` at one ``(batch, samples)``,
  ``(wav [B, S], alpha []) -> enhanced [B, S - win_len]``, with a sidecar
  naming its shape and precision.

The kernels are ``torch.library`` ops (``ops.gru_kernels``), so an
artifact's graph holds ``torch.ops.dpdfnet.*`` nodes: on the card the
loaded step launches the Hopper kernels, on the CPU it runs their plain
versions.  A loader needs ``torch`` and ``dpdfnet_tpu_torch.ops.gru_kernels``
(which registers the ops) and no model code
(``dpdfnet_tpu_torch/tools/consume_exported.py``).  An artifact runs on the
device it was exported on (``platforms`` in the sidecar).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .config import ModelConfig
from .models import init_norms, state as state_lib
from .runtime.engine import Engine, _math_mode
from .utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor


def _flatten_t(cfg: ModelConfig, st) -> Tensor:
    """Traceable flatten of the state dict -> ``[B, S]`` float32 in the
    reference layout (``_flatten_jnp``): ring tails padded with zeroed
    oldest slots, conv rings channel-major."""
    B = st["erb_norm"].shape[0]

    def ring(tail, capacity, perm):
        t = tail.permute((0, 1) + tuple(p + 2 for p in perm)).float()
        pad = t.new_zeros((B, capacity - t.shape[1]) + tuple(t.shape[2:]))
        return torch.cat([pad, t], dim=1).reshape(B, -1)

    parts = [
        st["erb_norm"].reshape(B, -1),
        st["spec_norm"].reshape(B, -1),
        ring(st["erb_conv0_tail"], 3, (1, 0)),
    ]
    for h in st["dprnn_erb"]:
        parts.append(h.reshape(B, -1))
    parts.append(ring(st["df_conv0_tail"], 3, (1, 0)))
    for h in st["dprnn_df"]:
        parts.append(h.reshape(B, -1))
    for key in ("enc_gru", "erb_dec_gru", "df_gru"):
        for h in st[key]:
            parts.append(h.reshape(B, -1))
    parts.append(ring(st["df_convp_tail"], 5, (1, 0)))
    parts.append(ring(st["mask_spec_tail"], 3, (0, 1)))
    parts.append(ring(st["df_coefs_tail"], 3, (1, 0, 2)))
    parts.append(ring(st["df_spec_tail"], 5, (0, 1)))
    return torch.cat([p.float() for p in parts], dim=1)


def _unflatten_t(cfg: ModelConfig, flat: Tensor):
    """Traceable inverse of :func:`_flatten_t` (``_unflatten_jnp``); every
    leaf contiguous, at flat's dtype."""
    B = flat.shape[0]
    C, F, O = cfg.conv_ch, cfg.freq_bins, cfg.df_order
    E = F if cfg.hr else cfg.nb_erb
    nb = cfg.nb_df
    pos = 0

    def take(*shape):
        nonlocal pos
        n = int(np.prod(shape))
        out = flat[:, pos: pos + n].reshape((B,) + shape)
        pos += n
        return out

    def perm(t, *dims):
        return t.permute(dims).contiguous()

    st = {}
    st["erb_norm"] = take(E).contiguous()
    st["spec_norm"] = take(nb).contiguous()
    st["erb_conv0_tail"] = perm(take(3, 1, 1, E)[:, 1:, 0], 0, 1, 3, 2)
    st["dprnn_erb"] = [take(cfg.dprnn_erb_feat, C).contiguous()
                       for _ in range(cfg.dprnn_blocks)]
    st["df_conv0_tail"] = perm(take(3, 1, 2, nb)[:, 1:, 0], 0, 1, 3, 2)
    st["dprnn_df"] = [take(cfg.dprnn_df_feat, C).contiguous()
                      for _ in range(cfg.dprnn_blocks)]
    st["enc_gru"] = [take(cfg.gru_dim).contiguous()]
    st["erb_dec_gru"] = [take(cfg.gru_dim).contiguous() for _ in range(2)]
    st["df_gru"] = [take(cfg.gru_dim).contiguous() for _ in range(2)]
    st["df_convp_tail"] = perm(take(5, 1, C, nb)[:, 1:, 0], 0, 1, 3, 2)
    st["mask_spec_tail"] = take(3, 1, 1, F, 2)[:, 1:, 0, 0].contiguous()
    st["df_coefs_tail"] = perm(take(3, 1, O, nb, 2)[:, 1:, 0], 0, 1, 3, 2, 4)
    st["df_spec_tail"] = take(5, 1, 1, F, 2)[:, 1:, 0, 0].contiguous()
    return st


def make_stream_step(params, cfg: ModelConfig, precision: str = "high",
                     device: DeviceLike = None):
    """Flat-state single-frame step with the reference ONNX signature,
    ``step(spec [B,1,F,2] wnorm-scaled, flat_state [B,S]) -> (spec_e,
    flat_state')``, on an engine's weights (fused as the engine fuses them)
    on ``device`` (``None``: cuda), under the tier's math mode."""
    spec_step = Engine(cfg, params, precision=precision, device=device)._stream_step("spec")

    def step(spec: Tensor, flat_state: Tensor):
        with _math_mode(precision), torch.no_grad():
            out, st = spec_step(spec, _unflatten_t(cfg, flat_state))
            return out, _flatten_t(cfg, st)

    return step


class _Fn(torch.nn.Module):
    """A function as the module ``torch.export`` takes; the tensors it
    closes over (the weights) become the program's constants."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, args, out_path: Path, meta: dict) -> Path:
    with torch.no_grad():                 # one flat graph, no grad-mode region
        program = torch.export.export(_Fn(fn), args, strict=False)
    torch.export.save(program, str(out_path))
    meta["platforms"] = [args[0].device.type]
    Path(str(out_path) + ".json").write_text(json.dumps(meta, indent=1))
    return out_path


def stream_meta(cfg: ModelConfig, batch: int = 1, precision: str = "high") -> dict:
    """The streaming artifact's sidecar: the JAX sidecar's keys and values
    (framing, ``state_size`` and the norm-init segments the reference ONNX
    graph carries as metadata), with ``precision`` added."""
    E = cfg.freq_bins if cfg.hr else cfg.nb_erb
    erb_init = init_norms.mag_norm_init(E) if cfg.hr else init_norms.erb_norm_init(E)
    spec_init = init_norms.spec_norm_init(cfg.nb_df, cfg.hr)
    return {
        "model": cfg.name,
        "sample_rate": cfg.sample_rate,
        "n_fft": cfg.n_fft,
        "hop": cfg.hop,
        "wnorm": cfg.wnorm,
        "batch": batch,
        "state_size": int(state_lib.state_size(cfg)),
        "erb_norm_state_size": int(E),
        "spec_norm_state_size": int(cfg.nb_df),
        "erb_norm_init": ",".join(str(float(v)) for v in erb_init),
        "spec_norm_init": ",".join(str(float(v)) for v in spec_init),
        "precision": precision,
    }


def export_stream(params, cfg: ModelConfig, out_path, *, batch: int = 1,
                  precision: str = "high", device: DeviceLike = None) -> Path:
    """Export the streaming step (:func:`make_stream_step`) at ``batch`` as a
    ``torch.export`` artifact + JSON metadata (:func:`stream_meta`, with
    ``platforms`` the device type)."""
    out_path = Path(out_path)
    dev = resolve_device(device)
    step = make_stream_step(params, cfg, precision, dev)
    spec = torch.zeros((batch, 1, cfg.freq_bins, 2), device=dev)
    flat = torch.zeros((batch, state_lib.state_size(cfg)), device=dev)
    return _export(step, (spec, flat), out_path, stream_meta(cfg, batch, precision))


def export_offline(params, cfg: ModelConfig, out_path, *, batch: int, seconds: float,
                   precision: str = "high", device: DeviceLike = None) -> Path:
    """Export the whole-utterance pipeline at ``batch`` x ``round(seconds *
    sample_rate)`` samples: ``(wav, alpha) -> enhanced``, the engine's
    ``_offline`` (pad, STFT, the segments, blend, iSTFT, alignment; no
    bucketing, so the input is as long as ``Engine.bucket_len`` pads it)."""
    out_path = Path(out_path)
    engine = Engine(cfg, params, precision=precision, device=device)
    S = int(round(seconds * cfg.sample_rate))
    wav = torch.zeros((batch, S), device=engine.device)
    # the iSTFT divisor is held on the device before the trace reads it
    engine._window_sumsquare(engine._front(wav[:1]).shape[1])

    def offline(w: Tensor, alpha: Tensor) -> Tensor:
        with _math_mode(precision):
            return engine._offline(w, alpha)

    meta = {"model": cfg.name, "sample_rate": cfg.sample_rate, "batch": batch,
            "samples": S, "precision": precision}
    return _export(offline, (wav, torch.zeros((), device=engine.device)), out_path, meta)


class Exported:
    """A loaded artifact: ``call(*args)`` runs its program under the
    sidecar's precision (TF32 for cuBLAS / cuDNN on under ``"default"``,
    off otherwise), without autograd; ``meta`` is the sidecar."""

    def __init__(self, program, meta: dict):
        self.program = program
        self.meta = meta
        self._module = program.module()

    def call(self, *args):
        with _math_mode(self.meta.get("precision", "high")), torch.no_grad():
            return self._module(*args)


def load_exported(path) -> Exported:
    """Load an artifact and its sidecar; returns an object with
    ``.call(*args)``."""
    path = Path(path)
    meta = json.loads(Path(str(path) + ".json").read_text())
    return Exported(torch.export.load(str(path)), meta)


def build_initial_flat_state(meta: dict) -> np.ndarray:
    """Reconstruct the initial flat state from exported metadata (the same
    contract as the reference's ONNX runtime and ``dpdfnet_tpu.export``)."""
    init = np.zeros(int(meta["state_size"]), np.float32)
    erb = np.array([float(v) for v in meta["erb_norm_init"].split(",")], np.float32)
    spec = np.array([float(v) for v in meta["spec_norm_init"].split(",")], np.float32)
    e = int(meta["erb_norm_state_size"])
    s = int(meta["spec_norm_state_size"])
    init[:e] = erb
    init[e:e + s] = spec
    return init
