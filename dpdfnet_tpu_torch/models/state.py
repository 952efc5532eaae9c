"""Streaming state: a nested dict of tensors with the JAX package's keys
and shapes (``dpdfnet_tpu.models.state.init_state``), holding per stream:

- EMA normaliser values (``erb_norm`` mu, ``spec_norm`` s),
- causal-conv time context tails (last ``k_t - 1`` input frames),
- GRU hidden vectors (embedding/decoder stacks and DPRNN inter-GRUs),
- the mask/deep-filter delay lines.

``flatten_state``/``unflatten_state`` convert one stream to and from the
reference's flat float32 vector (``dpdfnet_tpu.models.state``), for
checkpointing a live stream and for handing it between the two packages.
The reference's ring buffers each keep one slot that is dropped before
first use; the dict stores only the frames it needs, so those slots
round-trip as zeros.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..config import ModelConfig
from ..utils.device import DeviceLike, resolve_device
from . import init_norms

State = Dict


def _check_layout_assumptions(cfg: ModelConfig) -> None:
    """Fail fast on configs the fixed state layout cannot represent (the
    ring/tail sizes are pinned to kt=3 input convs, df_kt=5, df_order=5,
    lookahead=2, shared by all six shipped configurations)."""
    fixed = {"conv_kernel_inp[0]": (cfg.conv_kernel_inp[0], 3),
             "df_kt": (cfg.df_kt, 5),
             "df_order": (cfg.df_order, 5),
             "lookahead": (cfg.lookahead, 2)}
    bad = {k: got for k, (got, want) in fixed.items() if got != want}
    if bad:
        raise NotImplementedError(
            f"state layout supports only the model family's fixed "
            f"hyperparameters; got {bad} (expected "
            f"{ {k: want for k, (_, want) in fixed.items()} })")


def init_state(cfg: ModelConfig, batch: int = 1, dtype=torch.float32,
               device: DeviceLike = None) -> State:
    """Fresh per-stream state for a batch of independent streams, every
    leaf at ``dtype`` (the engines keep the DPRNN hiddens in float32 under
    bf16 compute, ``Engine.init_stream_state``)."""
    _check_layout_assumptions(cfg)
    dev = resolve_device(device)
    C = cfg.conv_ch
    F = cfg.freq_bins
    E = F if cfg.hr else cfg.nb_erb       # erb/mag norm + conv0 feature width
    nb_df = cfg.nb_df
    O = cfg.df_order
    H = cfg.gru_dim

    def z(*shape):
        return torch.zeros((batch,) + shape, dtype=dtype, device=dev)

    erb_mu0 = init_norms.mag_norm_init(E) if cfg.hr else init_norms.erb_norm_init(E)
    spec_s0 = init_norms.spec_norm_init(nb_df, cfg.hr)

    def rows(v):
        return torch.as_tensor(v, dtype=dtype, device=dev).expand(batch, -1).clone()

    return {
        "erb_norm": rows(erb_mu0),
        "spec_norm": rows(spec_s0),
        "erb_conv0_tail": z(2, E, 1),            # feat_erb frames (full width)
        "dprnn_erb": [z(cfg.dprnn_erb_feat, C) for _ in range(cfg.dprnn_blocks)],
        "df_conv0_tail": z(2, nb_df, 2),         # feat_spec frames
        "dprnn_df": [z(cfg.dprnn_df_feat, C) for _ in range(cfg.dprnn_blocks)],
        "enc_gru": [z(H)],                       # encoder emb_gru (1 layer)
        "erb_dec_gru": [z(H), z(H)],
        "df_gru": [z(H), z(H)],
        "df_convp_tail": z(4, nb_df, C),         # c0 frames for the (5,1) conv
        "mask_spec_tail": z(2, F, 2),            # raw spec delay line
        "df_coefs_tail": z(2, nb_df, O, 2),      # coefs delay line
        "df_spec_tail": z(4, F, 2),              # masked-spec ring tail
    }


# --------------------------------------------------------------------------- #
# Flat-vector adapter (reference state layout)
# --------------------------------------------------------------------------- #

def state_size(cfg: ModelConfig) -> int:
    """Total floats of the reference flat state vector for this config."""
    C, F, O = cfg.conv_ch, cfg.freq_bins, cfg.df_order
    E = F if cfg.hr else cfg.nb_erb
    nb = cfg.nb_df
    n = 0
    n += E                                   # erb/mag norm
    n += nb                                  # spec norm
    n += 3 * E                               # erb_conv0 ring
    n += cfg.dprnn_blocks * cfg.dprnn_erb_feat * C
    n += 3 * 2 * nb                          # df_conv0 ring
    n += cfg.dprnn_blocks * cfg.dprnn_df_feat * C
    n += cfg.gru_dim                         # enc emb_gru
    n += 2 * cfg.gru_dim                     # erb_dec gru
    n += 2 * cfg.gru_dim                     # df gru
    n += 5 * C * nb                          # df_convp ring
    n += 3 * F * 2                           # mask spec ring
    n += 3 * O * nb * 2                      # df coefs ring
    n += 5 * F * 2                           # df spec ring
    return n


def _np(v) -> np.ndarray:
    """A leaf as numpy; bfloat16 leaves come out as float32 (exact)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def flatten_state(cfg: ModelConfig, state: State, stream: int = 0) -> np.ndarray:
    """Serialize one stream of the state (tensors on any device and of any
    float dtype, or numpy arrays) into the reference flat layout; returns a
    float32 numpy vector."""
    s = {k: _np(v) if not isinstance(v, list) else [_np(u) for u in v]
         for k, v in state.items()}
    chunks: List[np.ndarray] = []

    def ring(tail_frames: np.ndarray, capacity: int) -> np.ndarray:
        """tail [k, ...frame] -> [capacity, ...frame] with zeroed unused slots."""
        k = tail_frames.shape[0]
        out = np.zeros((capacity,) + tail_frames.shape[1:], np.float32)
        out[capacity - k:] = tail_frames
        return out

    chunks.append(s["erb_norm"][stream])
    chunks.append(s["spec_norm"][stream])
    # erb_conv0 ring: frames [3, 1, 1, E]; ours [2, E, 1] -> [2, 1, 1, E]
    t = s["erb_conv0_tail"][stream].transpose(0, 2, 1)[:, None]
    chunks.append(ring(t, 3).reshape(-1))
    for h in s["dprnn_erb"]:
        chunks.append(h[stream].reshape(-1))
    # df_conv0 ring: frames [3, 1, 2, nb]; ours [2, nb, 2] -> [2, 2, nb]
    t = s["df_conv0_tail"][stream].transpose(0, 2, 1)[:, None]
    chunks.append(ring(t, 3).reshape(-1))
    for h in s["dprnn_df"]:
        chunks.append(h[stream].reshape(-1))
    for key in ("enc_gru", "erb_dec_gru", "df_gru"):
        for h in s[key]:
            chunks.append(h[stream].reshape(-1))
    # df_convp ring: frames [5, 1, C, nb]; ours [4, nb, C]
    t = s["df_convp_tail"][stream].transpose(0, 2, 1)[:, None]
    chunks.append(ring(t, 5).reshape(-1))
    # mask spec ring: frames [3, 1, 1, F, 2]; ours [2, F, 2]
    chunks.append(ring(s["mask_spec_tail"][stream], 3).reshape(-1))
    # df coefs ring: frames [3, 1, O, nb, 2]; ours [2, nb, O, 2]
    t = s["df_coefs_tail"][stream].transpose(0, 2, 1, 3)
    chunks.append(ring(t, 3).reshape(-1))
    # df spec ring: frames [5, 1, 1, F, 2]; ours [4, F, 2]
    chunks.append(ring(s["df_spec_tail"][stream], 5).reshape(-1))

    flat = np.concatenate([c.astype(np.float32).reshape(-1) for c in chunks])
    if flat.shape[0] != state_size(cfg):
        raise ValueError(f"state holds {flat.shape[0]} floats, the config "
                         f"{state_size(cfg)}: state from a different configuration?")
    return flat


def unflatten_state(cfg: ModelConfig, flat, batch: int = 1, dtype=torch.float32,
                    device: DeviceLike = None) -> State:
    """Rebuild the state dict from a reference-layout flat vector, repeated
    over ``batch`` streams, as tensors on ``device``."""
    C, F, O = cfg.conv_ch, cfg.freq_bins, cfg.df_order
    E = F if cfg.hr else cfg.nb_erb
    nb = cfg.nb_df
    dev = resolve_device(device)
    flat = np.asarray(flat, np.float32).reshape(-1)
    if flat.shape[0] != state_size(cfg):
        raise ValueError(f"flat state holds {flat.shape[0]} floats, the config "
                         f"{state_size(cfg)}: state from a different configuration?")
    pos = 0

    def take(*shape) -> np.ndarray:
        nonlocal pos
        n = int(np.prod(shape))
        out = flat[pos: pos + n].reshape(shape)
        pos += n
        return out

    def rows(x: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)
        return t.expand((batch,) + t.shape).clone()

    out: State = {}
    out["erb_norm"] = rows(take(E))
    out["spec_norm"] = rows(take(nb))
    r = take(3, 1, 1, E)                           # keep the last 2 frames
    out["erb_conv0_tail"] = rows(r[1:, 0].transpose(0, 2, 1))
    out["dprnn_erb"] = [rows(take(cfg.dprnn_erb_feat, C)) for _ in range(cfg.dprnn_blocks)]
    r = take(3, 1, 2, nb)
    out["df_conv0_tail"] = rows(r[1:, 0].transpose(0, 2, 1))
    out["dprnn_df"] = [rows(take(cfg.dprnn_df_feat, C)) for _ in range(cfg.dprnn_blocks)]
    out["enc_gru"] = [rows(take(cfg.gru_dim))]
    out["erb_dec_gru"] = [rows(take(cfg.gru_dim)) for _ in range(2)]
    out["df_gru"] = [rows(take(cfg.gru_dim)) for _ in range(2)]
    r = take(5, 1, C, nb)
    out["df_convp_tail"] = rows(r[1:, 0].transpose(0, 2, 1))
    r = take(3, 1, 1, F, 2)
    out["mask_spec_tail"] = rows(r[1:, 0, 0])
    r = take(3, 1, O, nb, 2)
    out["df_coefs_tail"] = rows(r[1:, 0].transpose(0, 2, 1, 3))
    r = take(5, 1, 1, F, 2)
    out["df_spec_tail"] = rows(r[1:, 0, 0])
    return out
