"""Streaming state: a nested dict of tensors with the JAX package's keys
and shapes (``dpdfnet_tpu.models.state.init_state``), holding per stream:

- EMA normaliser values (``erb_norm`` mu, ``spec_norm`` s),
- causal-conv time context tails (last ``k_t - 1`` input frames),
- GRU hidden vectors (embedding/decoder stacks and DPRNN inter-GRUs),
- the mask/deep-filter delay lines.

The flat-vector adapter (``flatten_state``/``unflatten_state``) belongs to
the streaming slice and is not ported yet.
"""

from __future__ import annotations

from typing import Dict

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
    """Fresh per-stream state for a batch of independent streams."""
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
