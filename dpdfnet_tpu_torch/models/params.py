"""Random parameter initialisation with the JAX package's tree and shapes.

Same schema as ``dpdfnet_tpu.models.params.init_params`` (so weights carry
across with ``utils.serialization.params_from_jax``), but drawn from a
``torch.Generator``: the numbers differ from the JAX package's for the same
seed.  Used by ``chip_smoke.py`` and tests, where no checkpoint is at hand.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.erb import erb_fb_and_inverse
from ..utils.device import DeviceLike, resolve_device
from ..utils.tree import tree_map

Params = Dict


def _norm(g: torch.Generator, *shape, scale=None):
    if scale is None:
        scale = 1.0 / np.sqrt(max(1, shape[-2] if len(shape) > 1 else shape[0]))
    return torch.randn(shape, generator=g, dtype=torch.float32) * float(scale)


def _ones(n):
    return torch.ones(n, dtype=torch.float32)


def _zeros(n):
    return torch.zeros(n, dtype=torch.float32)


def _conv(g, kt, kf, cin_g, cout, bn=True, pw=False):
    p = {"w": _norm(g, kt, kf, cin_g, cout, scale=1.0 / np.sqrt(kt * kf * cin_g)),
         "b": None}
    if pw:
        p["pw"] = {"w": _norm(g, cout, cout)}
    if bn:
        p["bn"] = {"scale": _ones(cout), "shift": _zeros(cout)}
    return p


def _subpixel(g, kf, cin_g, cout, fstride):
    return {"w": _norm(g, 1, kf, cin_g, cout * fstride, scale=1.0 / np.sqrt(kf * cin_g)),
            "b": None,
            "pw": {"w": _norm(g, cout, cout)},
            "bn": {"scale": _ones(cout), "shift": _zeros(cout)}}


def _gl(g, i, o, groups):
    return {"w": _norm(g, groups, i // groups, o // groups,
                       scale=1.0 / np.sqrt(i // groups)),
            "b": _zeros(o)}


def _lin(g, i, o):
    return {"w": _norm(g, i, o), "b": _zeros(o)}


def _gru(g, i, h):
    return {"wi": _norm(g, i, 3 * h), "bi": _zeros(3 * h),
            "wh": _norm(g, h, 3 * h), "bh": _zeros(3 * h)}


def _ln(c):
    return {"g": _ones(c), "b": _zeros(c)}


def _dprnn_block(g, c):
    return {
        "intra": {"fw": _gru(g, c, c), "bw": _gru(g, c, c),
                  "fc": _lin(g, 2 * c, c), "ln": _ln(c)},
        "inter": {"gru": _gru(g, c, c), "fc": _lin(g, c, c), "ln": _ln(c)},
    }


def _squeezed(g, i, h, o, layers, groups, skip="none", group_gru=1):
    p = {"lin_in": _gl(g, i, h, groups)}
    if group_gru > 1:
        gg = 4      # reference quirk: GroupedGRU keeps its own 4 groups
        p["grus"] = [{"groups": [_gru(g, h // gg, h // gg) for _ in range(gg)]}
                     for _ in range(layers)]
    else:
        p["grus"] = [_gru(g, h, h) for _ in range(layers)]
    if o is not None:
        p["lin_out"] = _gl(g, h, o, groups)
    if skip == "groupedlinear":
        o_eff = o if o is not None else h
        p["skip"] = _gl(g, o_eff, o_eff, groups)
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random weights for ``cfg`` on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    C = cfg.conv_ch
    kt, kf = cfg.conv_kernel_inp
    _, kfc = cfg.conv_kernel
    nb = cfg.nb_df
    H = cfg.gru_dim
    emb_in = cfg.enc_emb_in_dim
    emb_out = cfg.emb_out_dim
    lg, elg = cfg.lin_groups, cfg.enc_lin_groups

    erb_fb, erb_inv_fb = erb_fb_and_inverse(
        cfg.n_fft, cfg.sample_rate, cfg.nb_erb, cfg.min_nb_freqs)

    enc = {
        "erb_conv0": _conv(g, kt, kf, 1, C),
        "erb_conv1": _conv(g, 1, kfc, 1, C, pw=True),
        "erb_conv2": _conv(g, 1, kfc, 1, C, pw=True),
        "erb_conv3": _conv(g, 1, kfc, 1, C, pw=True),
        "df_conv0": _conv(g, kt, kf, 1, C, pw=True),
        "df_conv1": _conv(g, 1, kfc, 1, C, pw=True),
        "dprnn_erb": [_dprnn_block(g, C) for _ in range(cfg.dprnn_blocks)],
        "dprnn_df": [_dprnn_block(g, C) for _ in range(cfg.dprnn_blocks)],
        "df_fc_emb": _gl(g, C * nb // 2, emb_in, elg),
        "emb_gru": _squeezed(g, 2 * emb_in, H, emb_out, 1, lg,
                             skip=cfg.emb_gru_skip, group_gru=cfg.group_gru),
        "lsnr": _lin(g, emb_out, 1),
    }
    if cfg.hr:
        enc["erb_fc_emb"] = _gl(g, C * cfg.dprnn_erb_feat, emb_in, elg)

    erb_dec = {
        "emb_gru": _squeezed(g, emb_out, H,
                             emb_out if not cfg.hr else cfg.emb_dim, 2, lg,
                             skip=cfg.emb_gru_skip, group_gru=cfg.group_gru),
        # pathway 1x1 convs are depthwise
        "conv3p": _conv(g, 1, 1, 1, C),
        "conv2p": _conv(g, 1, 1, 1, C),
        "conv1p": _conv(g, 1, 1, 1, C),
        "conv0p": _conv(g, 1, 1, 1, C),
        "conv0_out": _conv(g, 1, kfc, C, 1),
    }
    st3, st2, st1 = cfg.dec_fstrides

    def _up(st):
        if cfg.upsample == "transpose":
            return _conv(g, 1, kfc, 1, C, pw=True)
        return _subpixel(g, kfc, 1, C, st)

    erb_dec["convt3"] = _conv(g, 1, kfc, 1, C, pw=True) if st3 == 1 else _up(st3)
    erb_dec["convt2"] = _up(st2)
    erb_dec["convt1"] = _up(st1)
    if cfg.hr:
        erb_dec["erb_fc_emb"] = _gl(g, cfg.emb_dim, C * cfg.dprnn_erb_feat, elg)

    df_dec = {
        "df_gru": _squeezed(g, emb_out, H, None, 2, 8, group_gru=cfg.group_gru),
        "df_skip": _gl(g, emb_out, H, lg),
        "df_out": _gl(g, H, nb * 2 * cfg.df_order, lg),
        "df_convp": _conv(g, cfg.df_kt, 1, C // 2, 2 * cfg.df_order, pw=True),
    }

    params = {
        "enc": enc,
        "erb_dec": erb_dec,
        "df_dec": df_dec,
        "erb_fb": torch.from_numpy(erb_fb),
        "erb_inv_fb": torch.from_numpy(erb_inv_fb),
    }
    return tree_map(lambda _, x: x.to(dev), params)


def contract_params(params: Params, factor: float = 0.7) -> Params:
    """Rescale every >=2-D weight so its (flattened) spectral norm is at
    most ``factor`` — weight statistics closer to a trained checkpoint's
    bounded layer gains than raw random init.  ERB filterbanks untouched."""
    def clamp(path, x):
        if x.ndim < 2 or "erb_fb" in path or "erb_inv_fb" in path:
            return x
        s = float(torch.linalg.matrix_norm(
            x.detach().reshape(x.shape[0], -1).double().cpu(), ord=2))
        if s <= factor or s == 0.0:
            return x
        return x * (factor / s)

    return tree_map(clamp, params)
