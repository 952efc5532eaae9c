"""A reference-layout checkpoint written from a parameter tree: the exact
inverse of each layer converter of ``models.convert``.

A test aid for the converter where no zoo ``.pth`` is at hand: BatchNorm as
weight / bias / running stats / ``num_batches_tracked``, OIHW convs,
per-group ``nn.Linear`` stacks, per-stride sub-pixel convs, transposed
convs, ``weight_ih_l{k}`` GRUs (or, with ``streaming=True``, the ONNX
model's per-layer GRUCell names), and the ``erb_fb`` / ``mask.erb_inv_fb``
buffers.  Every key it writes is one the converter reads.

BatchNorm statistics: with ``seed=None`` the running mean is 0 and the
running variance ``4 - eps`` in float32, so that ``var + eps`` is exactly
4 and the fold returns each ``scale`` / ``shift`` bit for bit (the round
trip is exact); with a seed they are drawn from it, and the fold rounds.

    sd = state_dict_from_params(params, cfg)              # name -> float32 array
    save_checkpoint("dpdfnet2.pth", params, cfg)          # as torch.save writes it
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..utils.tree import tree_map

_BN_EPS = np.float32(1e-5)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class _Writer:
    def __init__(self, seed: Optional[int]):
        self.sd: Dict[str, np.ndarray] = {}
        self.rng = None if seed is None else np.random.default_rng(seed)

    def put(self, key: str, value) -> None:
        self.sd[key] = np.array(value, order="C")

    def bn(self, prefix: str, p: Dict) -> None:
        scale, shift = p["scale"], p["shift"]
        if self.rng is None:
            mean = np.zeros_like(scale)
            var = np.full_like(scale, np.float32(4.0) - _BN_EPS)
            gamma, beta = scale * np.float32(2.0), shift
        else:
            mean = self.rng.normal(size=scale.shape).astype(np.float32) * np.float32(0.1)
            var = self.rng.uniform(0.5, 2.0, size=scale.shape).astype(np.float32)
            gamma = scale * np.sqrt(var + _BN_EPS)
            beta = shift + mean * scale
        self.put(f"{prefix}.weight", gamma)
        self.put(f"{prefix}.bias", beta)
        self.put(f"{prefix}.running_mean", mean)
        self.put(f"{prefix}.running_var", var)
        self.put(f"{prefix}.num_batches_tracked", np.array(0, np.int64))


def _oihw(w_hwio: np.ndarray) -> np.ndarray:
    return w_hwio.transpose(3, 2, 0, 1)


def _pw(w: _Writer, key: str, p: Dict) -> None:
    w.put(key, p["w"].T[:, :, None, None])


def _plain_conv(w: _Writer, prefix: str, p: Dict, *, has_pad: bool, has_pw: bool) -> None:
    i = 1 if has_pad else 0
    w.put(f"{prefix}.{i}.weight", _oihw(p["w"]))
    if p.get("b") is not None:
        w.put(f"{prefix}.{i}.bias", p["b"])
    i += 1
    if has_pw:
        _pw(w, f"{prefix}.{i}.weight", p["pw"])
        i += 1
    w.bn(f"{prefix}.{i}", p["bn"])


def _grouped_conv(w: _Writer, prefix: str, p: Dict, groups: int, *, has_pad: bool) -> None:
    i = 1 if has_pad else 0
    for g, wg in enumerate(np.split(_oihw(p["w"]), groups, axis=0)):
        w.put(f"{prefix}.{i}.convs.{g}.weight", wg)
    if p.get("b") is not None:
        for g, bg in enumerate(np.split(p["b"], groups)):
            w.put(f"{prefix}.{i}.convs.{g}.bias", bg)
    _pw(w, f"{prefix}.{i + 1}.weight", p["pw"])
    w.bn(f"{prefix}.{i + 2}", p["bn"])


def _conv_transpose(w: _Writer, prefix: str, p: Dict, groups_hint: int) -> None:
    kh, kw, cin_g, out = p["w"].shape
    g = groups_hint
    wg = p["w"].reshape(kh, kw, cin_g, g, out // g).transpose(3, 2, 4, 0, 1)
    w.put(f"{prefix}.0.weight", wg.reshape(g * cin_g, out // g, kh, kw)[:, :, ::-1, ::-1])
    if p.get("b") is not None:
        w.put(f"{prefix}.0.bias", p["b"])
    _pw(w, f"{prefix}.1.weight", p["pw"])
    w.bn(f"{prefix}.2", p["bn"])


def _subpixel_conv(w: _Writer, prefix: str, p: Dict, fstride: int) -> None:
    full = _oihw(p["w"])                                   # [(O*s), I/g, kh, kw]
    per = full.reshape(-1, fstride, *full.shape[1:])       # [O, s, I/g, kh, kw]
    for s in range(fstride):
        w.put(f"{prefix}.0.convs.{s}.weight", per[:, s])
    if p.get("b") is not None:
        bs = p["b"].reshape(-1, fstride)
        for s in range(fstride):
            w.put(f"{prefix}.0.convs.{s}.bias", bs[:, s])
    _pw(w, f"{prefix}.1.weight", p["pw"])
    w.bn(f"{prefix}.2", p["bn"])


def _gl(w: _Writer, prefix: str, p: Dict) -> None:
    groups, _, og = p["w"].shape
    for g in range(groups):
        w.put(f"{prefix}.layers.{g}.weight", p["w"][g].T)
        w.put(f"{prefix}.layers.{g}.bias", p["b"][g * og:(g + 1) * og])


def _lin(w: _Writer, prefix: str, p: Dict) -> None:
    w.put(f"{prefix}.weight", p["w"].T)
    w.put(f"{prefix}.bias", p["b"])


def _gru_layer(w: _Writer, prefix: str, p: Dict, sfx: str) -> None:
    w.put(f"{prefix}.weight_ih{sfx}", p["wi"].T)
    w.put(f"{prefix}.bias_ih{sfx}", p["bi"])
    w.put(f"{prefix}.weight_hh{sfx}", p["wh"].T)
    w.put(f"{prefix}.bias_hh{sfx}", p["bh"])


def _ln(w: _Writer, prefix: str, p: Dict) -> None:
    w.put(f"{prefix}.weight", p["g"])
    w.put(f"{prefix}.bias", p["b"])


def _dprnn(w: _Writer, prefix: str, blocks) -> None:
    for k, blk in enumerate(blocks):
        b = f"{prefix}.blocks.{k}"
        intra, inter = blk["intra"], blk["inter"]
        _gru_layer(w, f"{b}.intra_gru", intra["fw"], "_l0")
        _gru_layer(w, f"{b}.intra_gru", intra["bw"], "_l0_reverse")
        _lin(w, f"{b}.fc_intra", intra["fc"])
        _ln(w, f"{b}.ln_intra", intra["ln"])
        _gru_layer(w, f"{b}.inter_gru", inter["gru"], "_l0")
        _lin(w, f"{b}.fc_inter", inter["fc"])
        _ln(w, f"{b}.ln_inter", inter["ln"])


def _squeezed(w: _Writer, prefix: str, p: Dict) -> None:
    _gl(w, f"{prefix}.linear_in.0", p["lin_in"])
    for k, gp in enumerate(p["grus"]):
        if "groups" in gp:
            for g, pg in enumerate(gp["groups"]):
                _gru_layer(w, f"{prefix}.gru.grus.{k}.layers.{g}", pg, "_l0")
        else:
            _gru_layer(w, f"{prefix}.gru", gp, f"_l{k}")
    if "lin_out" in p:
        _gl(w, f"{prefix}.linear_out.0", p["lin_out"])
    if "skip" in p:
        _gl(w, f"{prefix}.gru_skip", p["skip"])


def _streaming_name(key: str) -> str:
    """The ONNX model's GRUCell name of an offline GRU key (the inverse of
    ``convert.normalize_state_dict``); other keys unchanged."""
    m = re.search(r"\.gru\.(weight|bias)_(ih|hh)_l(\d+)$", key)
    if m:
        kind, gate, layer = m.groups()
        return key[: m.start()] + f".gru.{layer}.grucell.{kind}_{gate}"
    m = re.search(r"inter_gru\.(weight|bias)_(ih|hh)_l0$", key)
    if m:
        kind, gate = m.groups()
        return key[: m.start()] + f"inter_gru.grucell.{kind}_{gate}"
    return key


def state_dict_from_params(params, cfg: ModelConfig, *, streaming: bool = False,
                           seed: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The reference state dict (name -> array; float32, ``num_batches_tracked``
    int64) whose conversion is ``params`` (a tree of tensors or arrays)."""
    p = tree_map(lambda _, x: _np(x), params)
    w = _Writer(seed)
    enc, erb_dec, df_dec = p["enc"], p["erb_dec"], p["df_dec"]

    _plain_conv(w, "enc.erb_conv0", enc["erb_conv0"], has_pad=True, has_pw=False)
    for k in ("erb_conv1", "erb_conv2", "erb_conv3"):
        _plain_conv(w, f"enc.{k}", enc[k], has_pad=False, has_pw=True)
    _grouped_conv(w, "enc.df_conv0", enc["df_conv0"], 2, has_pad=True)
    _plain_conv(w, "enc.df_conv1", enc["df_conv1"], has_pad=False, has_pw=True)
    _dprnn(w, "enc.dprnn_erb", enc["dprnn_erb"])
    _dprnn(w, "enc.dprnn_df", enc["dprnn_df"])
    _gl(w, "enc.df_fc_emb.0", enc["df_fc_emb"])
    _squeezed(w, "enc.emb_gru", enc["emb_gru"])
    _lin(w, "enc.lsnr_fc.0", enc["lsnr"])
    if cfg.hr:
        _gl(w, "enc.erb_fc_emb.0", enc["erb_fc_emb"])

    _squeezed(w, "erb_dec.emb_gru", erb_dec["emb_gru"])
    for k in ("conv3p", "conv2p", "conv1p", "conv0p", "conv0_out"):
        _plain_conv(w, f"erb_dec.{k}", erb_dec[k], has_pad=False, has_pw=False)
    for k, st in zip(("convt3", "convt2", "convt1"), cfg.dec_fstrides):
        if k == "convt3" and st == 1:
            _plain_conv(w, "erb_dec.convt3", erb_dec[k], has_pad=False, has_pw=True)
        elif cfg.upsample == "transpose":
            _conv_transpose(w, f"erb_dec.{k}", erb_dec[k], cfg.conv_ch)
        else:
            _subpixel_conv(w, f"erb_dec.{k}", erb_dec[k], st)
    if cfg.hr:
        _gl(w, "erb_dec.erb_fc_emb.0", erb_dec["erb_fc_emb"])

    _squeezed(w, "df_dec.df_gru", df_dec["df_gru"])
    _gl(w, "df_dec.df_skip", df_dec["df_skip"])
    _gl(w, "df_dec.df_out.0", df_dec["df_out"])
    _grouped_conv(w, "df_dec.df_convp", df_dec["df_convp"], 2, has_pad=True)

    w.put("erb_fb", p["erb_fb"])
    w.put("mask.erb_inv_fb", p["erb_inv_fb"])
    if streaming:
        return {_streaming_name(k): v for k, v in w.sd.items()}
    return w.sd


def save_checkpoint(path, params, cfg: ModelConfig, *, streaming: bool = False,
                    seed: Optional[int] = None) -> None:
    """Write :func:`state_dict_from_params` as a ``.pth`` file (``torch.save``
    of a dict of tensors, as the model zoo ships them)."""
    sd = state_dict_from_params(params, cfg, streaming=streaming, seed=seed)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
