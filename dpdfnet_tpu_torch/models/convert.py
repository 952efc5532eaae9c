"""Reference PyTorch checkpoints into the port's parameter tree (counterpart
of ``dpdfnet_tpu.models.convert``).

Takes the *offline* state-dict layout of the model zoo's ``.pth`` files
(the reference's ``model/dpdfnet.py`` module names) or the *streaming*
layout of its ONNX model (GRU layers renamed to per-layer GRUCells);
streaming names are mapped back to the offline ones first.

Every weight is laid out as the port's tree holds it, which is the JAX
package's layout:

- conv ``[O, I/g, kh, kw]`` -> HWIO ``[kh, kw, I/g, O]``;
- GRU ``weight_ih [3H, I]`` -> ``wi [I, 3H]`` (gates keep torch's r, z, n);
- grouped-linear per-group ``nn.Linear`` stacks merge into one
  ``[G, I/G, O/G]`` weight;
- sub-pixel per-stride convs merge into one conv with interleaved output
  channels (``ops.nn.subpixel_block``);
- transposed convs become the flipped kernel of a fractionally strided
  conv (``ops.nn.conv_transpose_block``);
- BatchNorm2d (eval) folds to per-channel ``scale`` / ``shift``.

The conversion runs in PyTorch on ``device`` (default ``cuda``) and
returns float32 tensors there.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.erb import erb_fb_and_inverse
from ..utils.device import DeviceLike, resolve_device
from ..utils.tree import tree_map

Tensor = torch.Tensor
Params = Dict

_BN_EPS = 1e-5


def normalize_state_dict(sd: Mapping) -> Dict:
    """Map streaming (GRUCell) key names back to the offline convention."""
    out: Dict = {}
    for k, v in sd.items():
        m = re.search(r"\.gru\.(\d+)\.grucell\.(weight|bias)_(ih|hh)$", k)
        if m:
            layer, kind, gate = m.groups()
            k = k[: m.start()] + f".gru.{kind}_{gate}_l{layer}"
        else:
            m = re.search(r"inter_gru\.grucell\.(weight|bias)_(ih|hh)$", k)
            if m:
                kind, gate = m.groups()
                k = k[: m.start()] + f"inter_gru.{kind}_{gate}_l0"
        out[k] = v
    return out


def load_torch_checkpoint(path) -> Dict[str, Tensor]:
    """The state dict of a ``.pth`` file, on the CPU (tensors only:
    ``weights_only=True``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach() for k, v in sd.items()}


# --------------------------------------------------------------------------- #
# Layer converters
# --------------------------------------------------------------------------- #

class _SD:
    """State-dict accessor that records the keys it hands out, each as a
    float32 tensor on ``device``."""

    def __init__(self, sd: Mapping, device: torch.device):
        self.sd = dict(sd)
        self.device = device
        self.used: set = set()

    def __call__(self, key: str) -> Tensor:
        v = self.sd[key]
        self.used.add(key)
        v = v if isinstance(v, Tensor) else torch.as_tensor(np.asarray(v))
        return v.to(device=self.device, dtype=torch.float32)

    def has(self, key: str) -> bool:
        return key in self.sd

    def unused(self):
        drop = (".num_batches_tracked", ".running_mean", ".running_var")
        return sorted(k for k in self.sd if k not in self.used and not k.endswith(drop))


def _bn(sd: _SD, prefix: str) -> Dict:
    gamma, beta = sd(f"{prefix}.weight"), sd(f"{prefix}.bias")
    mean, var = sd(f"{prefix}.running_mean"), sd(f"{prefix}.running_var")
    sd.used.add(f"{prefix}.num_batches_tracked")
    # float32 sqrt correctly rounded, as NumPy's (the JAX package's fold):
    # torch.sqrt on the CPU is not; through float64 it is, on any device
    scale = gamma / torch.sqrt((var + _BN_EPS).double()).float()
    return {"scale": scale, "shift": beta - mean * scale}


def _conv_w(w: Tensor) -> Tensor:
    return w.permute(2, 3, 1, 0)                    # OIHW -> HWIO


def _pw(sd: _SD, key: str) -> Dict:
    return {"w": sd(key)[:, :, 0, 0].T}


def _plain_conv(sd: _SD, prefix: str, *, has_pad: bool, has_pw: bool) -> Dict:
    i = 1 if has_pad else 0
    p: Dict = {"w": _conv_w(sd(f"{prefix}.{i}.weight")), "b": None}
    if sd.has(f"{prefix}.{i}.bias"):
        p["b"] = sd(f"{prefix}.{i}.bias")
    i += 1
    if has_pw:
        p["pw"] = _pw(sd, f"{prefix}.{i}.weight")
        i += 1
    p["bn"] = _bn(sd, f"{prefix}.{i}")
    return p


def _grouped_conv(sd: _SD, prefix: str, groups: int, *, has_pad: bool) -> Dict:
    i = 1 if has_pad else 0
    ws = [sd(f"{prefix}.{i}.convs.{g}.weight") for g in range(groups)]
    p: Dict = {"w": _conv_w(torch.cat(ws, dim=0)), "b": None}
    if sd.has(f"{prefix}.{i}.convs.0.bias"):
        p["b"] = torch.cat([sd(f"{prefix}.{i}.convs.{g}.bias") for g in range(groups)])
    p["pw"] = _pw(sd, f"{prefix}.{i + 1}.weight")
    p["bn"] = _bn(sd, f"{prefix}.{i + 2}")
    return p


def _conv_transpose(sd: _SD, prefix: str, groups_hint: int) -> Dict:
    """ConvTranspose2d (+ pw + bn) -> fractionally strided conv kernel: the
    torch weight ``[in, out/g, kh, kw]`` becomes HWIO ``[kh, kw, in/g,
    out]`` with the taps flipped."""
    w = sd(f"{prefix}.0.weight")                    # [in, out/g, kh, kw]
    cin, out_g, kh, kw = w.shape
    g = groups_hint
    wg = w.flip((2, 3)).reshape(g, cin // g, out_g, kh, kw)
    p: Dict = {"w": wg.permute(3, 4, 1, 0, 2).reshape(kh, kw, cin // g, g * out_g),
               "b": None}
    if sd.has(f"{prefix}.0.bias"):
        p["b"] = sd(f"{prefix}.0.bias")
    p["pw"] = _pw(sd, f"{prefix}.1.weight")
    p["bn"] = _bn(sd, f"{prefix}.2")
    return p


def _subpixel_conv(sd: _SD, prefix: str, fstride: int) -> Dict:
    # the sub-convs sit at index 0 (time kernel 1: no pad layer); output
    # channels interleave as c*fstride + s
    ws = [sd(f"{prefix}.0.convs.{s}.weight") for s in range(fstride)]
    w = torch.stack(ws, dim=1).reshape(-1, *ws[0].shape[1:])   # [(O*s), I/g, kh, kw]
    p: Dict = {"w": _conv_w(w), "b": None}
    if sd.has(f"{prefix}.0.convs.0.bias"):
        p["b"] = torch.stack([sd(f"{prefix}.0.convs.{s}.bias") for s in range(fstride)],
                             dim=1).reshape(-1)
    p["pw"] = _pw(sd, f"{prefix}.1.weight")
    p["bn"] = _bn(sd, f"{prefix}.2")
    return p


def _gl(sd: _SD, prefix: str, groups: int) -> Dict:
    """GroupedLinear: loop form (``.layers.g``) or einsum form (``.weight``)."""
    if sd.has(f"{prefix}.weight"):
        return {"w": sd(f"{prefix}.weight"), "b": sd(f"{prefix}.bias")}
    ws = [sd(f"{prefix}.layers.{g}.weight").T for g in range(groups)]
    bs = [sd(f"{prefix}.layers.{g}.bias") for g in range(groups)]
    return {"w": torch.stack(ws, dim=0), "b": torch.cat(bs)}


def _lin(sd: _SD, prefix: str) -> Dict:
    return {"w": sd(f"{prefix}.weight").T, "b": sd(f"{prefix}.bias")}


def _gru_layer(sd: _SD, prefix: str, sfx: str) -> Dict:
    return {
        "wi": sd(f"{prefix}.weight_ih{sfx}").T,
        "bi": sd(f"{prefix}.bias_ih{sfx}"),
        "wh": sd(f"{prefix}.weight_hh{sfx}").T,
        "bh": sd(f"{prefix}.bias_hh{sfx}"),
    }


def _ln(sd: _SD, prefix: str) -> Dict:
    return {"g": sd(f"{prefix}.weight"), "b": sd(f"{prefix}.bias")}


def _dprnn(sd: _SD, prefix: str, blocks: int):
    out = []
    for k in range(blocks):
        b = f"{prefix}.blocks.{k}"
        out.append({
            "intra": {
                "fw": _gru_layer(sd, f"{b}.intra_gru", "_l0"),
                "bw": _gru_layer(sd, f"{b}.intra_gru", "_l0_reverse"),
                "fc": _lin(sd, f"{b}.fc_intra"),
                "ln": _ln(sd, f"{b}.ln_intra"),
            },
            "inter": {
                "gru": _gru_layer(sd, f"{b}.inter_gru", "_l0"),
                "fc": _lin(sd, f"{b}.fc_inter"),
                "ln": _ln(sd, f"{b}.ln_inter"),
            },
        })
    return out


def _squeezed(sd: _SD, prefix: str, layers: int, groups: int, has_out: bool,
              skip: str = "none") -> Dict:
    if sd.has(f"{prefix}.gru.grus.0.layers.0.weight_ih_l0"):
        # group_gru > 1: a GroupedGRU, per-layer lists of per-group nn.GRUs
        grus = []
        for k in range(layers):
            gg = 0
            while sd.has(f"{prefix}.gru.grus.{k}.layers.{gg}.weight_ih_l0"):
                gg += 1
            grus.append({"groups": [
                _gru_layer(sd, f"{prefix}.gru.grus.{k}.layers.{g}", "_l0")
                for g in range(gg)]})
    else:
        grus = [_gru_layer(sd, f"{prefix}.gru", f"_l{k}") for k in range(layers)]
    p = {"lin_in": _gl(sd, f"{prefix}.linear_in.0", groups), "grus": grus}
    if has_out:
        p["lin_out"] = _gl(sd, f"{prefix}.linear_out.0", groups)
    if skip == "groupedlinear":
        p["skip"] = _gl(sd, f"{prefix}.gru_skip", groups)
    return p


# --------------------------------------------------------------------------- #
# Full model
# --------------------------------------------------------------------------- #

def convert_state_dict(raw_sd: Mapping, cfg: ModelConfig, *, strict: bool = True,
                       device: DeviceLike = None) -> Params:
    """The port's parameter tree from a reference state dict (tensors or
    NumPy arrays), float32 on ``device`` (``None``: cuda).  A missing key
    raises ``KeyError``; with ``strict``, a key no converter read raises
    ``ValueError``, as does an ``erb_fb`` buffer that differs from the
    computed filterbank."""
    dev = resolve_device(device)
    sd = _SD(normalize_state_dict(raw_sd), dev)
    lg, elg = cfg.lin_groups, cfg.enc_lin_groups
    st3, st2, st1 = cfg.dec_fstrides

    enc = {
        "erb_conv0": _plain_conv(sd, "enc.erb_conv0", has_pad=True, has_pw=False),
        "erb_conv1": _plain_conv(sd, "enc.erb_conv1", has_pad=False, has_pw=True),
        "erb_conv2": _plain_conv(sd, "enc.erb_conv2", has_pad=False, has_pw=True),
        "erb_conv3": _plain_conv(sd, "enc.erb_conv3", has_pad=False, has_pw=True),
        "df_conv0": _grouped_conv(sd, "enc.df_conv0", 2, has_pad=True),
        "df_conv1": _plain_conv(sd, "enc.df_conv1", has_pad=False, has_pw=True),
        "dprnn_erb": _dprnn(sd, "enc.dprnn_erb", cfg.dprnn_blocks),
        "dprnn_df": _dprnn(sd, "enc.dprnn_df", cfg.dprnn_blocks),
        "df_fc_emb": _gl(sd, "enc.df_fc_emb.0", elg),
        "emb_gru": _squeezed(sd, "enc.emb_gru", 1, lg, True, skip=cfg.emb_gru_skip),
        "lsnr": _lin(sd, "enc.lsnr_fc.0"),
    }
    if cfg.hr:
        enc["erb_fc_emb"] = _gl(sd, "enc.erb_fc_emb.0", elg)

    erb_dec = {
        "emb_gru": _squeezed(sd, "erb_dec.emb_gru", 2, lg, True, skip=cfg.emb_gru_skip),
        "conv3p": _plain_conv(sd, "erb_dec.conv3p", has_pad=False, has_pw=False),
        "conv2p": _plain_conv(sd, "erb_dec.conv2p", has_pad=False, has_pw=False),
        "conv1p": _plain_conv(sd, "erb_dec.conv1p", has_pad=False, has_pw=False),
        "conv0p": _plain_conv(sd, "erb_dec.conv0p", has_pad=False, has_pw=False),
        "conv0_out": _plain_conv(sd, "erb_dec.conv0_out", has_pad=False, has_pw=False),
    }

    def up(prefix, st):
        if cfg.upsample == "transpose":
            return _conv_transpose(sd, prefix, cfg.conv_ch)
        return _subpixel_conv(sd, prefix, st)

    erb_dec["convt3"] = (_plain_conv(sd, "erb_dec.convt3", has_pad=False, has_pw=True)
                         if st3 == 1 else up("erb_dec.convt3", st3))
    erb_dec["convt2"] = up("erb_dec.convt2", st2)
    erb_dec["convt1"] = up("erb_dec.convt1", st1)
    if cfg.hr:
        erb_dec["erb_fc_emb"] = _gl(sd, "erb_dec.erb_fc_emb.0", elg)

    df_dec = {
        # the reference DfDecoder leaves SqueezedGRU_S's linear_groups at
        # its default of 8
        "df_gru": _squeezed(sd, "df_dec.df_gru", 2, 8, False),
        "df_skip": _gl(sd, "df_dec.df_skip", lg),
        "df_out": _gl(sd, "df_dec.df_out.0", lg),
        "df_convp": _grouped_conv(sd, "df_dec.df_convp", 2, has_pad=True),
    }

    erb_fb, erb_inv_fb = (torch.from_numpy(m).to(dev) for m in erb_fb_and_inverse(
        cfg.n_fft, cfg.sample_rate, cfg.nb_erb, cfg.min_nb_freqs))
    # cross-check against the checkpoint's buffer where it has one
    if sd.has("erb_fb"):
        ref_fb = sd("erb_fb")
        if ref_fb.shape != erb_fb.shape or not torch.allclose(ref_fb, erb_fb, atol=1e-6):
            raise ValueError("checkpoint erb_fb differs from computed filterbank")
    for k in ("erb_inv_fb", "mask.erb_inv_fb", "stft.w", "istft.w_inv", "istft_norm.w_inv"):
        if sd.has(k):
            sd.used.add(k)

    if strict:
        leftover = sd.unused()
        if leftover:
            raise ValueError(f"unconverted checkpoint keys: {leftover[:12]}...")

    params = {"enc": enc, "erb_dec": erb_dec, "df_dec": df_dec,
              "erb_fb": erb_fb, "erb_inv_fb": erb_inv_fb}
    return tree_map(lambda _, x: x.contiguous(), params)


def load_params(path, cfg: ModelConfig, device: DeviceLike = None) -> Params:
    """A reference ``.pth`` checkpoint as the port's parameter tree on
    ``device`` (``None``: cuda)."""
    return convert_state_dict(load_torch_checkpoint(path), cfg, device=device)
