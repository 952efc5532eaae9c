"""Inference-time parameter re-parameterisations (counterpart of
``dpdfnet_tpu.models.fuse``).

- ``fuse_separable``: (depthwise/grouped conv -> 1x1 pointwise) is one
  linear map, so it collapses into a single dense conv kernel.
- ``fold_hr_tail``: the 48 kHz models' 480-bin plane re-expressed
  frequency-folded as ``[160, 3C]`` (``erb_conv0``, ``erb_conv1``,
  ``conv0p``, the mask head and ``convt1`` restructured, exact copies of
  the weights and zeros); the forward takes the folded branch where the
  ``*_folded`` weights are present.
- ``pack_dprnn_bidir``: the DPRNN intra GRUs' weights packed
  direction-blockdiag, gate-major, as the intra kernel takes them; with
  ``DPDFNET_TPU_PALLAS_V2`` set, the v2 kernels' ``wi_cat`` / ``wh_big``
  and ``inter['whfc'] = [Wh | Wfc]``; with ``DPDFNET_TPU_STACK`` set, each
  branch's ``pack_stack`` bundle for the stack kernel.

``prepare_inference_params`` runs ``fuse_separable`` then
``pack_dprnn_bidir``.  The JAX package folds in between; here the fold
is left out, since on an H100 the folded engine ran slower than the
unfolded one beyond both arms' ranges in one of two interleaved A/Bs
(``PERF.md``).  A folded tree is
``pack_dprnn_bidir(fold_hr_tail(fuse_separable(params, cfg), cfg), cfg)``,
run with ``Engine(..., fuse=False)``.  Every tensor is built on the
tree's device.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import ModelConfig
from ..ops import gru_kernels
from ..ops.gru_kernels import _pack_bidir, pack_intra_v2

Params = Dict


def _dense_from_grouped(w: torch.Tensor, cin: int) -> torch.Tensor:
    """Grouped HWIO ``[kt, kf, cin/g, cout]`` -> dense ``[kt, kf, cin, cout]``."""
    kt, kf, cin_g, cout = w.shape
    g = cin // cin_g
    dense = w.new_zeros((kt, kf, cin, cout))
    out_per_g = cout // g
    for gi in range(g):
        dense[:, :, gi * cin_g:(gi + 1) * cin_g,
              gi * out_per_g:(gi + 1) * out_per_g] = \
            w[:, :, :, gi * out_per_g:(gi + 1) * out_per_g]
    return dense


def _fuse_conv(p: Dict, cin: int) -> Dict:
    """Collapse {'w' (grouped/depthwise), 'pw'} into one dense 'w'."""
    if p is None or p.get("pw") is None:
        return p
    pw = p["pw"]["w"]
    dense = _dense_from_grouped(p["w"], cin)
    out = {k: v for k, v in p.items() if k != "pw"}
    out["w"] = torch.einsum("tfcm,md->tfcd", dense, pw)
    if out.get("b") is not None:
        # epilogue order is bias -> pointwise, so the bias transforms too
        out["b"] = p["b"] @ pw
    return out


def _fuse_subpixel(p: Dict, cin: int, fstride: int) -> Dict:
    """Collapse depthwise sub-pixel convs + pointwise into one dense conv
    whose output channels are packed freq-major (``i*Cout + d``, key
    ``'w_fm'``)."""
    if p is None or p.get("pw") is None:
        return p
    pw = p["pw"]["w"]
    kt, kf, _, scout = p["w"].shape
    cout = scout // fstride
    dense = _dense_from_grouped(p["w"], cin).reshape(kt, kf, cin, cout, fstride)
    fused = torch.einsum("tfcms,md->tfcds", dense, pw)
    fused = fused.movedim(-1, -2).reshape(kt, kf, cin, cout * fstride)
    out = {k: v for k, v in p.items() if k not in ("pw", "w")}
    out["w_fm"] = fused
    if out.get("b") is not None:
        bf = torch.einsum("ci,cd->di", p["b"].reshape(cout, fstride), pw)
        out["b"] = bf.movedim(-1, 0).reshape(-1)
    return out


def fuse_separable(params: Params, cfg: ModelConfig) -> Params:
    """Return a new params tree with all separable convs fused dense."""
    C = cfg.conv_ch
    st3, st2, st1 = cfg.dec_fstrides
    p = dict(params)

    enc = dict(p["enc"])
    for name, cin in (("erb_conv1", C), ("erb_conv2", C), ("erb_conv3", C),
                      ("df_conv0", 2), ("df_conv1", C)):
        enc[name] = _fuse_conv(dict(enc[name]), cin)
    p["enc"] = enc

    dec = dict(p["erb_dec"])
    if st3 == 1:
        dec["convt3"] = _fuse_conv(dict(dec["convt3"]), C)
    elif cfg.upsample == "subpixel":
        dec["convt3"] = _fuse_subpixel(dict(dec["convt3"]), C, st3)
    if cfg.upsample == "subpixel":
        dec["convt2"] = _fuse_subpixel(dict(dec["convt2"]), C, st2)
        dec["convt1"] = _fuse_subpixel(dict(dec["convt1"]), C, st1)
    p["erb_dec"] = dec

    dfd = dict(p["df_dec"])
    dfd["df_convp"] = _fuse_conv(dict(dfd["df_convp"]), C)
    p["df_dec"] = dfd
    return p


def _tile_ch(v: torch.Tensor, s: int) -> torch.Tensor:
    """Per-channel vector [C] -> folded [s*C] for channel index j*C+c."""
    return v.repeat(s)


def _tiled_bn(bn, s: int):
    return None if bn is None else {"scale": _tile_ch(bn["scale"], s),
                                    "shift": _tile_ch(bn["shift"], s)}


def fold_hr_tail(params: Params, cfg: ModelConfig) -> Params:
    """Re-express the 480-bin plane of the 48 kHz models frequency-folded
    (``dpdfnet_tpu.models.fuse.fold_hr_tail``, array for array).

    erb_conv1's stride and convt1's upsample factor are both ``s = 3``, so
    the plane runs as ``[F/3, 3C]`` with the folded channel index ``j*C+c``
    (j the position in the fold) and only weight restructures:

    - erb_conv0 ``[kt,3,1,C]`` -> ``[kt,3,3,3C]`` (input folded ``[160, 3]``);
    - erb_conv1 ``[1,3,C,C]`` stride 3 -> ``[1,2,3C,C]`` stride 1, fpad (1, 0);
    - conv0p ``[1,1,1,C]`` -> ``[1,1,1,3C]`` (a channel-tiled depthwise scale);
    - conv0_out ``[1,3,C,1]`` -> ``[1,3,3C,3]`` (the mask head's 3 phases);
    - convt1: the same ``w_fm``, its BN tiled for the un-reshaped output.

    Original tap ``d = s*(dg-1) + j_in - j_out`` lands at folded tap ``dg``;
    every other weight is zero.  The identity for configs that are not hr
    or upsample by transposed convs; a tree that ``fuse_separable`` has
    not run on raises ``ValueError``."""
    if not cfg.hr or cfg.upsample != "subpixel":
        return params
    s = cfg.erb_fstrides[0]
    if not s == cfg.dec_fstrides[2] == 3:
        raise ValueError(f"fold_hr_tail needs erb and decoder strides of 3, not "
                         f"{cfg.erb_fstrides} / {cfg.dec_fstrides}")
    C = cfg.conv_ch
    # on a raw tree (depthwise erb_conv1, no 'w_fm') the erb_conv1 fold would
    # broadcast a depthwise row over all C input channels
    ec1_w = params["enc"]["erb_conv1"]["w"]
    if ec1_w.shape[2] != C or "w_fm" not in params["erb_dec"]["convt1"]:
        raise ValueError(
            "fold_hr_tail requires fuse_separable to run first "
            f"(erb_conv1 weight {tuple(ec1_w.shape)}, convt1 keys "
            f"{sorted(params['erb_dec']['convt1'])})")

    p = dict(params)
    enc = dict(p["enc"])
    dec = dict(p["erb_dec"])

    # erb_conv0: [kt,3,1,C] -> [kt,3,s,s*C]
    ec0 = enc["erb_conv0"]
    w = ec0["w"]
    w2 = w.new_zeros((w.shape[0], 3, s, s * C))
    for dg in range(3):
        for jin in range(s):
            for jout in range(s):
                d = s * (dg - 1) + jin - jout
                if -1 <= d <= 1:
                    w2[:, dg, jin, jout * C:(jout + 1) * C] = w[:, d + 1, 0]
    enc["erb_conv0_folded"] = {
        "w": w2,
        "b": None if ec0.get("b") is None else _tile_ch(ec0["b"], s),
        "bn": _tiled_bn(ec0.get("bn"), s),
    }

    # erb_conv1: [1,3,C,C] stride 3 -> [1,2,s*C,C] stride 1, fpad (1, 0)
    w = ec1_w
    w1 = w.new_zeros((1, 2, s * C, C))
    for dg in range(2):
        for jin in range(s):
            kd = s * (dg - 1) + jin + 1
            if 0 <= kd < 3:
                w1[:, dg, jin * C:(jin + 1) * C, :] = w[:, kd]
    enc["erb_conv1_folded"] = {**{k: v for k, v in enc["erb_conv1"].items() if k != "w"},
                               "w": w1}

    # conv0p: depthwise 1x1 -> depthwise over s*C
    cp = dec["conv0p"]
    dec["conv0p_folded"] = {
        "w": _tile_ch(cp["w"][0, 0, 0], s).reshape(1, 1, 1, s * C),
        "b": None if cp.get("b") is None else _tile_ch(cp["b"], s),
        "bn": _tiled_bn(cp.get("bn"), s),
    }

    # conv0_out (the mask head): [1,3,C,1] -> [1,3,s*C,s]
    co = dec["conv0_out"]
    w = co["w"]
    w3 = w.new_zeros((1, 3, s * C, s))
    for dg in range(3):
        for jin in range(s):
            for i in range(s):
                d = s * (dg - 1) + jin - i
                if -1 <= d <= 1:
                    w3[:, dg, jin * C:(jin + 1) * C, i] = w[:, d + 1, :, 0]
    bn = co.get("bn")
    dec["conv0_out_folded"] = {
        "w": w3,
        "b": None if co.get("b") is None else co["b"].repeat_interleave(s),
        "bn": None if bn is None else {"scale": bn["scale"].repeat_interleave(s),
                                       "shift": bn["shift"].repeat_interleave(s)},
    }

    # convt1: the same freq-major weights, BN tiled for the un-reshaped output
    ct = dec["convt1"]
    dec["convt1_folded"] = {"w_fm": ct["w_fm"], "b": ct.get("b"),
                            "bn": _tiled_bn(ct.get("bn"), s)}

    p["enc"] = enc
    p["erb_dec"] = dec
    return p


def pack_stack(blocks: list) -> Params:
    """Stack K DPRNN block parameter dicts for ``gru_kernels.dprnn_stack``
    (``pallas_gru.pack_stack``: the same keys; biases and LayerNorm vectors
    as ``[K, 1, C]`` rows).  Each block needs ``intra.packed``."""
    def stk(get):
        return torch.stack([get(b).to(torch.float32) for b in blocks]).contiguous()

    def row(get):
        return torch.stack([get(b).to(torch.float32).reshape(1, -1) for b in blocks])

    return {
        "wi2": stk(lambda b: b["intra"]["packed"]["wi2"]),
        "wh2": stk(lambda b: b["intra"]["packed"]["wh2"]),
        "b2": stk(lambda b: b["intra"]["packed"]["b2"]),
        "wfc_i": stk(lambda b: b["intra"]["fc"]["w"]),
        "bfc_i": row(lambda b: b["intra"]["fc"]["b"]),
        "g_i": row(lambda b: b["intra"]["ln"]["g"]),
        "bln_i": row(lambda b: b["intra"]["ln"]["b"]),
        "wi_t": stk(lambda b: b["inter"]["gru"]["wi"]),
        "wh_t": stk(lambda b: b["inter"]["gru"]["wh"]),
        "b2_t": stk(lambda b: torch.stack([b["inter"]["gru"]["bi"], b["inter"]["gru"]["bh"]])),
        "wfc_t": stk(lambda b: b["inter"]["fc"]["w"]),
        "bfc_t": row(lambda b: b["inter"]["fc"]["b"]),
        "g_t": row(lambda b: b["inter"]["ln"]["g"]),
        "bln_t": row(lambda b: b["inter"]["ln"]["b"]),
    }


def pack_dprnn_bidir(params: Params, cfg: ModelConfig) -> Params:
    """Add pre-packed intra-GRU weights (``intra['packed']``) to every
    DPRNN block; the originals stay beside them.  Read here, at pack time,
    as ``dpdfnet_tpu.models.fuse.pack_dprnn_bidir`` reads them:
    ``gru_kernels.v2_requested()`` adds ``packed['wi_cat']`` /
    ``packed['wh_big']`` and ``inter['whfc']``; ``gru_kernels.stack_enabled()``
    gives each branch its ``pack_stack`` bundle, ``enc[branch + '_stacked']``."""
    p = dict(params)
    enc = dict(p["enc"])
    for branch in ("dprnn_erb", "dprnn_df"):
        blocks = []
        for bp in enc[branch]:
            bp = dict(bp)
            intra = dict(bp["intra"])
            wi2, wh2, b2 = _pack_bidir(intra["fw"], intra["bw"])
            intra["packed"] = {"wi2": wi2, "wh2": wh2, "b2": b2}
            bp["intra"] = intra
            if gru_kernels.v2_requested():
                wi_cat, wh_big = pack_intra_v2(wi2, wh2, intra["fc"]["w"])
                intra["packed"].update(wi_cat=wi_cat, wh_big=wh_big)
                inter = dict(bp["inter"])
                inter["whfc"] = torch.cat([inter["gru"]["wh"], inter["fc"]["w"]], dim=1)
                bp["inter"] = inter
            blocks.append(bp)
        enc[branch] = blocks
        if blocks and gru_kernels.stack_enabled():
            enc[branch + "_stacked"] = pack_stack(blocks)
    p["enc"] = enc
    return p


def prepare_inference_params(params: Params, cfg: ModelConfig) -> Params:
    """Dense-fuse the separable convs, pre-pack the DPRNN intra weights
    (the fold of ``fold_hr_tail`` is left out: see the module notes).  The
    forward on the result matches the raw tree to float32 rounding."""
    params = fuse_separable(params, cfg)
    if cfg.dprnn_blocks:
        params = pack_dprnn_bidir(params, cfg)
    return params
