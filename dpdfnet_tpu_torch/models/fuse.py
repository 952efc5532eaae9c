"""Inference-time parameter re-parameterisations (counterpart of
``dpdfnet_tpu.models.fuse``).

- ``fuse_separable``: (depthwise/grouped conv -> 1x1 pointwise) is one
  linear map, so it collapses into a single dense conv kernel.
- ``pack_dprnn_bidir``: the DPRNN intra GRUs' weights packed
  direction-blockdiag, gate-major, as the intra kernel takes them; with
  ``DPDFNET_TPU_PALLAS_V2`` set, the v2 kernels' ``wi_cat`` / ``wh_big``
  and ``inter['whfc'] = [Wh | Wfc]``; with ``DPDFNET_TPU_STACK`` set, each
  branch's ``pack_stack`` bundle for the stack kernel.

The JAX package's ``fold_hr_tail`` (the 48 kHz 480-bin plane re-expressed
as ``[160, 3C]``) is a TPU layout choice and is not ported; the forward
takes the unfolded branch when the folded weights are absent.
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
    """Dense-fuse the separable convs, pre-pack the DPRNN intra weights."""
    params = fuse_separable(params, cfg)
    if cfg.dprnn_blocks:
        params = pack_dprnn_bidir(params, cfg)
    return params
