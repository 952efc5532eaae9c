"""DPDFNet forward pass in PyTorch (counterpart of ``dpdfnet_tpu.models.dpdfnet``).

    ``forward_spec(params, cfg, spec, state) -> (spec_e, new_state, lsnr)``

on ``spec: [B, T, F, 2]`` (wnorm-scaled STFT frames) with explicit carried
state.  Output frame ``t`` is the enhanced input frame ``t-2`` (the 2-frame
lookahead realised as delay lines, which are time shifts here).

The DPRNN stages (or, with ``DPDFNET_TPU_STACK``, each whole DPRNN
stack) and every GRU layer go through the kernel wrappers of
``ops.gru_kernels``: CUDA kernels for CUDA tensors, their plain versions
for CPU tensors.  With ``DPDFNET_TPU_INTRA_TM=1`` (the JAX package's
default; off here, see ``ops.gru_kernels``), batches of 32 and more
(multiples of 8, Fq a multiple of 8) run each DPRNN stack as the
freq-major chain (``_dprnn_fm``).
Convs, GEMMs and elementwise work are plain PyTorch.

The activations run at ``spec``'s dtype (bfloat16 on the ``turbo`` tier),
with the JAX package's casts: weights are cast at use, state leaves join
the planes at the planes' dtype, the carried hiddens enter the kernels in
float32 and return at the state leaf's dtype.  ``precision`` is the
tier's matmul precision (``"highest"``, ``"high"`` or ``"default"``), an
explicit argument where the JAX package reads an ambient context; under
``"default"`` it enables ``DPDFNET_TPU_PALLAS_V2`` (inter v2 kernel) and
``DPDFNET_TPU_PLANE_IO=bf16`` (bfloat16 DPRNN planes).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..config import ModelConfig
from ..ops import gru_kernels
from ..ops import nn as onn

Tensor = torch.Tensor
Params = Dict
State = Dict

_DB_EPS = 1e-10
_SPEC_EPS = 1e-12


def _to_db(x: Tensor) -> Tensor:
    return 10.0 * torch.log10(x + _DB_EPS)


def _features(params: Params, cfg: ModelConfig, spec: Tensor, state: State
              ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Returns (feat_erb [B,T,E], feat_spec [B,T,nb_df,2], mu_last, s_last)."""
    power = spec[..., 0].square() + spec[..., 1].square()           # [B,T,F]
    if cfg.hr:
        feat_erb_raw = _to_db(torch.sqrt(power))    # full-band magnitude in dB
    else:
        feat_erb_raw = _to_db(power @ params["erb_fb"].to(spec.dtype))
    # sequential EMA for single frames (bit-stable chunking), log-depth
    # associative form for multi-frame spans
    ema = onn.ema_scan if spec.shape[1] == 1 else onn.ema_scan_assoc
    mu = ema(feat_erb_raw, state["erb_norm"], cfg.alpha)
    feat_erb = (feat_erb_raw - mu) / 40.0

    feat_spec_raw = spec[:, :, : cfg.nb_df, :]
    mag = torch.sqrt(feat_spec_raw[..., 0].square() + feat_spec_raw[..., 1].square())
    s = ema(mag, state["spec_norm"], cfg.alpha)
    feat_spec = feat_spec_raw / torch.sqrt(s + _SPEC_EPS)[..., None]
    return feat_erb, feat_spec, mu[:, -1], s[:, -1]


# --------------------------------------------------------------------------- #
# DPRNN
# --------------------------------------------------------------------------- #

def _dprnn_block(p: Params, x: Tensor, h_inter: Tensor, precision: str = "highest"
                 ) -> Tuple[Tensor, Tensor]:
    """Dual-path block on ``x [B,T,Fq,C]``; ``h_inter [B,Fq,C]`` is the
    time-GRU carry.  Intra: bidirectional GRU along frequency + fc + LN +
    residual.  Inter: GRU along time + fc + LN + residual.  Returns the
    new carry in float32.

    Packed params (``pack_dprnn_bidir``) run each stage as one fused kernel;
    with the v2 weights (``inter['whfc']``) and ``gru_kernels.v2_enabled``,
    the inter stage is ``dprnn_inter_block_v2`` on ``xp = x . Wi + bi``
    computed here and stored in bfloat16
    (``dpdfnet_tpu.models.dpdfnet._dprnn_fused``).  Raw params take the
    JAX package's route for them (``dpdfnet_tpu.models.dpdfnet._dprnn_block``):
    ``gru_bidir``, then linear + LayerNorm + residual; ``gru_seq`` along
    time, then linear + LayerNorm + residual."""
    B, T, Fq, C = x.shape
    intra, inter = p["intra"], p["inter"]
    packed = intra.get("packed")
    h0 = h_inter.float().contiguous()
    if packed is not None:
        x = gru_kernels.dprnn_intra_block(
            x.reshape(B * T, Fq, C), packed["wi2"], packed["wh2"], packed["b2"],
            intra["fc"]["w"], intra["fc"]["b"], intra["ln"]["g"], intra["ln"]["b"],
        ).reshape(B, T, Fq, C)
        g = inter["gru"]
        if "whfc" in inter and gru_kernels.v2_enabled(precision):
            xp = (x @ g["wi"].to(x.dtype) + g["bi"].to(x.dtype)).to(torch.bfloat16)
            return gru_kernels.dprnn_inter_block_v2(
                xp, x, h0, inter["whfc"], g["bh"], inter["fc"]["b"], inter["ln"]["g"],
                inter["ln"]["b"])
        return gru_kernels.dprnn_inter_block(
            x, h0, g["wi"], g["bi"], g["wh"], g["bh"],
            inter["fc"]["w"], inter["fc"]["b"], inter["ln"]["g"], inter["ln"]["b"])
    yi = onn.gru_bidir(intra["fw"], intra["bw"], x.reshape(B * T, Fq, C))
    yi = onn.layer_norm(intra["ln"], onn.linear(intra["fc"], yi))
    x = x + yi.reshape(B, T, Fq, C)
    xt = x.transpose(1, 2).reshape(B * Fq, T, C)
    yt, h_new = onn.gru_seq(inter["gru"], xt.contiguous(), h0=h0.reshape(B * Fq, C))
    yt = onn.layer_norm(inter["ln"], onn.linear(inter["fc"], yt))
    y = x + yt.reshape(B, Fq, T, C).transpose(1, 2).to(x.dtype)
    return y, h_new.reshape(B, Fq, C)


def _dprnn(p_blocks: List[Params], x: Tensor, hs: List[Tensor],
           stacked: Optional[Params] = None, precision: str = "highest",
           out_fm: bool = False):
    """The DPRNN stack.  Returns ``(out, new_hs)``; with ``out_fm=True``,
    ``(out, new_hs, layout)``: layout ``"fm"`` means out is the fm chain's
    native freq-leading ``[Fq, T, B, C]`` plane (the caller contracts its
    ``(f, c)`` axis with ``ops.nn.grouped_linear_fm``), ``"bt"`` the usual
    ``[B, T, Fq, C]`` (``dpdfnet_tpu.models.dpdfnet._dprnn``).

    With the branch's ``pack_stack`` bundle and
    ``gru_kernels.stack_enabled()``, one ``dprnn_stack`` call runs every
    block.  Otherwise packed params take the JAX package's
    ``_dprnn_fused`` routes: the fm chain where it engages (see
    :func:`_dprnn_fm`), else block by block, with planes carried in
    bfloat16 between the kernels under ``gru_kernels.plane_io_bf16``
    (float32 planes whose Fq is a multiple of 8, and not on the v2 path).
    The new hiddens keep each carried hidden's dtype."""
    if len(p_blocks) != len(hs):
        raise ValueError(
            f"state carries {len(hs)} DPRNN block hiddens but the model has "
            f"{len(p_blocks)} blocks — state from a different configuration?")
    x = x.contiguous()
    if p_blocks and stacked is not None and gru_kernels.stack_enabled():
        out, h_last = gru_kernels.dprnn_stack(
            x, torch.stack([h.float() for h in hs]), stacked)
        new_hs = [hl.to(h.dtype) for hl, h in zip(h_last, hs)]
        return (out, new_hs, "bt") if out_fm else (out, new_hs)
    packed = bool(p_blocks) and all(p["intra"].get("packed") is not None for p in p_blocks)
    B, T, Fq, C = x.shape
    use_v2 = gru_kernels.v2_enabled(precision)
    io_bf16 = (packed and x.dtype == torch.float32 and Fq % 8 == 0 and not use_v2
               and gru_kernels.plane_io_bf16(precision))
    pdt = torch.bfloat16 if io_bf16 else x.dtype
    if (packed and not use_v2 and Fq % 8 == 0 and B % 8 == 0 and B >= 32
            and gru_kernels.intra_tm_enabled()):
        plane, new_hs = _dprnn_fm(p_blocks, x, hs, pdt)
        if out_fm:
            return plane.to(x.dtype), new_hs, "fm"
        return plane.permute(2, 1, 0, 3).to(x.dtype).contiguous(), new_hs
    y = x.to(pdt)
    new_hs = []
    for p, h in zip(p_blocks, hs):
        y, h_new = _dprnn_block(p, y, h, precision)
        new_hs.append(h_new.to(h.dtype))
    y = y.to(x.dtype)
    return (y, new_hs, "bt") if out_fm else (y, new_hs)


def _dprnn_fm(p_blocks: List[Params], x: Tensor, hs: List[Tensor], pdt: torch.dtype
              ) -> Tuple[Tensor, List[Tensor]]:
    """The freq-major DPRNN chain (``_dprnn_fused``'s tm branch) on packed
    blocks, for ``x [B, T, Fq, C]`` with Fq and B multiples of 8 and
    B >= 32.  One permute into the freq-leading ``[Fq, T*B, C]`` plane at
    the plane dtype ``pdt`` (``gru_kernels.relayout_fm`` under
    ``DPDFNET_TPU_ENTRY_RELAYOUT``, else a PyTorch copy); then per block the
    intra kernel writes ``[T, Fq, B, C]``, whose ``[T, Fq*B, C]`` view the
    inter kernel reads, writing ``[Fq, T, B, C]``, the next intra's input.
    The hidden enters the inter kernel in the state's ``[B, Fq, C]`` with
    ``DPDFNET_TPU_H_INGEST``, else transposed to the rows' f-major order.
    Returns the chain's ``[Fq, T, B, C]`` plane at ``pdt`` and the new
    hiddens at each carried hidden's dtype."""
    B, T, Fq, C = x.shape
    if gru_kernels.entry_relayout_enabled():
        plane = gru_kernels.relayout_fm(x, out_dtype=pdt)
    else:
        plane = x.to(pdt).permute(2, 1, 0, 3).contiguous()
    plane = plane.reshape(Fq, T * B, C)
    use_hbm = gru_kernels.h_ingest_enabled()
    new_hs: List[Tensor] = []
    for p, h in zip(p_blocks, hs):
        intra, inter = p["intra"], p["inter"]
        pk, g = intra["packed"], inter["gru"]
        xi4 = gru_kernels.dprnn_intra_block(
            plane, pk["wi2"], pk["wh2"], pk["b2"], intra["fc"]["w"], intra["fc"]["b"],
            intra["ln"]["g"], intra["ln"]["b"], fm_batch=B)              # [T, Fq, B, C]
        h0 = h.float().contiguous() if use_hbm else \
            h.float().transpose(0, 1).reshape(Fq * B, C)
        out4, h_new = gru_kernels.dprnn_inter_block(
            xi4.reshape(T, Fq * B, C), h0, g["wi"], g["bi"], g["wh"], g["bh"],
            inter["fc"]["w"], inter["fc"]["b"], inter["ln"]["g"], inter["ln"]["b"],
            fm_batch=B, h_bm=use_hbm)                                    # [Fq, T, B, C]
        plane = out4.reshape(Fq, T * B, C)
        if not use_hbm:
            h_new = h_new.reshape(Fq, B, C).transpose(0, 1)
        new_hs.append(h_new.to(h.dtype).contiguous())
    return plane.reshape(Fq, T, B, C), new_hs


# --------------------------------------------------------------------------- #
# Squeezed GRU stack
# --------------------------------------------------------------------------- #

def _squeezed_gru(p: Params, x: Tensor, hs: List[Tensor], skip: str = "none",
                  skip_position: str = "output") -> Tuple[Tensor, List[Tensor]]:
    """Grouped linear in -> GRU layers -> grouped linear out, with the
    reference's two skip placements: ``"output"`` (SqueezedGRU_S, skip on
    the raw input after linear_out) and ``"inner"`` (legacy SqueezedGRU,
    skip on linear_in's output before linear_out)."""
    h = x_in = onn.grouped_linear(p["lin_in"], x, act="relu")
    if len(p["grus"]) != len(hs):
        raise ValueError(
            f"state carries {len(hs)} GRU hiddens but this SqueezedGRU has "
            f"{len(p['grus'])} layers — state from a different configuration?")
    new_hs: List[Tensor] = []
    n_layers = len(p["grus"])
    for li, (gp, h0) in enumerate(zip(p["grus"], hs)):
        if "groups" in gp:
            g = len(gp["groups"])
            h0s = [c.contiguous() for c in torch.chunk(h0, g, dim=-1)]
            h, h_lasts = onn.grouped_gru_seq(gp["groups"], h, h0s=h0s,
                                             shuffle_out=li < n_layers - 1)
            new_hs.append(torch.cat(h_lasts, dim=-1).to(h0.dtype))
        else:
            h, h_last = onn.gru_seq(gp, h.contiguous(), h0=h0)
            new_hs.append(h_last.to(h0.dtype))
    if skip_position == "inner":
        if skip == "identity":
            h = h + x_in
        elif skip == "groupedlinear":
            g, ig, _ = p["skip"]["w"].shape
            h = h + onn.grouped_linear(p["skip"], x_in[..., : g * ig])
        if "lin_out" in p:
            h = onn.grouped_linear(p["lin_out"], h, act="relu")
        return h, new_hs
    if "lin_out" in p:
        h = onn.grouped_linear(p["lin_out"], h, act="relu")
    if skip == "identity":
        h = h + x
    elif skip == "groupedlinear":
        # reference quirk: the loop-form GroupedLinear consumes only its
        # declared input size — the skip sees the first half of the input
        g, ig, _ = p["skip"]["w"].shape
        h = h + onn.grouped_linear(p["skip"], x[..., : g * ig])
    return h, new_hs


# --------------------------------------------------------------------------- #
# Encoder
# --------------------------------------------------------------------------- #

def _encoder(params: Params, cfg: ModelConfig, feat_erb: Tensor, feat_spec: Tensor,
             state: State, precision: str = "highest"):
    """Returns ((e0,e1,e2,e3), emb, c0, lsnr, state_updates)."""
    p = params["enc"]
    kt, kf = cfg.conv_kernel_inp
    _, kfc = cfg.conv_kernel
    s1, s2, s3 = cfg.erb_fstrides

    x_erb = feat_erb[..., None]                                  # [B,T,E,1]
    tail_in = state["erb_conv0_tail"]
    if cfg.hr:
        # full-band branch drops the Nyquist bin before conv0
        x_in, tail = x_erb[:, :, :-1, :], tail_in[:, :, :-1, :]
    else:
        x_in, tail = x_erb, tail_in
    new_erb_tail = torch.cat([tail_in.to(x_erb.dtype), x_erb], dim=1)[:, -2:]

    e0, _ = onn.conv_block(p["erb_conv0"], x_in, kt=kt, kf=kf, act="relu",
                           time_tail=tail)
    e1, _ = onn.conv_block(p["erb_conv1"], e0, kt=1, kf=kfc, fstride=s1, act="relu")
    e2, _ = onn.conv_block(p["erb_conv2"], e1, kt=1, kf=kfc, fstride=s2, act="relu")
    e3, _ = onn.conv_block(p["erb_conv3"], e2, kt=1, kf=kfc, fstride=s3, act="relu")
    # the df branch, and the erb branch of hr configs, feed only the
    # flattened-(f c) grouped linears: ask for the fm chain's native plane
    # and contract it there (grouped_linear_fm), as the JAX encoder does
    B, T = feat_erb.shape[:2]
    if cfg.hr:
        e3d, new_dprnn_erb, e3d_layout = _dprnn(
            p["dprnn_erb"], e3, state["dprnn_erb"], stacked=p.get("dprnn_erb_stacked"),
            precision=precision, out_fm=True)
    else:
        e3d, new_dprnn_erb = _dprnn(p["dprnn_erb"], e3, state["dprnn_erb"],
                                    stacked=p.get("dprnn_erb_stacked"), precision=precision)
        e3d_layout = "bt"

    c0, new_df_tail = onn.conv_block(p["df_conv0"], feat_spec, kt=kt, kf=kf,
                                     act="relu", time_tail=state["df_conv0_tail"])
    c1, _ = onn.conv_block(p["df_conv1"], c0, kt=1, kf=kfc, fstride=2, act="relu")
    c1d, new_dprnn_df, c1d_layout = _dprnn(p["dprnn_df"], c1, state["dprnn_df"],
                                           stacked=p.get("dprnn_df_stacked"),
                                           precision=precision, out_fm=True)

    if c1d_layout == "fm":
        cemb = onn.grouped_linear_fm(p["df_fc_emb"], c1d, act="relu")
    else:
        cemb = onn.grouped_linear(p["df_fc_emb"], c1d.reshape(B, T, -1), act="relu")
    if cfg.hr:
        if e3d_layout == "fm":
            emb = onn.grouped_linear_fm(p["erb_fc_emb"], e3d, act="relu")
        else:
            emb = onn.grouped_linear(p["erb_fc_emb"], e3d.reshape(B, T, -1), act="relu")
    else:
        emb = e3d.reshape(B, T, -1)
    emb = torch.cat([emb, cemb], dim=-1)
    emb, new_enc_gru = _squeezed_gru(p["emb_gru"], emb, state["enc_gru"],
                                     skip=cfg.emb_gru_skip)

    lsnr = torch.sigmoid(onn.linear(p["lsnr"], emb))[..., 0]
    lsnr = lsnr * (cfg.lsnr_max - cfg.lsnr_min) + cfg.lsnr_min

    updates = {
        "erb_conv0_tail": new_erb_tail,
        "df_conv0_tail": new_df_tail,
        "dprnn_erb": new_dprnn_erb,
        "dprnn_df": new_dprnn_df,
        "enc_gru": new_enc_gru,
    }
    return (e0, e1, e2, e3), emb, c0, lsnr, updates


# --------------------------------------------------------------------------- #
# Decoders
# --------------------------------------------------------------------------- #

def _erb_decoder(params: Params, cfg: ModelConfig, emb: Tensor, e0: Tensor,
                 e1: Tensor, e2: Tensor, e3: Tensor, hs: List[Tensor]
                 ) -> Tuple[Tensor, List[Tensor]]:
    """Predicts the gain mask m [B,T,mask_bins(+1 for hr)]."""
    p = params["erb_dec"]
    _, kfc = cfg.conv_kernel
    st3, st2, st1 = cfg.dec_fstrides
    C = cfg.conv_ch

    e, new_hs = _squeezed_gru(p["emb_gru"], emb, hs, skip=cfg.emb_gru_skip)
    if cfg.hr:
        e = onn.grouped_linear(p["erb_fc_emb"], e, act="relu")
    B, T = e.shape[:2]
    e = e.reshape(B, T, cfg.dec_f8, C)

    def up(pp, x, fstride):
        if fstride == 1:
            return onn.conv_block(pp, x, kt=1, kf=kfc, act="relu")[0]
        if cfg.upsample == "transpose":
            return onn.conv_transpose_block(pp, x, kf=kfc, fstride=fstride, act="relu")
        return onn.subpixel_block(pp, x, kf=kfc, fstride=fstride, act="relu")

    def pconv(pp, x):
        # 1x1 pathway convs are depthwise
        return onn.conv_block(pp, x, kt=1, kf=1, act="relu")[0]

    x3 = up(p["convt3"], pconv(p["conv3p"], e3) + e, st3)
    x2 = up(p["convt2"], pconv(p["conv2p"], e2) + x3, st2)
    x1 = up(p["convt1"], pconv(p["conv1p"], e1) + x2, st1)
    m, _ = onn.conv_block(p["conv0_out"], pconv(p["conv0p"], e0) + x1,
                          kt=1, kf=kfc, act="sigmoid")
    m = m[..., 0]                                                # [B,T,E0]
    if cfg.hr:
        # mirror-duplicate the top bin: 480 -> 481 bins
        m = torch.cat([m, m[:, :, -2:-1]], dim=-1)
    return m, new_hs


def _df_decoder(params: Params, cfg: ModelConfig, emb: Tensor, c0: Tensor,
                state: State) -> Tuple[Tensor, State]:
    """Predicts DF coefficients [B,T,nb_df,O,2]."""
    p = params["df_dec"]
    c, new_hs = _squeezed_gru(p["df_gru"], emb, state["df_gru"])
    c = c + onn.grouped_linear(p["df_skip"], emb)
    c0p, new_tail = onn.conv_block(p["df_convp"], c0, kt=cfg.df_kt, kf=1, act="relu",
                                   time_tail=state["df_convp_tail"])
    c = onn.grouped_linear(p["df_out"], c, act="tanh")
    B, T = c.shape[:2]
    c = c.reshape(B, T, cfg.nb_df, 2 * cfg.df_order) + c0p
    coefs = c.reshape(B, T, cfg.nb_df, cfg.df_order, 2)
    return coefs, {"df_gru": new_hs, "df_convp_tail": new_tail}


# --------------------------------------------------------------------------- #
# Mask application + deep filtering
# --------------------------------------------------------------------------- #

def _apply_df(cfg: ModelConfig, dfin: Tensor, coefs: Tensor, state: State):
    """5-frame DF window over ``dfin`` x 2-frame-delayed coefs.  Returns
    (lower, middle_frame, state updates); ``middle`` is dfin[t-2]."""
    T = dfin.shape[1]
    nb, O = cfg.nb_df, cfg.df_order
    y_ext = torch.cat([state["df_spec_tail"].to(dfin.dtype), dfin], dim=1)
    win = torch.stack([y_ext[:, n: n + T, :nb] for n in range(O)], dim=2)
    coefs_ext = torch.cat([state["df_coefs_tail"].to(coefs.dtype), coefs], dim=1)
    cd = coefs_ext[:, :T].transpose(2, 3)                        # [B,T,O,nb,2]

    wr, wi = win[..., 0], win[..., 1]
    cr, ci = cd[..., 0], cd[..., 1]
    out_r = (wr * cr - wi * ci).sum(dim=2)
    out_i = (wr * ci + wi * cr).sum(dim=2)
    lower = torch.stack([out_r, out_i], dim=-1)                  # [B,T,nb,2]
    middle = y_ext[:, 2: 2 + T]
    updates = {"df_spec_tail": y_ext[:, -4:], "df_coefs_tail": coefs_ext[:, -2:]}
    return lower, middle, updates


def valin_post_filter(mask: Tensor, beta: float = 0.02, eps: float = 1e-12) -> Tensor:
    """Valin et al. perceptual post-filter on a real gain mask."""
    mask_sin = mask * torch.sin(torch.pi * mask / 2)
    ratio = mask / torch.clamp(mask_sin, min=eps)
    return (1 + beta) * mask / (1 + beta * ratio * ratio)


def clamp_mask_atten_lim(mask: Tensor, atten_lim_db: Tensor) -> Tensor:
    """Floor the gain mask ``[B, T, Fe]`` at ``10^(-atten_lim_db/20)`` per utterance."""
    floor = 10.0 ** (-atten_lim_db.to(mask.dtype) / 20.0)
    return torch.maximum(mask, floor[:, None, None])


def _mask_and_df(params: Params, cfg: ModelConfig, spec: Tensor, m: Tensor,
                 coefs: Tensor, state: State, atten_lim_db: Optional[Tensor] = None):
    """Gain mask + deep filter combined per ``cfg.mask_method``."""
    T = spec.shape[1]
    nb = cfg.nb_df
    if cfg.hr:
        mask = m                                                  # per-bin
    else:
        if cfg.post_filter:
            m = valin_post_filter(m)
        if atten_lim_db is not None:
            m = clamp_mask_atten_lim(m, torch.as_tensor(atten_lim_db, device=m.device))
        mask = m @ params["erb_inv_fb"].to(m.dtype)               # [B,T,F]

    def delayed_masked(x):
        ext = torch.cat([state["mask_spec_tail"].to(x.dtype), x], dim=1)
        return ext[:, :T] * mask[..., None], ext[:, -2:]

    if cfg.mask_method == "before_df":
        masked, new_mask_tail = delayed_masked(spec)
        lower, middle, updates = _apply_df(cfg, masked, coefs, state)
        spec_e = torch.cat([lower, middle[:, :, nb:]], dim=2)
    elif cfg.mask_method == "separate":
        masked, new_mask_tail = delayed_masked(spec)
        lower, _middle, updates = _apply_df(cfg, spec, coefs, state)
        spec_e = torch.cat([lower, masked[:, :, nb:]], dim=2)
    elif cfg.mask_method == "after_df":
        lower, middle, updates = _apply_df(cfg, spec, coefs, state)
        dfed = torch.cat([lower, middle[:, :, nb:]], dim=2)
        spec_e, new_mask_tail = delayed_masked(dfed)
    else:
        raise ValueError(f"unknown mask_method: {cfg.mask_method!r}")
    updates["mask_spec_tail"] = new_mask_tail
    return spec_e, updates


# --------------------------------------------------------------------------- #
# Full forward
# --------------------------------------------------------------------------- #

def forward_spec(params: Params, cfg: ModelConfig, spec: Tensor, state: State, *,
                 atten_lim_db: Optional[Tensor] = None, precision: str = "highest"
                 ) -> Tuple[Tensor, State, Tensor]:
    """Enhance ``spec: [B, T, F, 2]``; returns (spec_e, new_state, lsnr [B,T]).
    ``atten_lim_db`` ([B], 16 kHz configs) floors the ERB gain mask;
    ``precision`` is the tier's matmul precision (see the module notes)."""
    feat_erb, feat_spec, mu_last, s_last = _features(params, cfg, spec, state)
    (e0, e1, e2, e3), emb, c0, lsnr, enc_up = _encoder(params, cfg, feat_erb,
                                                        feat_spec, state, precision)
    m, new_erb_dec = _erb_decoder(params, cfg, emb, e0, e1, e2, e3, state["erb_dec_gru"])
    coefs, df_up = _df_decoder(params, cfg, emb, c0, state)
    spec_e, mask_up = _mask_and_df(params, cfg, spec, m, coefs, state,
                                   atten_lim_db=atten_lim_db)

    new_state = dict(state)
    new_state["erb_norm"] = mu_last
    new_state["spec_norm"] = s_last
    new_state.update(enc_up)
    new_state["erb_dec_gru"] = new_erb_dec
    new_state.update(df_up)
    new_state.update(mask_up)
    return spec_e, new_state, lsnr
