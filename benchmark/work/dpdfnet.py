"""The work DPDFNet does, from its configuration's shapes.

FLOPs count a multiply-add as 2; the network's layers are counted as the
published model computes them (separable convs as depthwise + pointwise,
GRUs as their two matrix products), whatever form the program runs.  The
STFT and iSTFT, the feature normalisers, the activations and the
batch-norm affines are left out, so the count is a lower bound of the
work and a share of a peak built on it cannot pass 100%.

``frame_flops(cfg)``: one frame of one stream through the network.

The DPRNN stages (one intra or inter stage of one block over ``rows``
row-steps, a row-step being one frequency position of one frame of one
stream) follow the per-row-step counts of the program's kernel A/B tool:
intra ``28 C^2`` (two GRU directions of ``12 C^2`` and the ``2C -> C``
linear), inter ``14 C^2`` (one GRU and the ``C -> C`` linear).  Bytes
count each input row read once and each output row written once in
float32, the inter stage's carried hidden in and out, and the stage's
weights once per launch.
"""

from __future__ import annotations

from typing import Dict, Tuple


def _erb_widths(cfg: dict) -> Tuple[int, int, int, int]:
    f = cfg["n_fft"] // 2 if cfg["hr"] else cfg["nb_erb"]
    widths = [f]
    for s in ((3, 2, 2) if cfg["hr"] else (2, 2, 1)):
        widths.append(-(-widths[-1] // s))
    return tuple(widths)


def dprnn_fq(cfg: dict) -> Dict[str, int]:
    """Frequency positions of the two DPRNN branches."""
    return {"erb": _erb_widths(cfg)[3], "df": cfg["nb_df"] // 2}


def _gru(i: int, h: int) -> int:
    return 2 * 3 * h * (i + h)


def _gl(i: int, o: int, g: int) -> int:
    return 2 * i * o // g


def frame_flops(cfg: dict) -> Dict[str, int]:
    """FLOPs of one frame of one stream, by part of the network."""
    C, H, nb, O = cfg["conv_ch"], cfg["gru_dim"], cfg["nb_df"], cfg["df_order"]
    kt, kf = cfg["conv_kernel_inp"]
    kfc = cfg["conv_kernel"][1]
    hr = cfg["hr"]
    lg, elg = cfg["lin_groups"], cfg["enc_lin_groups"]
    e0, e1, e2, e3 = _erb_widths(cfg)
    fq = dprnn_fq(cfg)
    emb_in = cfg["emb_dim"] if hr else C * cfg["nb_erb"] // 4
    emb_out = C * cfg["nb_erb"] // 4
    F = cfg["n_fft"] // 2 + 1
    pw = 2 * C * C
    enc = (2 * kt * kf * C * e0                                   # erb_conv0
           + (2 * kfc * C + pw) * (e1 + e2 + e3)                 # erb_conv1..3
           + (2 * kt * kf * C + pw) * nb                         # df_conv0 (2 groups)
           + (2 * kfc * C + pw) * (nb // 2)                      # df_conv1
           + _gl(C * nb // 2, emb_in, elg)                       # df_fc_emb
           + (_gl(C * fq["erb"], emb_in, elg) if hr else 0)      # erb_fc_emb
           + _gl(2 * emb_in, H, lg) + _gru(H, H) + _gl(H, emb_out, lg)  # emb_gru
           + 2 * emb_out)                                        # lsnr
    dprnn = cfg["dprnn_blocks"] * 42 * C * C * (fq["erb"] + fq["df"])
    st3, st2, st1 = (2, 2, 3) if hr else (1, 2, 2)
    up = sum((2 * kfc * C * st + pw * st) * f_in
             for st, f_in in ((st3, e3), (st2, e2), (st1, e1)))
    erb_dec = (_gl(emb_out, H, lg) + 2 * _gru(H, H)
               + _gl(H, cfg["emb_dim"] if hr else emb_out, lg)
               + (_gl(cfg["emb_dim"], C * fq["erb"], elg) if hr else 0)
               + 2 * C * (e3 + e2 + e1 + e0)                     # pathway 1x1 convs
               + up
               + 2 * kfc * C * e0                                # conv0_out
               + (0 if hr else 2 * cfg["nb_erb"] * F))           # ERB mask to bins
    df_dec = (_gl(emb_out, H, 8) + 2 * _gru(H, H) + _gl(emb_out, H, lg)
              + _gl(H, nb * 2 * O, lg)
              + (2 * cfg["df_kt"] * (C // 2) * 2 * O + 2 * (2 * O) ** 2) * nb  # df_convp
              + 8 * nb * O + 2 * F)                              # deep filter, mask
    return {"encoder": enc, "dprnn": dprnn, "erb_decoder": erb_dec, "df_decoder": df_dec}


def frame_flops_total(cfg: dict) -> int:
    return sum(frame_flops(cfg).values())


def dprnn_stage(cfg: dict, stage: str, streams: int, frames: int, fq: int
                ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch of a DPRNN stage (``"intra"`` or
    ``"inter"``) over ``streams`` x ``frames`` frames at ``fq`` positions."""
    C = cfg["conv_ch"]
    rows = streams * frames * fq
    if stage == "intra":
        flops = 28 * C * C * rows
        weights = 2 * (2 * 3 * C * C + 2 * 3 * C) + 2 * C * C + C + 2 * C
        nbytes = 2 * C * 4 * rows + 4 * weights
    else:
        flops = 14 * C * C * rows
        weights = 2 * 3 * C * C + 2 * 3 * C + C * C + C + 2 * C
        nbytes = 2 * C * 4 * rows + 2 * streams * fq * C * 4 + 4 * weights
    return float(flops), float(nbytes)


def dprnn_bound_s(cfg: dict, streams: int, frames: int, peak_flops: float,
                  peak_bytes: float) -> float:
    """Least seconds the DPRNN stages of one forward over ``streams`` x
    ``frames`` (one launch per stage, block and branch) could take: per
    launch the larger of FLOPs over the peak and bytes over the memory
    rate, summed."""
    total = 0.0
    for fq in dprnn_fq(cfg).values():
        for stage in ("intra", "inter"):
            f, b = dprnn_stage(cfg, stage, streams, frames, fq)
            total += max(f / peak_flops, b / peak_bytes)
    return total * cfg["dprnn_blocks"]
