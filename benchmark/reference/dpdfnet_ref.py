"""Plain PyTorch reference of DPDFNet, in float32, for the benchmark's
``correct``.

It follows the published model (ceva-ip/DPDFNet ``model/dpdfnet.py`` and
``model/dpdfnet_48khz_hr.py``) on the raw weight tree that the benchmark
makes (``benchmark/harness/weights.py``): separable convs with their
pointwise stage and eval-mode batch norm applied as written, every GRU
as ``torch.nn.functional``-level cuDNN / ATen GRU calls, the DPRNN blocks
as bidirectional GRU along frequency then GRU along time, each followed by
linear + LayerNorm + residual.  Nothing is fused, packed, folded or
cached, and the whole sequence runs as one pass from the initial state:
the streaming state the program carries from call to call is worked out
again here by running every frame from the first.

It imports nothing of the program.  Everything runs at the tensors'
device; the caller sets the math mode (TF32 off for the reference, on for
the lower-precision control).

Entry points:

- :func:`forward_spec` ``(params, cfg, spec [B, T, F, 2]) -> spec_e``;
- :func:`enhance_offline` ``(params, cfg, wavs [B, S]) -> [B, S]``: the
  offline pipeline (centred STFT, forward, iSTFT, the ``2 * win``
  alignment);
- :func:`enhance_stream` ``(params, cfg, signals [B, H * hop]) ->
  [B, (H - 1) * hop]``: what a streaming pool commits after ``H`` hops
  (causal frames, rfft / irfft, overlap-add of windowed frames).

``cfg`` is the configuration file's dict (``benchmark/configs/*.json``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import init_norms

Tensor = torch.Tensor


# --------------------------------------------------------------------------- #
# Shapes derived from the configuration
# --------------------------------------------------------------------------- #

class Shapes:
    """The sizes the forward needs, worked out from the config dict."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.hr = bool(cfg["hr"])
        self.win = int(cfg["n_fft"])
        self.hop = int(cfg["hop"])
        self.F = self.win // 2 + 1
        self.C = int(cfg["conv_ch"])
        self.nb_erb = int(cfg["nb_erb"])
        self.nb_df = int(cfg["nb_df"])
        self.order = int(cfg["df_order"])
        self.df_kt = int(cfg["df_kt"])
        self.kt, self.kf = (int(v) for v in cfg["conv_kernel_inp"])
        self.kfc = int(cfg["conv_kernel"][1])
        self.alpha = float(cfg["alpha"])
        self.erb_in = self.win // 2 if self.hr else self.nb_erb
        self.erb_fstrides = (3, 2, 2) if self.hr else (2, 2, 1)
        widths = [self.erb_in]
        for s in self.erb_fstrides:
            widths.append(-(-widths[-1] // s))
        self.erb_widths = tuple(widths)
        self.dec_fstrides = (2, 2, 3) if self.hr else (1, 2, 2)
        self.wnorm = 1.0 / (self.win ** 2 / (2.0 * self.hop))


def vorbis_window(n: int) -> np.ndarray:
    half = n / 2.0
    k = np.arange(n, dtype=np.float64)
    s = np.sin(0.5 * np.pi * (k + 0.5) / half)
    return np.sin(0.5 * np.pi * s * s).astype(np.float32)


# --------------------------------------------------------------------------- #
# Layers
# --------------------------------------------------------------------------- #

def _act(x: Tensor, act: Optional[str]) -> Tensor:
    if act is None:
        return x
    return {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}[act](x)


def conv_block(p: dict, x: Tensor, *, kt: int, kf: int, fstride: int = 1,
               act: Optional[str] = "relu") -> Tensor:
    """Causal conv over ``x [B, T, F, Cin]`` with an HWIO weight
    ``[kt, kf, Cin/groups, Cout]``: ``kt - 1`` zero frames before the
    first (the initial state), ``kf // 2`` zero bins on each side, stride
    ``fstride`` along frequency; then bias, pointwise, batch norm (eval)
    and the activation."""
    w = p["w"]
    groups = x.shape[-1] // w.shape[2]
    xc = x.permute(0, 3, 1, 2)                                   # [B, C, T, F]
    xc = F.pad(xc, (kf // 2, kf // 2, kt - 1, 0))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=(1, fstride), groups=groups)
    return _epilogue(p, y.permute(0, 2, 3, 1), act)


def _epilogue(p: dict, y: Tensor, act: Optional[str]) -> Tensor:
    if p.get("b") is not None:
        y = y + p["b"]
    if p.get("pw") is not None:
        y = y @ p["pw"]["w"]
    if p.get("bn") is not None:
        y = y * p["bn"]["scale"] + p["bn"]["shift"]
    return _act(y, act)


def subpixel_block(p: dict, x: Tensor, *, kf: int, fstride: int,
                   act: Optional[str] = "relu") -> Tensor:
    """Sub-pixel upsampling along frequency: a conv to ``Cout * fstride``
    channels (channel ``c * fstride + i`` is sub-position ``i`` of output
    channel ``c``), interleaved into ``fstride`` times the bins."""
    w = p["w"]
    groups = x.shape[-1] // w.shape[2]
    xc = F.pad(x.permute(0, 3, 1, 2), (kf // 2, kf // 2))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), groups=groups).permute(0, 2, 3, 1)
    if p.get("b") is not None:
        y = y + p["b"]
    B, T, f, sc = y.shape
    c = sc // fstride
    y = y.reshape(B, T, f, c, fstride).transpose(-1, -2).reshape(B, T, f * fstride, c)
    if p.get("pw") is not None:
        y = y @ p["pw"]["w"]
    if p.get("bn") is not None:
        y = y * p["bn"]["scale"] + p["bn"]["shift"]
    return _act(y, act)


def grouped_linear(p: dict, x: Tensor, act: Optional[str] = None) -> Tensor:
    """Block-diagonal linear, ``w [G, I/G, O/G]``."""
    g, ig, og = p["w"].shape
    lead = x.shape[:-1]
    y = torch.einsum("mgi,gio->mgo", x.reshape(-1, g, ig), p["w"])
    return _act(y.reshape(lead + (g * og,)) + p["b"], act)


def linear(p: dict, x: Tensor, act: Optional[str] = None) -> Tensor:
    y = x @ p["w"]
    if p.get("b") is not None:
        y = y + p["b"]
    return _act(y, act)


def layer_norm(p: dict, x: Tensor) -> Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], 1e-5)


def _gru_weights(p: dict) -> List[Tensor]:
    """torch's GRU layout (``weight_ih [3H, I]``, ``weight_hh [3H, H]``,
    ``bias_ih``, ``bias_hh``; gates r, z, n) from ``wi [I, 3H]``,
    ``wh [H, 3H]``, ``bi``, ``bh``."""
    return [p["wi"].t().contiguous(), p["wh"].t().contiguous(), p["bi"], p["bh"]]


def gru(p: dict, x: Tensor) -> Tensor:
    """GRU along dim 1 of ``x [N, L, I]`` from zero state; ``[N, L, H]``."""
    H = p["wh"].shape[0]
    h0 = x.new_zeros((1, x.shape[0], H))
    out, _ = torch._VF.gru(x.contiguous(), h0, _gru_weights(p), True, 1, 0.0, False,
                           False, True)
    return out


def gru_bidir(p_fw: dict, p_bw: dict, x: Tensor) -> Tensor:
    """Bidirectional GRU along dim 1 from zero state: ``[fw, bw]`` on the
    last axis."""
    H = p_fw["wh"].shape[0]
    h0 = x.new_zeros((2, x.shape[0], H))
    out, _ = torch._VF.gru(x.contiguous(), h0, _gru_weights(p_fw) + _gru_weights(p_bw),
                           True, 1, 0.0, False, True, True)
    return out


def ema(x: Tensor, init: Tensor, alpha: float) -> Tensor:
    """``m_t = alpha * m_{t-1} + (1 - alpha) * x_t`` along dim 1 of
    ``x [B, T, F]`` from ``m_{-1} = init``; every ``m_t``."""
    m = init.to(x).expand(x.shape[0], x.shape[-1])
    out = []
    for t in range(x.shape[1]):
        m = alpha * m + (1.0 - alpha) * x[:, t]
        out.append(m)
    return torch.stack(out, dim=1)


# --------------------------------------------------------------------------- #
# Model
# --------------------------------------------------------------------------- #

def _dprnn(blocks: List[dict], x: Tensor) -> Tensor:
    """DPRNN stack on ``x [B, T, Fq, C]``: per block, bidirectional GRU
    along Fq + linear + LayerNorm + residual, then GRU along T (from zero
    state) + linear + LayerNorm + residual."""
    B, T, Fq, C = x.shape
    for p in blocks:
        intra, inter = p["intra"], p["inter"]
        yi = gru_bidir(intra["fw"], intra["bw"], x.reshape(B * T, Fq, C))
        x = x + layer_norm(intra["ln"], linear(intra["fc"], yi)).reshape(B, T, Fq, C)
        xt = x.transpose(1, 2).reshape(B * Fq, T, C)
        yt = layer_norm(inter["ln"], linear(inter["fc"], gru(inter["gru"], xt)))
        x = x + yt.reshape(B, Fq, T, C).transpose(1, 2)
    return x


def _squeezed_gru(p: dict, x: Tensor) -> Tensor:
    h = grouped_linear(p["lin_in"], x, act="relu")
    for gp in p["grus"]:
        h = gru(gp, h)
    if "lin_out" in p:
        h = grouped_linear(p["lin_out"], h, act="relu")
    return h


def forward_spec(params: Dict, cfg: dict, spec: Tensor) -> Tensor:
    """Enhance ``spec [B, T, F, 2]`` (wnorm-scaled STFT frames) from the
    initial state; output frame ``t`` is the enhanced input frame
    ``t - 2``."""
    sh = Shapes(cfg)
    B, T = spec.shape[:2]
    C, kt, kf, kfc = sh.C, sh.kt, sh.kf, sh.kfc
    dev = spec.device

    # features: dB magnitude (48 kHz full band) or dB ERB power, less its
    # running mean; the first nb_df bins over their running magnitude
    power = spec[..., 0].square() + spec[..., 1].square()
    if sh.hr:
        erb_raw = 10.0 * torch.log10(torch.sqrt(power) + 1e-10)
        mu0 = init_norms.mag_norm_init(sh.F)
    else:
        erb_raw = 10.0 * torch.log10(power @ params["erb_fb"] + 1e-10)
        mu0 = init_norms.erb_norm_init(sh.nb_erb)
    mu = ema(erb_raw, torch.as_tensor(mu0, device=dev), sh.alpha)
    feat_erb = (erb_raw - mu) / 40.0
    spec_lo = spec[:, :, :sh.nb_df]
    mag = torch.sqrt(spec_lo[..., 0].square() + spec_lo[..., 1].square())
    s = ema(mag, torch.as_tensor(init_norms.spec_norm_init(sh.nb_df, sh.hr), device=dev),
            sh.alpha)
    feat_spec = spec_lo / torch.sqrt(s + 1e-12)[..., None]

    # encoder
    enc = params["enc"]
    s1, s2, s3 = sh.erb_fstrides
    x_erb = feat_erb[..., None]
    if sh.hr:
        x_erb = x_erb[:, :, :-1]                   # the Nyquist bin is dropped
    e0 = conv_block(enc["erb_conv0"], x_erb, kt=kt, kf=kf)
    e1 = conv_block(enc["erb_conv1"], e0, kt=1, kf=kfc, fstride=s1)
    e2 = conv_block(enc["erb_conv2"], e1, kt=1, kf=kfc, fstride=s2)
    e3 = conv_block(enc["erb_conv3"], e2, kt=1, kf=kfc, fstride=s3)
    e3d = _dprnn(enc["dprnn_erb"], e3)
    c0 = conv_block(enc["df_conv0"], feat_spec, kt=kt, kf=kf)
    c1 = conv_block(enc["df_conv1"], c0, kt=1, kf=kfc, fstride=2)
    c1d = _dprnn(enc["dprnn_df"], c1)
    cemb = grouped_linear(enc["df_fc_emb"], c1d.reshape(B, T, -1), act="relu")
    if sh.hr:
        emb = grouped_linear(enc["erb_fc_emb"], e3d.reshape(B, T, -1), act="relu")
    else:
        emb = e3d.reshape(B, T, -1)
    emb = _squeezed_gru(enc["emb_gru"], torch.cat([emb, cemb], dim=-1))

    # ERB decoder: the gain mask
    dec = params["erb_dec"]
    e = _squeezed_gru(dec["emb_gru"], emb)
    if sh.hr:
        e = grouped_linear(dec["erb_fc_emb"], e, act="relu")
    e = e.reshape(B, T, sh.erb_widths[3], C)
    st3, st2, st1 = sh.dec_fstrides

    def up(pp, x, fstride):
        if fstride == 1:
            return conv_block(pp, x, kt=1, kf=kfc)
        return subpixel_block(pp, x, kf=kfc, fstride=fstride)

    def pconv(pp, x):
        return conv_block(pp, x, kt=1, kf=1)

    x3 = up(dec["convt3"], pconv(dec["conv3p"], e3) + e, st3)
    x2 = up(dec["convt2"], pconv(dec["conv2p"], e2) + x3, st2)
    x1 = up(dec["convt1"], pconv(dec["conv1p"], e1) + x2, st1)
    m = conv_block(dec["conv0_out"], pconv(dec["conv0p"], e0) + x1, kt=1, kf=kfc,
                   act="sigmoid")[..., 0]
    if sh.hr:
        m = torch.cat([m, m[:, :, -2:-1]], dim=-1)  # 480 -> 481 bins
        mask = m
    else:
        mask = m @ params["erb_inv_fb"]

    # DF decoder: the deep-filter coefficients
    dfd = params["df_dec"]
    c = _squeezed_gru(dfd["df_gru"], emb) + grouped_linear(dfd["df_skip"], emb)
    c0p = conv_block(dfd["df_convp"], c0, kt=sh.df_kt, kf=1)
    c = grouped_linear(dfd["df_out"], c, act="tanh")
    coefs = (c.reshape(B, T, sh.nb_df, 2 * sh.order) + c0p).reshape(
        B, T, sh.nb_df, sh.order, 2)

    # the mask on the spectrum delayed two frames, then the deep filter:
    # five masked frames ending two frames ahead of the delayed coefficients
    zeros = spec.new_zeros
    masked = torch.cat([zeros((B, 2) + spec.shape[2:]), spec], dim=1)[:, :T] * mask[..., None]
    y_ext = torch.cat([zeros((B, 4) + spec.shape[2:]), masked], dim=1)
    win = torch.stack([y_ext[:, n:n + T, :sh.nb_df] for n in range(sh.order)], dim=2)
    cd = torch.cat([zeros((B, 2) + coefs.shape[2:]), coefs], dim=1)[:, :T].transpose(2, 3)
    wr, wi, cr, ci = win[..., 0], win[..., 1], cd[..., 0], cd[..., 1]
    lower = torch.stack([(wr * cr - wi * ci).sum(dim=2), (wr * ci + wi * cr).sum(dim=2)],
                        dim=-1)
    return torch.cat([lower, y_ext[:, 2:2 + T, sh.nb_df:]], dim=2)


# --------------------------------------------------------------------------- #
# Waveform in, waveform out
# --------------------------------------------------------------------------- #

def _spec(frames: Tensor, window: Tensor, wnorm: float) -> Tensor:
    z = torch.fft.rfft(frames * window, dim=-1)
    return torch.stack([z.real, z.imag], dim=-1) * wnorm


def _frames_out(spec_e: Tensor, window: Tensor, wnorm: float, win: int) -> Tensor:
    out = spec_e / wnorm
    return torch.fft.irfft(torch.complex(out[..., 0], out[..., 1]), n=win, dim=-1) * window


def enhance_offline(params: Dict, cfg: dict, wavs: Tensor) -> Tensor:
    """The offline pipeline on ``wavs [B, S]``: ``win`` zeros appended,
    centred frames (reflect padding of ``win // 2``), the forward, the
    windowed overlap-add divided by the window's sum of squares, and the
    ``2 * win`` alignment (two frames of lookahead, two of deep-filter
    delay).  Output ``[B, S']`` with ``S' = S + win - 2 * win`` rounded
    to frames; sample ``i`` is the enhanced input sample ``i``."""
    sh = Shapes(cfg)
    win, hop = sh.win, sh.hop
    window = torch.as_tensor(vorbis_window(win), device=wavs.device)
    x = F.pad(wavs, (0, win))
    x = F.pad(x[:, None], (win // 2, win // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, win, hop)                              # [B, T, win]
    y = _frames_out(forward_spec(params, cfg, _spec(frames, window, sh.wnorm)), window,
                    sh.wnorm, win)
    B, T, _ = y.shape
    total = win + hop * (T - 1)
    out = y.new_zeros((B, total))
    wss = torch.zeros(total, dtype=torch.float64)
    w2 = torch.as_tensor(vorbis_window(win), dtype=torch.float64).square()
    for t in range(T):
        out[:, t * hop:t * hop + win] += y[:, t]
        wss[t * hop:t * hop + win] += w2
    wss = torch.where(wss > 1e-11, wss, torch.ones_like(wss)).to(out)
    out = (out / wss)[:, win // 2: total - win // 2]
    return out[:, 2 * win:]


def enhance_stream(params: Dict, cfg: dict, signals: Tensor) -> Tensor:
    """What a streaming enhancer commits after ``H`` hops of ``signals
    [B, H * hop]``: causal frames ``[k * hop, k * hop + win)`` for the
    ``H - 1`` whole windows, the forward from the initial state, windowed
    output frames, and hop ``k`` of the output = the first half of frame
    ``k`` plus the second half of frame ``k - 1``.  ``[B, (H - 1) * hop]``."""
    sh = Shapes(cfg)
    win, hop = sh.win, sh.hop
    if win != 2 * hop:
        raise ValueError("the overlap-add here is for 50% overlap")
    window = torch.as_tensor(vorbis_window(win), device=signals.device)
    frames = signals.unfold(-1, win, hop)                         # [B, H - 1, win]
    y = _frames_out(forward_spec(params, cfg, _spec(frames, window, sh.wnorm)), window,
                    sh.wnorm, win)
    tails = F.pad(y[:, :-1, hop:], (0, 0, 1, 0))
    return (y[:, :, :hop] + tails).reshape(y.shape[0], -1)


def gap(got: np.ndarray, ref: np.ndarray) -> tuple:
    """(relative RMS error, largest error over the reference's RMS) of
    one output against the reference, in float64."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    rms = math.sqrt(float(np.mean(ref * ref))) if ref.size else 0.0
    if rms == 0.0:
        return (0.0, 0.0) if not np.any(got) else (math.inf, math.inf)
    d = got - ref
    return math.sqrt(float(np.mean(d * d))) / rms, float(np.max(np.abs(d))) / rms
