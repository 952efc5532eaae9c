"""Neural-net primitives in plain PyTorch: convs, grouped linears, GRUs,
norms, EMA recurrences.

Counterpart of ``dpdfnet_tpu.ops.nn``.  Layouts match the JAX package at
every public function: ``[B, T, F, C]`` for 2-D feature maps, ``[B, T, C]``
for sequences, conv weights HWIO ``[kt, kf, Cin/groups, Cout]`` (turned
into PyTorch's OIHW at the call), GRU weights ``wi [I, 3H]``,
``wh [H, 3H]`` with torch's (r, z, n) gate packing.

``[B, T, F, C]`` permuted to ``[B, C, T, F]`` is exactly PyTorch's
channels-last memory format, so the convs run on the plane without a copy.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def apply_act(x: Tensor, act: Optional[str]) -> Tensor:
    if act is None or act == "identity":
        return x
    if act == "relu":
        return torch.relu(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    if act == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unknown activation {act!r}")


# --------------------------------------------------------------------------- #
# Convolution blocks
# --------------------------------------------------------------------------- #

def _conv2d(x: Tensor, w_hwio: Tensor, *, stride: int, fpad: Tuple[int, int],
            groups: int, fdilate: int = 1) -> Tensor:
    """NHWC conv over ``x [B, T, F, Cin]`` with an HWIO weight; time is
    unpadded (the caller extends it causally), frequency padded ``fpad``.
    ``fdilate > 1`` inserts zeros between input bins (a fractionally
    strided conv, JAX's ``lhs_dilation``)."""
    xc = x.permute(0, 3, 1, 2)                                   # [B,C,T,F]
    if fdilate > 1:
        B, C, T, Fb = xc.shape
        xd = xc.new_zeros((B, C, T, (Fb - 1) * fdilate + 1))
        xd[..., ::fdilate] = xc
        xc = xd
    if fpad != (0, 0):
        xc = F.pad(xc, (fpad[0], fpad[1]))
    w = w_hwio.permute(3, 2, 0, 1)                               # OIHW
    if x.is_cuda:
        xc = xc.contiguous(memory_format=torch.channels_last)
        w = w.contiguous(memory_format=torch.channels_last)
    y = F.conv2d(xc, w.to(x.dtype), stride=(1, stride), groups=groups)
    return y.permute(0, 2, 3, 1)                                 # [B,T,F,C]


def conv_block(
    p: dict,
    x: Tensor,
    *,
    kt: int,
    kf: int,
    fstride: int = 1,
    act: Optional[str] = "relu",
    time_tail: Optional[Tensor] = None,
) -> Tuple[Tensor, Optional[Tensor]]:
    """Causal Conv2d + optional pointwise + BN(eval) + activation.

    Groups are inferred from the weight shape (``Cin // w.shape[2]``), so
    the separable (depthwise + ``pw``) and the fused dense trees run through
    the same code.  ``time_tail`` is the carried ``[B, kt-1, F, Cin]``
    context (zeros == offline causal zero-pad).  Returns ``(y, new_tail)``.
    """
    new_tail = None
    if kt > 1:
        if time_tail is None:
            time_tail = x.new_zeros((x.shape[0], kt - 1) + tuple(x.shape[2:]))
        x = torch.cat([time_tail.to(x.dtype), x], dim=1)
        new_tail = x[:, -(kt - 1):]
    w = p["w"]
    groups = x.shape[-1] // w.shape[2]
    if (kt == 1 and kf == 1 and fstride == 1 and w.shape[2] == 1
            and w.shape[3] == x.shape[-1]):
        # 1x1 depthwise conv: a per-channel scale, bit-identical to the conv
        y = x * w[0, 0, 0, :].to(x.dtype)
        return _conv_epilogue(p, y, act), new_tail
    y = _conv2d(x, w, stride=fstride, fpad=(kf // 2, kf // 2), groups=groups)
    return _conv_epilogue(p, y, act), new_tail


def _conv_epilogue(p: dict, y: Tensor, act: Optional[str]) -> Tensor:
    """bias -> optional pointwise -> BN(eval) -> activation."""
    if p.get("b") is not None:
        y = y + p["b"].to(y.dtype)
    if p.get("pw") is not None:
        y = y @ p["pw"]["w"].to(y.dtype)
    if p.get("bn") is not None:
        y = y * p["bn"]["scale"].to(y.dtype) + p["bn"]["shift"].to(y.dtype)
    return apply_act(y, act)


def conv_transpose_block(p: dict, x: Tensor, *, kf: int, fstride: int,
                         act: Optional[str] = "relu") -> Tensor:
    """ConvTranspose over frequency (kernel time size 1, padding ``kf//2``,
    output_padding ``kf//2``) as a conv over the zero-dilated input with
    the pre-flipped kernel ``p['w']`` — JAX's ``lhs_dilation`` form."""
    fpad = kf // 2
    groups = x.shape[-1] // p["w"].shape[2]
    y = _conv2d(x, p["w"], stride=1, fpad=(kf - 1 - fpad, kf - 1),
                groups=groups, fdilate=fstride)
    return _conv_epilogue(p, y, act)


def subpixel_block(p: dict, x: Tensor, *, kf: int, fstride: int,
                   act: Optional[str] = "relu") -> Tensor:
    """Sub-pixel frequency upsampling (kernel time size 1).

    ``p['w']`` packs output channel ``c*fstride + i`` (sub-conv ``i``'s
    channel ``c``); a fused ``p['w_fm']`` packs ``i*Cout + c``, which makes
    the channel->frequency interleave a plain reshape.
    """
    fpad = kf // 2
    freq_major = "w_fm" in p
    w = p["w_fm"] if freq_major else p["w"]
    groups = x.shape[-1] // w.shape[2]
    y = _conv2d(x, w, stride=1, fpad=(fpad, fpad), groups=groups)
    if p.get("b") is not None:
        y = y + p["b"].to(y.dtype)
    B, T, f, sc = y.shape
    c = sc // fstride
    if freq_major:
        y = y.reshape(B, T, f * fstride, c)
    else:
        y = y.reshape(B, T, f, c, fstride).transpose(-1, -2).reshape(B, T, f * fstride, c)
    if p.get("pw") is not None:
        y = y @ p["pw"]["w"].to(y.dtype)
    if p.get("bn") is not None:
        y = y * p["bn"]["scale"].to(y.dtype) + p["bn"]["shift"].to(y.dtype)
    return apply_act(y, act)


# --------------------------------------------------------------------------- #
# Linears and norms
# --------------------------------------------------------------------------- #

def grouped_linear(p: dict, x: Tensor, act: Optional[str] = None) -> Tensor:
    """Block-diagonal linear: ``p['w']: [G, I/G, O/G]``, ``p['b']: [O]``."""
    g, ig, og = p["w"].shape
    lead = x.shape[:-1]
    xg = x.reshape(-1, g, ig).transpose(0, 1)                    # [G, M, ig]
    y = torch.bmm(xg, p["w"].to(x.dtype)).transpose(0, 1)        # [M, G, og]
    y = y.reshape(lead + (g * og,)) + p["b"].to(x.dtype)
    return apply_act(y, act)


def grouped_linear_fm(p: dict, x_fm: Tensor, act: Optional[str] = None) -> Tensor:
    """:func:`grouped_linear` of the freq-leading plane ``x_fm [F, T, B, C]``
    (the fm DPRNN chain's output) over its flattened f-major ``(f, c)``
    feature, without relaying the plane out to ``[B, T, F*C]``: returns
    ``[B, T, G*og]``.  Groups that split whole f-slices (``ig % C == 0``)
    contract directly; otherwise (``df_fc_emb``: ig 96, C 64) P = lcm/C
    f-slices hold Q = lcm/ig whole groups, and each supergroup contracts
    against the groups' weights scattered into a zero-padded
    ``[P*C, Q*og]`` block (``dpdfnet_tpu.ops.nn.grouped_linear_fm``)."""
    g, ig, og = p["w"].shape
    F_, T, B, C = x_fm.shape
    w = p["w"].to(x_fm.dtype)
    if ig % C == 0:
        fg = ig // C
        if fg * g != F_:
            raise ValueError(f"grouped_linear_fm: w {tuple(p['w'].shape)} does not cover the "
                             f"[{F_},{T},{B},{C}] plane")
        y = torch.einsum("gftbc,gfco->btgo", x_fm.reshape(g, fg, T, B, C),
                         w.reshape(g, fg, C, og))
    else:
        lcm = ig * C // math.gcd(ig, C)
        P, Q = lcm // C, lcm // ig
        gs = g // Q
        if gs * Q != g or gs * P != F_:
            raise ValueError(f"grouped_linear_fm: w {tuple(p['w'].shape)} does not tile the "
                             f"[{F_},{T},{B},{C}] plane into supergroups")
        wq = w.reshape(gs, Q, ig, og)
        wpad = w.new_zeros((gs, P * C, Q * og))
        for q in range(Q):
            wpad[:, q * ig:(q + 1) * ig, q * og:(q + 1) * og] = wq[:, q]
        y = torch.einsum("gptbc,gpco->btgo", x_fm.reshape(gs, P, T, B, C),
                         wpad.reshape(gs, P, C, Q * og))
    y = y.reshape(B, T, g * og) + p["b"].to(x_fm.dtype)
    return apply_act(y, act)


def linear(p: dict, x: Tensor, act: Optional[str] = None) -> Tensor:
    y = x @ p["w"].to(x.dtype)
    if p.get("b") is not None:
        y = y + p["b"].to(x.dtype)
    return apply_act(y, act)


def layer_norm(p: dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    """torch.nn.LayerNorm over the last axis (biased variance)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"].to(x.dtype) + p["b"].to(x.dtype)


# --------------------------------------------------------------------------- #
# GRU
# --------------------------------------------------------------------------- #

def gru_cell(p: dict, xp: Tensor, h: Tensor) -> Tensor:
    """One GRU step given ``xp = x@wi + bi``: ``[..., 3H], [..., H] -> [..., H]``.
    ``bh_n`` sits inside the ``r *`` product (linear-before-reset)."""
    hh = h @ p["wh"].to(h.dtype) + p["bh"].to(h.dtype)
    H = h.shape[-1]
    r = torch.sigmoid(xp[..., :H] + hh[..., :H])
    z = torch.sigmoid(xp[..., H:2 * H] + hh[..., H:2 * H])
    n = torch.tanh(xp[..., 2 * H:] + r * hh[..., 2 * H:])
    return (1.0 - z) * n + z * h


def gru_seq(p: dict, x: Tensor, h0: Optional[Tensor] = None,
            reverse: bool = False) -> Tuple[Tensor, Tensor]:
    """GRU over the time axis of ``x: [B, T, I]``; returns
    ``(ys [B, T, H]`` at x's dtype, ``h_last [B, H]`` float32).  Goes
    through the ``gru_scan`` kernel wrapper, which launches the CUDA kernel
    for CUDA tensors and runs its plain version for CPU tensors; the
    carried hidden enters the kernel in float32 whatever the state's
    dtype."""
    from . import gru_kernels

    B = x.shape[0]
    H = p["wh"].shape[0]
    h0 = (x.new_zeros((B, H), dtype=torch.float32) if h0 is None
          else h0.float().contiguous())
    return gru_kernels.gru_scan(x, h0, p["wi"], p["bi"], p["wh"], p["bh"],
                                reverse=reverse)


def gru_bidir(p_fw: dict, p_bw: dict, x: Tensor,
              packed: Optional[dict] = None) -> Tensor:
    """Bidirectional GRU from zero state along the time axis of
    ``x [B, T, I]``, output ``[fw, bw]`` concatenated.  Goes through the
    ``gru_bidir`` kernel wrapper with the direction-blockdiag weights:
    ``packed`` (``models.fuse.pack_dprnn_bidir``) when given, else packed
    here, as ``dpdfnet_tpu.ops.nn.gru_bidir`` does."""
    from . import gru_kernels

    if packed is None:
        wi2, wh2, b2 = gru_kernels._pack_bidir(p_fw, p_bw)
    else:
        wi2, wh2, b2 = packed["wi2"], packed["wh2"], packed["b2"]
    ys_fw, ys_bw = gru_kernels.gru_bidir(x.contiguous(), wi2, wh2, b2)
    return torch.cat([ys_fw, ys_bw], dim=-1)


def grouped_gru_seq(ps: list, x: Tensor, h0s: Optional[list] = None,
                    shuffle_out: bool = False) -> Tuple[Tensor, List[Tensor]]:
    """Independent GRUs over channel groups (reference GroupedGRULayer);
    optional group-major -> interleaved channel shuffle of the output."""
    g = len(ps)
    xs = torch.chunk(x, g, dim=-1)
    if h0s is None:
        h0s = [None] * g
    ys, hs = [], []
    for p, xg, h0 in zip(ps, xs, h0s):
        y, h = gru_seq(p, xg.contiguous(), h0=h0)
        ys.append(y)
        hs.append(h)
    out = torch.cat(ys, dim=-1)
    if shuffle_out:
        *lead, C = out.shape
        out = out.reshape(tuple(lead) + (C // g, g)).transpose(-1, -2).reshape(
            tuple(lead) + (C,))
    return out, hs


# --------------------------------------------------------------------------- #
# EMA linear recurrence
# --------------------------------------------------------------------------- #

def rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` and back: a Python scalar that multiplies
    a tensor of that dtype as JAX's weakly typed scalars do (they take the
    tensor's dtype first).  A no-op for float32 arithmetic."""
    return float(torch.tensor(v, dtype=dtype))


def _coef(v: float, x: Tensor) -> float:
    return rounded(v, x.dtype)


def ema_scan(x: Tensor, init: Tensor, alpha: float) -> Tensor:
    """Sequential ``m_t = alpha*m_{t-1} + (1-alpha)*x_t`` over ``x [B, T, F]``
    with ``m_{-1} = init`` (``[F]`` or ``[B, F]``); returns every ``m_t``.
    The op sequence per frame is the same for every chunking."""
    m = init.to(x.dtype).expand(x.shape[0], x.shape[-1])
    a, b = _coef(alpha, x), _coef(1.0 - alpha, x)
    out = []
    for t in range(x.shape[1]):
        m = a * m + b * x[:, t]
        out.append(m)
    return torch.stack(out, dim=1)


def _affine_scan(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Inclusive scan along dim 1 of the affine maps ``m -> a*m + b`` under
    ``(a1, b1), (a2, b2) -> (a1*a2, a2*b1 + b2)``, with the pairing tree of
    ``jax.lax.associative_scan`` (pairs, recursion on the odd results,
    then the evens), so each element takes the same roundings as there."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_odd, b_odd = _affine_scan(a[:, 0:-1:2] * a[:, 1::2],
                                a[:, 1::2] * b[:, 0:-1:2] + b[:, 1::2])
    if n % 2 == 0:
        a_odd_head, b_odd_head = a_odd[:, :-1], b_odd[:, :-1]
    else:
        a_odd_head, b_odd_head = a_odd, b_odd
    a_even = torch.cat([a[:, :1], a_odd_head * a[:, 2::2]], dim=1)
    b_even = torch.cat([b[:, :1], a[:, 2::2] * b_odd_head + b[:, 2::2]], dim=1)
    a_out, b_out = a.new_empty(a.shape), b.new_empty(b.shape)
    a_out[:, 0::2], a_out[:, 1::2] = a_even, a_odd
    b_out[:, 0::2], b_out[:, 1::2] = b_even, b_odd
    return a_out, b_out


def ema_scan_assoc(x: Tensor, init: Tensor, alpha: float) -> Tensor:
    """Log-depth associative form of :func:`ema_scan` (the JAX package's
    ``lax.associative_scan`` tree); agrees with it to float rounding
    (~1e-7 relative in float32)."""
    a, b = _affine_scan(torch.full_like(x, alpha), _coef(1.0 - alpha, x) * x)
    init = init.to(x.dtype).expand(x.shape[0], x.shape[-1])
    return a * init[:, None, :] + b
