"""Seeded random weights in DPDFNet's raw parameter tree, made on the device.

The tree has the keys and shapes the program's ``Engine`` takes (convs
HWIO with their pointwise stage and eval-mode batch norm, GRUs as
``wi [I, 3H]``, ``wh [H, 3H]``, grouped linears ``[G, I/G, O/G]``) and the
fixed ERB filterbanks.  All random numbers come from one ``torch.randn``
call of a ``torch.Generator`` on the device; batch-norm and LayerNorm
statistics and biases are drawn too, so that the program's folds and
fusions have something to fold.  Weights are normal with a spread of one
over the root of their fan-in, so that activations keep their scale from
layer to layer and every layer moves the output (a 1% change of any
group of weights moves it by 1e-4 to 1e-2 relative); each GRU's
recurrent matrix ``wh`` is then scaled to a spectral norm of at most
``CONTRACT``, which keeps the recurrent state bounded, as a trained
checkpoint's is.  (Contracting every weight, as the program's
``contract_params`` does, shrinks the activations layer by layer until the
output no longer depends on the DPRNN blocks: a 1% change of all their
weights moved it by 1e-6.)  The same tensors go to the program and to the
reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import erb

CONTRACT = 0.7

# leaf kinds: (mean, spread) of the drawn value; "w" takes its own spread
_AFFINE = {"bias": (0.0, 0.05), "bn_scale": (1.0, 0.1), "bn_shift": (0.0, 0.1),
           "ln_g": (1.0, 0.1), "ln_b": (0.0, 0.1)}


def _w(*shape, scale=None):
    if scale is None:
        scale = 1.0 / math.sqrt(max(1, shape[-2] if len(shape) > 1 else shape[0]))
    return ("w", shape, float(scale))


def _leaf(kind, n):
    return (kind, (n,), 0.0)


def _conv(kt, kf, cin_g, cout, pw=False):
    p = {"w": _w(kt, kf, cin_g, cout, scale=1.0 / math.sqrt(kt * kf * cin_g)), "b": None}
    if pw:
        p["pw"] = {"w": _w(cout, cout)}
    p["bn"] = {"scale": _leaf("bn_scale", cout), "shift": _leaf("bn_shift", cout)}
    return p


def _subpixel(kf, cin_g, cout, fstride):
    return {"w": _w(1, kf, cin_g, cout * fstride, scale=1.0 / math.sqrt(kf * cin_g)),
            "b": None, "pw": {"w": _w(cout, cout)},
            "bn": {"scale": _leaf("bn_scale", cout), "shift": _leaf("bn_shift", cout)}}


def _gl(i, o, groups):
    return {"w": _w(groups, i // groups, o // groups, scale=1.0 / math.sqrt(i // groups)),
            "b": _leaf("bias", o)}


def _lin(i, o):
    return {"w": _w(i, o), "b": _leaf("bias", o)}


def _gru(i, h):
    return {"wi": _w(i, 3 * h), "bi": _leaf("bias", 3 * h),
            "wh": _w(h, 3 * h), "bh": _leaf("bias", 3 * h)}


def _ln(c):
    return {"g": _leaf("ln_g", c), "b": _leaf("ln_b", c)}


def _dprnn_block(c):
    return {"intra": {"fw": _gru(c, c), "bw": _gru(c, c), "fc": _lin(2 * c, c), "ln": _ln(c)},
            "inter": {"gru": _gru(c, c), "fc": _lin(c, c), "ln": _ln(c)}}


def _squeezed(i, h, o, layers, groups):
    p = {"lin_in": _gl(i, h, groups), "grus": [_gru(h, h) for _ in range(layers)]}
    if o is not None:
        p["lin_out"] = _gl(h, o, groups)
    return p


def erb_widths(cfg: dict) -> Tuple[int, int, int, int]:
    f = cfg["n_fft"] // 2 if cfg["hr"] else cfg["nb_erb"]
    widths = [f]
    for s in ((3, 2, 2) if cfg["hr"] else (2, 2, 1)):
        widths.append(-(-widths[-1] // s))
    return tuple(widths)


def layout(cfg: dict) -> Dict:
    """The raw tree with ``(kind, shape, scale)`` leaves (``None`` where
    the layer has no bias).  Only the published DPDFNet variants'
    options are laid out: subpixel upsampling, no GRU skip, ungrouped
    GRUs."""
    if (cfg["upsample"], cfg["emb_gru_skip"], cfg["group_gru"]) != ("subpixel", "none", 1):
        raise ValueError("weights are laid out for subpixel upsampling, no emb_gru skip "
                         "and ungrouped GRUs")
    C, H, nb = cfg["conv_ch"], cfg["gru_dim"], cfg["nb_df"]
    kt, kf = cfg["conv_kernel_inp"]
    kfc = cfg["conv_kernel"][1]
    hr = cfg["hr"]
    emb_in = cfg["emb_dim"] if hr else C * cfg["nb_erb"] // 4
    emb_out = C * cfg["nb_erb"] // 4
    lg, elg = cfg["lin_groups"], cfg["enc_lin_groups"]
    fq_erb = erb_widths(cfg)[3]
    enc = {
        "erb_conv0": _conv(kt, kf, 1, C),
        "erb_conv1": _conv(1, kfc, 1, C, pw=True),
        "erb_conv2": _conv(1, kfc, 1, C, pw=True),
        "erb_conv3": _conv(1, kfc, 1, C, pw=True),
        "df_conv0": _conv(kt, kf, 1, C, pw=True),
        "df_conv1": _conv(1, kfc, 1, C, pw=True),
        "dprnn_erb": [_dprnn_block(C) for _ in range(cfg["dprnn_blocks"])],
        "dprnn_df": [_dprnn_block(C) for _ in range(cfg["dprnn_blocks"])],
        "df_fc_emb": _gl(C * nb // 2, emb_in, elg),
        "emb_gru": _squeezed(2 * emb_in, H, emb_out, 1, lg),
        "lsnr": _lin(emb_out, 1),
    }
    if hr:
        enc["erb_fc_emb"] = _gl(C * fq_erb, emb_in, elg)
    st3, st2, st1 = (2, 2, 3) if hr else (1, 2, 2)
    dec = {
        "emb_gru": _squeezed(emb_out, H, cfg["emb_dim"] if hr else emb_out, 2, lg),
        "conv3p": _conv(1, 1, 1, C), "conv2p": _conv(1, 1, 1, C),
        "conv1p": _conv(1, 1, 1, C), "conv0p": _conv(1, 1, 1, C),
        "conv0_out": _conv(1, kfc, C, 1),
        "convt3": _conv(1, kfc, 1, C, pw=True) if st3 == 1 else _subpixel(kfc, 1, C, st3),
        "convt2": _subpixel(kfc, 1, C, st2),
        "convt1": _subpixel(kfc, 1, C, st1),
    }
    if hr:
        dec["erb_fc_emb"] = _gl(cfg["emb_dim"], C * fq_erb, elg)
    df_dec = {
        "df_gru": _squeezed(emb_out, H, None, 2, 8),
        "df_skip": _gl(emb_out, H, lg),
        "df_out": _gl(H, nb * 2 * cfg["df_order"], lg),
        "df_convp": _conv(cfg["df_kt"], 1, C // 2, 2 * cfg["df_order"], pw=True),
    }
    return {"enc": enc, "erb_dec": dec, "df_dec": df_dec}


def _leaves(tree, path="") -> List[Tuple[str, tuple]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    return [] if tree is None else [(path, tree)]


def _fill(tree, values: Dict[str, torch.Tensor], path=""):
    if isinstance(tree, dict):
        return {k: _fill(v, values, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fill(v, values, f"{path}/{i}") for i, v in enumerate(tree)]
    return None if tree is None else values[path]


def make(cfg: dict, seed: int, device) -> Dict:
    """The raw tree of ``cfg`` from ``seed`` on ``device``, float32."""
    tree = layout(cfg)
    leaves = _leaves(tree)
    sizes = [math.prod(shape) for _, (_, shape, _) in leaves]
    g = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    values, pos = {}, 0
    for (path, (kind, shape, scale)), n in zip(leaves, sizes):
        x = z[pos:pos + n].reshape(shape)
        pos += n
        if kind == "w":
            x = x * scale
            if path.endswith("/wh"):
                s = torch.linalg.matrix_norm(x.double(), ord=2).float()
                x = x * torch.clamp(CONTRACT / s, max=1.0)
        else:
            mean, spread = _AFFINE[kind]
            x = x * spread + mean
        values[path] = x.contiguous()
    params = _fill(tree, values)
    fb, inv = erb.erb_fb_and_inverse(cfg["n_fft"], cfg["sample_rate"], cfg["nb_erb"],
                                     cfg["min_nb_freqs"])
    params["erb_fb"] = torch.as_tensor(fb, device=device)
    params["erb_inv_fb"] = torch.as_tensor(inv, device=device)
    return params


def clone(tree):
    """A copy of the tree that shares no storage with it."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return None if tree is None else tree.clone()
