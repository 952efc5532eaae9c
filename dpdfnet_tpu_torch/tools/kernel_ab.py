"""The recurrent kernels gru_scan, dprnn_inter_block_v2, the v1 DPRNN
stages dprnn_inter_block and dprnn_intra_block, dprnn_intra_block_v2,
gru_bidir, the DPRNN stack and the two step-ablation kernels, and the
offline and streaming paths they sit on, measured for one checkout.

    python3 dpdfnet_tpu_torch/tools/kernel_ab.py [--root DIR] [--out FILE] [--pairs N]
        [--kernels gru_scan,inter_v2,inter,intra,intra_v2,gru_bidir,stack,intra_ablation,
                   inter_ablation] [--e2e] [--e2e-stack] [--hops N]

Imports ``dpdfnet_tpu_torch`` from ``--root`` (default: the checkout
holding this file), as ``mode_off_digest.py`` does, so one command can
measure an earlier commit unpacked under a ``.gitignore``d directory (the
parent of a kernel change, from ``git archive``) beside the current tree,
in turns on one card: parent, change, change, parent.

For each kernel, at the shapes the main path gives it (B=8 offline, B=64 x
112 frames offline, T=1 at 64 exact streams; bfloat16 planes where the
``turbo`` path uses them): the kernel against its plain version (1e-4
max-abs, beyond one bf16 ulp on bfloat16 outputs), then the kernel and one
PyTorch library call of the same function (cuDNN's GRU, with linear +
LayerNorm + residual for the DPRNN stages, bidirectional for intra and
gru_bidir) timed alternately call by call (:func:`interleaved_ms`), and the
roofline bound.  The stack has no single PyTorch call: its yardstick is
the per-stage chain it replaces, K x (``dprnn_intra_block`` +
``dprnn_inter_block``) at the same shape, and on float32 planes the row
says whether the two are bit-identical.  Intra v2 (bfloat16 input
projections, its default) is timed with its float32-projection form, the
v1 ``dprnn_intra_block`` on the matching packs and cuDNN's call, and the
row says whether the float32-projection form is bit-identical to v1.  The step-ablation kernels
(``tools/*_step_ablation.py``) at their tools' default shapes (intra
x[4096, 48, 64], inter x[56, 6144, 64], bfloat16 planes): every
specialization against its plain version, then every variant of the
tool's ``VARIANTS`` (one call per distinct specialization and layout)
and cuDNN's call of ``full``'s function timed alternately call by call.
``--e2e``: offline xRT of
``Engine.enhance_waveforms`` at B=64 x 4 s and exact ms per hop at 64
streams, ``highest`` against ``turbo`` with ``DPDFNET_TPU_PALLAS_V2=1``,
interleaved call by call, with the launches of each path.
``--e2e-stack``: exact ms per hop at 64 streams, per-stage against the
stack kernel (``DPDFNET_TPU_STACK``), in ``highest`` and in ``turbo`` +
V2, interleaved call by call.  Random weights and inputs from fixed
seeds.  Prints a JSON object (and writes it to ``--out``).  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np

PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
KERNEL_TOL = 1e-4
MODEL = "dpdfnet8_48khz_hr"
V2 = "DPDFNET_TPU_PALLAS_V2"
# A device-side spin before each timed call (about 2 ms at the H100's
# clocks): the host enqueues the call while the card spins, so the events
# around the call time the device's work and not the host's dispatch.
SLEEP_CYCLES = 4_000_000


def bound(flops: float, nbytes: float) -> Tuple[float, str]:
    """(ms, what bounds it): the larger of FLOPs over the f32 peak and
    bytes over the memory rate."""
    t_f, t_b = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_f, "operations") if t_f >= t_b else (t_b, "bytes")


def interleaved_ms(fns: Dict[str, Callable[[], object]], pairs: int = 21
                   ) -> Dict[str, Tuple[float, float, float]]:
    """Device ms of each function, timed alternately call by call: ``pairs``
    rounds, each calling every function once (the order reversed every
    other round), each call alone between two CUDA events behind a device
    spin.  Returns name -> (median, min, max)."""
    import torch

    names = list(fns)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    events = {n: [] for n in names}
    for i in range(pairs):
        for n in (names if i % 2 == 0 else names[::-1]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            e0.record()
            fns[n]()
            e1.record()
            events[n].append((e0, e1))
    torch.cuda.synchronize()
    out = {}
    for n, evs in events.items():
        ts = [a.elapsed_time(b) for a, b in evs]
        out[n] = (statistics.median(ts), min(ts), max(ts))
    return out


def _err(got, ref) -> float:
    """Max-abs of got - ref beyond one bf16 ulp where ref is bfloat16."""
    from dpdfnet_tpu_torch.ops.gru_kernels import err_beyond_bf16_ulp

    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    return max(err_beyond_bf16_ulp(a, b) for a, b in zip(got, ref))


def _randn(rng, *shape, scale):
    import torch

    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda()


def on_grid(t, step: float, lim: float):
    """``t`` rounded to multiples of ``step`` and clamped to [-lim, lim]."""
    import torch

    return (torch.round(t / step) * step).clamp(-lim, lim)


# shapes: (label, N or B, T, plane)
SCAN_CASES = (("B=8", 8, 112, "f32"), ("B=64", 64, 112, "f32"), ("B=64", 64, 112, "bf16"),
              ("T=1 x 64", 64, 1, "f32"), ("T=1 x 64", 64, 1, "bf16"))
INTER_V2_CASES = (("B=8", 8, 112, "f32"), ("B=8", 8, 112, "bf16"), ("B=64", 64, 112, "f32"),
                  ("B=64", 64, 112, "bf16"), ("T=1 x 64", 64, 1, "f32"),
                  ("T=1 x 64", 64, 1, "bf16"))
# the v1 DPRNN stages: inter (label, B, T, plane) on [B, T, 48, 64]; intra
# (label, rows B * T, plane) on [rows, 48, 64]
INTER_CASES = (("B=8", 8, 112, "f32"), ("B=8", 8, 112, "bf16"), ("B=64", 64, 112, "f32"),
               ("B=64", 64, 112, "bf16"), ("T=1 x 64", 64, 1, "f32"))
INTRA_CASES = (("B=8", 8 * 112, "f32"), ("B=8", 8 * 112, "bf16"), ("B=64", 64 * 112, "f32"),
               ("B=64", 64 * 112, "bf16"), ("T=1 x 64", 64, "f32"))
# gru_bidir (label, rows, L, plane) on [rows, L, 64]: B=8, B=64 x 112 (df and
# erb widths) and T=1 x 64 streams
BIDIR_CASES = tuple((label, N, L, plane) for label, N, L in (
    ("B=8", 8 * 112, 48), ("B=64", 64 * 112, 48), ("B=64 erb", 64 * 112, 40),
    ("T=1 x 64", 64, 48)) for plane in ("f32", "bf16"))
# the DPRNN stack (label, B, T, Fq, K, plane): one exact hop of 64 streams
# (both branches), a throughput-mode call, the table's offline shape, the
# pool's edges
STACK_CASES = tuple((label, B, T, Fq, 8, plane) for label, B, T, Fq in (
    ("exact hop", 64, 1, 48), ("exact hop erb", 64, 1, 40), ("throughput", 64, 8, 48),
    ("offline B=8", 8, 112, 48), ("pool B=1", 1, 1, 48), ("pool B=256", 256, 1, 48))
    for plane in ("f32", "bf16"))
KERNELS = ("gru_scan", "inter_v2", "inter", "intra", "intra_v2", "gru_bidir", "stack")
ABLATIONS = ("intra_ablation", "inter_ablation")
# the step-ablation tools' default shapes: (rows, T)
ABLATION_SHAPES = {"intra": (4096, 48), "inter": (6144, 56)}


def kernel_rows(gk, log=print, pairs: int = 21, seed: int = 0, kernels=KERNELS) -> list:
    """Every case of SCAN_CASES (forward and reverse), INTER_V2_CASES
    (bf16 xp, and f32 xp on f32 planes), INTER_CASES and INTRA_CASES, for
    the kernels named in ``kernels``: checked against the plain version,
    then timed with its library call.  Raises on a mismatch."""
    import torch

    rng = np.random.default_rng(seed)
    rows = []
    if "gru_scan" in kernels:
        rows += _scan_rows(gk, log, pairs, rng)
    if "inter_v2" in kernels:
        rows += _inter_v2_rows(gk, log, pairs, rng)
    if "inter" in kernels:
        rows += _inter_rows(gk, log, pairs, rng)
    if "intra" in kernels:
        rows += _intra_rows(gk, log, pairs, rng)
    if "intra_v2" in kernels:
        rows += _intra_v2_rows(gk, log, pairs, rng)
    if "gru_bidir" in kernels:
        rows += _bidir_rows(gk, log, pairs, rng)
    if "stack" in kernels:
        rows += _stack_rows(gk, log, pairs, rng)
    for tool in ABLATION_SHAPES:
        if f"{tool}_ablation" in kernels:
            rows += _ablation_rows(tool, log, pairs)
    torch.cuda.synchronize()
    return rows


def _scan_rows(gk, log, pairs, rng) -> list:
    import torch

    rows = []
    H = I = 256
    wi, wh = _randn(rng, I, 3 * H, scale=I ** -0.5), _randn(rng, H, 3 * H, scale=H ** -0.5)
    bi, bh = _randn(rng, 3 * H, scale=0.1), _randn(rng, 3 * H, scale=0.1)
    lib_gru = torch.nn.GRU(I, H, batch_first=True).cuda()
    with torch.no_grad():
        lib_gru.weight_ih_l0.copy_(wi.T)
        lib_gru.weight_hh_l0.copy_(wh.T)
        lib_gru.bias_ih_l0.copy_(bi)
        lib_gru.bias_hh_l0.copy_(bh)
    for label, N, T, plane in SCAN_CASES:
        dt = torch.bfloat16 if plane == "bf16" else torch.float32
        x = _randn(rng, N, T, I, scale=1.0).to(dt)
        h0 = _randn(rng, N, H, scale=0.5)
        for reverse in (False, True):
            err = _err(gk.gru_scan(x, h0, wi, bi, wh, bh, reverse=reverse),
                       gk.gru_scan_plain(x, h0, wi, bi, wh, bh, reverse=reverse))
            if not err <= KERNEL_TOL:
                raise AssertionError(f"gru_scan {label} {plane} reverse={reverse}: {err:.3e} "
                                     f"beyond the plain version")
            xl = (x.flip(1) if reverse else x).float().contiguous()
            t = interleaved_ms({"kernel": lambda: gk.gru_scan(x, h0, wi, bi, wh, bh,
                                                              reverse=reverse),
                                "library": lambda: lib_gru(xl, h0[None])}, pairs)
            b_ms, b_by = bound(6 * H * (I + H) * N * T,
                               (I + H) * x.element_size() * N * T + 2 * N * H * 4
                               + 4 * (wi.numel() + wh.numel() + bi.numel() + bh.numel()))
            rows.append(dict(kernel="gru_scan", shape=f"{label} x[{N},{T},{I}] H={H}",
                             plane=plane, reverse=reverse, err=err, ms=t["kernel"],
                             library_ms=t["library"], bound_ms=b_ms, bound_by=b_by))
            log(_line(rows[-1]))
    return rows


def _dprnn_weights(rng, C):
    """One inter GRU (wi, bi, wh, bh), an fc (wfc, bfc) and a LayerNorm
    (g, bln), float32 on the card."""
    wi, wh = _randn(rng, C, 3 * C, scale=C ** -0.5), _randn(rng, C, 3 * C, scale=C ** -0.5)
    bi, bh = _randn(rng, 3 * C, scale=0.1), _randn(rng, 3 * C, scale=0.1)
    wfc, bfc = _randn(rng, C, C, scale=C ** -0.5), _randn(rng, C, scale=0.1)
    g, bln = 1.0 + _randn(rng, C, scale=0.2), _randn(rng, C, scale=0.1)
    return wi, bi, wh, bh, wfc, bfc, g, bln


def _cudnn_gru(wi, bi, wh, bh, bidir=None):
    """cuDNN's GRU holding the same weights (bidir: the backward set)."""
    import torch

    m = torch.nn.GRU(wi.shape[0], wh.shape[0], batch_first=True,
                     bidirectional=bidir is not None).cuda()
    with torch.no_grad():
        sets = [("", (wi, bi, wh, bh))] + ([("_reverse", bidir)] if bidir is not None else [])
        for sfx, (a, b, c, d) in sets:
            getattr(m, f"weight_ih_l0{sfx}").copy_(a.T)
            getattr(m, f"bias_ih_l0{sfx}").copy_(b)
            getattr(m, f"weight_hh_l0{sfx}").copy_(c.T)
            getattr(m, f"bias_hh_l0{sfx}").copy_(d)
    return m


def _inter_rows(gk, log, pairs, rng) -> list:
    """v1 ``dprnn_inter_block`` against its plain version and cuDNN's GRU +
    linear + LayerNorm + residual."""
    import torch

    F = torch.nn.functional
    C, Fq = 64, 48
    ea = _dprnn_weights(rng, C)
    wi, bi, wh, bh, wfc, bfc, g, bln = ea
    lib_gru = _cudnn_gru(wi, bi, wh, bh)
    rows = []
    for label, B, T, plane in INTER_CASES:
        dt = torch.bfloat16 if plane == "bf16" else torch.float32
        x = _randn(rng, B, T, Fq, C, scale=1.0).to(dt)
        h0 = _randn(rng, B, Fq, C, scale=0.5)
        err = _err(gk.dprnn_inter_block(x, h0, *ea), gk.dprnn_inter_block_plain(x, h0, *ea))
        if not err <= KERNEL_TOL:
            raise AssertionError(f"dprnn_inter_block {label} {plane}: {err:.3e} beyond the "
                                 f"plain version")
        xl = x.float().transpose(1, 2).reshape(B * Fq, T, C).contiguous()
        hl0 = h0.reshape(1, B * Fq, C)

        def lib():
            ys, _ = lib_gru(xl, hl0)
            return xl + F.layer_norm(F.linear(ys, wfc.T, bfc), (C,), g, bln, 1e-5)

        t = interleaved_ms({"kernel": lambda: gk.dprnn_inter_block(x, h0, *ea),
                            "library": lib}, pairs)
        n = B * Fq * T
        b_ms, b_by = bound(14 * C * C * n, 2 * C * x.element_size() * n + 2 * B * Fq * C * 4
                           + 4 * sum(a.numel() for a in ea))
        rows.append(dict(kernel="dprnn_inter_block", shape=f"{label} x[{B},{T},{Fq},{C}]",
                         plane=plane, reverse=False, err=err, ms=t["kernel"],
                         library_ms=t["library"], bound_ms=b_ms, bound_by=b_by))
        log(_line(rows[-1]))
    return rows


def _intra_weights(gk, rng, C):
    """The packed v1 intra weights ``(wi2, wh2, b2, wfc, bfc, g, bln)`` and
    cuDNN's bidirectional GRU holding the same two directions."""
    fw, bw = _dprnn_weights(rng, C)[:4], _dprnn_weights(rng, C)[:4]
    wi2, wh2, b2 = gk._pack_bidir(dict(zip(("wi", "bi", "wh", "bh"), fw)),
                                  dict(zip(("wi", "bi", "wh", "bh"), bw)))
    wfc, bfc = _randn(rng, 2 * C, C, scale=(2 * C) ** -0.5), _randn(rng, C, scale=0.1)
    g, bln = 1.0 + _randn(rng, C, scale=0.2), _randn(rng, C, scale=0.1)
    return (wi2, wh2, b2, wfc, bfc, g, bln), _cudnn_gru(*fw, bidir=bw)


def _intra_rows(gk, log, pairs, rng) -> list:
    """``dprnn_intra_block`` against its plain version and cuDNN's
    bidirectional GRU + linear + LayerNorm + residual."""
    import torch

    F = torch.nn.functional
    C, Fq = 64, 48
    ia, lib_gru = _intra_weights(gk, rng, C)
    wfc, bfc, g, bln = ia[3:]
    rows = []
    for label, N, plane in INTRA_CASES:
        dt = torch.bfloat16 if plane == "bf16" else torch.float32
        x = _randn(rng, N, Fq, C, scale=1.0).to(dt)
        err = _err(gk.dprnn_intra_block(x, *ia), gk.dprnn_intra_block_plain(x, *ia))
        if not err <= KERNEL_TOL:
            raise AssertionError(f"dprnn_intra_block {label} {plane}: {err:.3e} beyond the "
                                 f"plain version")
        xl = x.float()

        def lib():
            ys, _ = lib_gru(xl)
            return xl + F.layer_norm(F.linear(ys, wfc.T, bfc), (C,), g, bln, 1e-5)

        t = interleaved_ms({"kernel": lambda: gk.dprnn_intra_block(x, *ia), "library": lib},
                           pairs)
        n = N * Fq
        b_ms, b_by = bound(28 * C * C * n, 2 * C * x.element_size() * n
                           + 4 * sum(a.numel() for a in ia))
        rows.append(dict(kernel="dprnn_intra_block", shape=f"{label} x[{N},{Fq},{C}]",
                         plane=plane, reverse=False, err=err, ms=t["kernel"],
                         library_ms=t["library"], bound_ms=b_ms, bound_by=b_by))
        log(_line(rows[-1]))
    return rows


def _intra_v2_rows(gk, log, pairs, rng) -> list:
    """``dprnn_intra_block_v2`` against its plain version (float32
    projections; bfloat16 projections on exact-sum inputs, as chip_smoke
    phase 2 checks them), and timed, with bfloat16 projections, against
    its float32-projection form, the v1 ``dprnn_intra_block`` on the
    matching packs and cuDNN's bidirectional GRU + linear + LayerNorm +
    residual.  ``bits_v1``: the float32-projection form is bit-identical
    to v1 (reported, not required: an earlier design rounds differently)."""
    import torch

    F = torch.nn.functional
    C, Fq = 64, 48
    ia, lib_gru = _intra_weights(gk, rng, C)
    wi2, wh2, b2, wfc, bfc, g, bln = ia
    wi_cat, wh_big = gk.pack_intra_v2(wi2, wh2, wfc)
    iva = (wi_cat, wh_big, b2, bfc, g, bln)
    # exact-sum weights for the bf16-xp check (x on a 2^-5 grid, wi_cat and
    # b2 on a 2^-10 grid: every partial sum of x . wi_cat + b2[0] is exact)
    ivg = (on_grid(wi_cat, 2.0 ** -10, 0.5), wh_big, on_grid(b2, 2.0 ** -10, 0.5), *iva[3:])
    rows = []
    for label, N, plane in INTRA_CASES:
        dt = torch.bfloat16 if plane == "bf16" else torch.float32
        x = _randn(rng, N, Fq, C, scale=1.0).to(dt)
        xg = on_grid(x.float(), 2.0 ** -5, 1.875).to(dt)
        f32 = gk.dprnn_intra_block_v2(x, *iva, xp_bf16=False)
        err = max(_err(f32, gk.dprnn_intra_block_v2_plain(x, *iva, xp_bf16=False)),
                  _err(gk.dprnn_intra_block_v2(xg, *ivg),
                       gk.dprnn_intra_block_v2_plain(xg, *ivg)))
        if not err <= KERNEL_TOL:
            raise AssertionError(f"dprnn_intra_block_v2 {label} {plane}: {err:.3e} beyond the "
                                 f"plain version")
        bits = torch.equal(f32, gk.dprnn_intra_block(x, *ia))
        xl = x.float()

        def lib():
            ys, _ = lib_gru(xl)
            return xl + F.layer_norm(F.linear(ys, wfc.T, bfc), (C,), g, bln, 1e-5)

        t = interleaved_ms({"kernel": lambda: gk.dprnn_intra_block_v2(x, *iva),
                            "f32 xp": lambda: gk.dprnn_intra_block_v2(x, *iva, xp_bf16=False),
                            "v1": lambda: gk.dprnn_intra_block(x, *ia), "library": lib}, pairs)
        n = N * Fq
        b_ms, b_by = bound(28 * C * C * n, 2 * C * x.element_size() * n
                           + 4 * sum(a.numel() for a in iva))
        rows.append(dict(kernel="dprnn_intra_block_v2", shape=f"{label} x[{N},{Fq},{C}] xp bf16",
                         plane=plane, reverse=False, err=err, ms=t["kernel"],
                         library_ms=t["library"], bound_ms=b_ms, bound_by=b_by,
                         f32_xp_ms=t["f32 xp"], v1_ms=t["v1"], bits_v1=bits))
        m, lo, hi = t["f32 xp"]
        v, vlo, vhi = t["v1"]
        log(f"{_line(rows[-1])}; f32 xp {m:.4f} [{lo:.4f}-{hi:.4f}] bit-identical to v1 "
            f"{bits}; v1 {v:.4f} [{vlo:.4f}-{vhi:.4f}]")
    return rows


def _bidir_rows(gk, log, pairs, rng) -> list:
    """``gru_bidir`` against its plain version and cuDNN's bidirectional
    GRU."""
    import torch

    C = 64
    fw, bw = _dprnn_weights(rng, C)[:4], _dprnn_weights(rng, C)[:4]
    wa = gk._pack_bidir(dict(zip(("wi", "bi", "wh", "bh"), fw)),
                        dict(zip(("wi", "bi", "wh", "bh"), bw)))
    lib_gru = _cudnn_gru(*fw, bidir=bw)
    rows = []
    for label, N, L, plane in BIDIR_CASES:
        dt = torch.bfloat16 if plane == "bf16" else torch.float32
        x = _randn(rng, N, L, C, scale=1.0).to(dt)
        err = _err(gk.gru_bidir(x, *wa), gk.gru_bidir_plain(x, *wa))
        if not err <= KERNEL_TOL:
            raise AssertionError(f"gru_bidir {label} {plane}: {err:.3e} beyond the plain version")
        xl = x.float()
        t = interleaved_ms({"kernel": lambda: gk.gru_bidir(x, *wa), "library": lambda: lib_gru(xl)},
                           pairs)
        n = N * L
        b_ms, b_by = bound(24 * C * C * n, 3 * C * x.element_size() * n
                           + 4 * sum(a.numel() for a in wa))
        rows.append(dict(kernel="gru_bidir", shape=f"{label} x[{N},{L},{C}]", plane=plane,
                         reverse=False, err=err, ms=t["kernel"], library_ms=t["library"],
                         bound_ms=b_ms, bound_by=b_by))
        log(_line(rows[-1]))
    return rows


def ablation_full(tool: str) -> dict:
    """``full`` of a step-ablation tool (``intra`` or ``inter``, imported
    from the checkout on ``sys.path``) at its default shape on its timed
    inputs (seed 0): the kernel's call, its plain version's, cuDNN's GRU +
    linear + LayerNorm + residual of the same function (bidirectional for
    intra), and the FLOPs and bytes of its bound."""
    import importlib

    import torch

    F = torch.nn.functional
    abl = importlib.import_module(f"dpdfnet_tpu_torch.tools.{tool}_step_ablation")
    C = 64
    nrows, T = ABLATION_SHAPES[tool]
    if tool == "intra":
        x, w = abl.make_inputs(nrows, T, C, "cuda")
        wi2, wh2, b2, wfc, bfc, g, bln = w

        def direction(d):               # one direction's [C, 3C] weights of the packing
            cols = torch.cat([torch.arange(gt * 2 * C + d * C, gt * 2 * C + (d + 1) * C)
                              for gt in range(3)]).cuda()
            return (wi2[d * C:(d + 1) * C][:, cols], b2[0, cols], wh2[d * C:(d + 1) * C][:, cols],
                    b2[1, cols])

        lib_gru = _cudnn_gru(*direction(0), bidir=direction(1))
        xl, h0l = x.float(), None
        kernel = lambda: abl.run_intra("full", x, *w)  # noqa: E731
        plain = lambda: abl.intra_plain("full", x, *w)  # noqa: E731
        flops, nbytes = 28 * C * C * nrows * T, 2 * C * 2 * nrows * T
    else:
        x, h0, wp, bp, tail = abl.make_inputs(nrows, T, C, "cuda")
        w = (*abl.unpack_wp(wp, bp), *tail)
        wfc, bfc, g, bln = tail
        lib_gru = _cudnn_gru(*w[:4])
        xl, h0l = x.float().transpose(0, 1), h0[None]
        kernel = lambda: abl.run_inter("full", x, h0, *w)[0]  # noqa: E731
        plain = lambda: abl.inter_plain("full", x, h0, *w)[0]  # noqa: E731
        flops, nbytes = 14 * C * C * nrows * T, 2 * C * 2 * nrows * T + 2 * nrows * C * 4

    def library():
        ys, _ = lib_gru(xl) if h0l is None else lib_gru(xl, h0l)
        return xl + F.layer_norm(F.linear(ys, wfc.T, bfc), (C,), g, bln, 1e-5)

    return dict(kernel=kernel, plain=plain, library=library, flops=flops, nbytes=nbytes)


def _ablation_rows(tool: str, log, pairs) -> list:
    """A step-ablation kernel (``intra`` or ``inter``) at its tool's
    default shape: every specialization (intra: both layouts) against its
    plain version, then one call per distinct (specialization, layout) of
    the tool's ``VARIANTS`` and cuDNN's call of ``full``'s function timed
    alternately call by call; a row per variant."""
    import importlib

    import torch

    abl = importlib.import_module(f"dpdfnet_tpu_torch.tools.{tool}_step_ablation")
    nrows, T = ABLATION_SHAPES[tool]
    errs = abl.check_specializations(nrows, T, log=lambda m: None, seed=0)
    err = max(errs.values())
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{tool} step ablation: {errs} beyond the plain versions")
    f = ablation_full(tool)
    fns, spec_of = {"library": f["library"]}, {}
    if tool == "intra":
        x, w = abl.make_inputs(nrows, T, 64, "cuda")
        x_tm = x.transpose(0, 1).contiguous()
        for name in abl.VARIANTS:
            spec, layout = abl.specialization(name)
            key = spec_of[name] = f"{spec}/{layout}"
            xin, tm = (x_tm, True) if layout == "tm" else (x, False)
            fns[key] = (lambda s, xi, t: lambda: abl.run_intra(s, xi, *w, tm=t))(spec, xin, tm)
        shape = f"x[{nrows},{T},64]"
    else:
        x, h0, wp, bp, tail = abl.make_inputs(nrows, T, 64, "cuda")
        w = (*abl.unpack_wp(wp, bp), *tail)
        for name in abl.VARIANTS:
            spec = abl.specialization(name)
            key = spec_of[name] = spec
            fns[key] = (lambda s: lambda: abl.run_inter(s, x, h0, *w))(spec)
        shape = f"x[{T},{nrows},64]"
    t = interleaved_ms(fns, pairs)
    torch.cuda.synchronize()
    b_ms, b_by = bound(f["flops"], f["nbytes"])
    rows = []
    for name, key in spec_of.items():
        rows.append(dict(kernel=f"{tool}_step_ablation", shape=shape, plane="bf16",
                         variant=name, specialization=key, err=err, ms=t[key],
                         library_ms=t["library"], bound_ms=b_ms, bound_by=b_by))
        m, lo, hi = t[key]
        log(f"kernel {tool}_step_ablation {shape} bf16 plane: {name:>16} ({key}) ms {m:.4f} "
            f"[{lo:.4f}-{hi:.4f}], {m - t[spec_of['full']][0]:+.4f} against full "
            f"(median [min-max], interleaved); every specialization within {err:.3e} of its "
            f"plain version; full's bound_ms {b_ms:.4f} ({b_by}), library_ms "
            f"{t['library'][0]:.4f}")
    return rows


def _stack_args(gk, rng, K: int, C: int = 64):
    """K random DPRNN blocks (f32 on the card): their ``pack_stack`` dict,
    each block's ``dprnn_intra_block`` weights and its ``dprnn_inter_block``
    weights."""
    import torch

    keys = ("wi", "bi", "wh", "bh")
    intra, inter = [], []
    for _ in range(K):
        fw, bw = _dprnn_weights(rng, C)[:4], _dprnn_weights(rng, C)[:4]
        ea = _dprnn_weights(rng, C)
        wfc_i, bfc_i = _randn(rng, 2 * C, C, scale=(2 * C) ** -0.5), _randn(rng, C, scale=0.1)
        g_i, bln_i = 1.0 + _randn(rng, C, scale=0.2), _randn(rng, C, scale=0.1)
        wi2, wh2, b2 = gk._pack_bidir(dict(zip(keys, fw)), dict(zip(keys, bw)))
        intra.append((wi2, wh2, b2, wfc_i, bfc_i, g_i, bln_i))
        inter.append(ea)
    stk = lambda xs: torch.stack(xs).contiguous()          # noqa: E731
    row = lambda xs: torch.stack([v.reshape(1, -1) for v in xs]).contiguous()  # noqa: E731
    st = {"wi2": stk([a[0] for a in intra]), "wh2": stk([a[1] for a in intra]),
          "b2": stk([a[2] for a in intra]), "wfc_i": stk([a[3] for a in intra]),
          "bfc_i": row([a[4] for a in intra]), "g_i": row([a[5] for a in intra]),
          "bln_i": row([a[6] for a in intra]), "wi_t": stk([e[0] for e in inter]),
          "wh_t": stk([e[2] for e in inter]),
          "b2_t": stk([torch.stack([e[1], e[3]]) for e in inter]),
          "wfc_t": stk([e[4] for e in inter]), "bfc_t": row([e[5] for e in inter]),
          "g_t": row([e[6] for e in inter]), "bln_t": row([e[7] for e in inter])}
    return st, intra, inter


def stack_chain(gk, x, h0, intra, inter):
    """The per-stage chain the stack replaces: K x (``dprnn_intra_block`` +
    ``dprnn_inter_block``) over ``x [B, T, Fq, C]`` from ``h0 [K, B, Fq,
    C]``, as the model runs it block by block."""
    B, T, Fq, C = x.shape
    cur, hs = x, []
    for k, (ia, ea) in enumerate(zip(intra, inter)):
        cur = gk.dprnn_intra_block(cur.reshape(B * T, Fq, C), *ia).reshape(B, T, Fq, C)
        cur, h = gk.dprnn_inter_block(cur, h0[k], *ea, defer=False)
        hs.append(h)
    return cur, hs


def _stack_rows(gk, log, pairs, rng) -> list:
    """``dprnn_stack`` against its plain version, bit for bit against the
    per-stage chain on float32 planes (reported, not enforced: an earlier
    design of the stack kept its own arithmetic), and timed call by call
    against that chain."""
    import torch

    C, K = 64, 8
    st, intra, inter = _stack_args(gk, rng, K, C)
    wbytes = 4 * sum(v.numel() for v in st.values())
    rows = []
    for label, B, T, Fq, K_, plane in STACK_CASES:
        dt = torch.bfloat16 if plane == "bf16" else torch.float32
        x = _randn(rng, B, T, Fq, C, scale=1.0).to(dt)
        h0 = _randn(rng, K, B, Fq, C, scale=0.5)
        out, hl = gk.dprnn_stack(x, h0, st)
        err = _err((out, hl), gk.dprnn_stack_plain(x, h0, st))
        if not err <= KERNEL_TOL:
            raise AssertionError(f"dprnn_stack {label} {plane}: {err:.3e} beyond the plain version")
        bits = None
        if plane == "f32":
            co, ch = stack_chain(gk, x, h0, intra, inter)
            bits = bool(torch.equal(out, co) and torch.equal(hl, torch.stack(ch)))
        t = interleaved_ms({"kernel": lambda: gk.dprnn_stack(x, h0, st),
                            "library": lambda: stack_chain(gk, x, h0, intra, inter)},
                           pairs if T == 1 else max(3, pairs // 4))
        n = B * T * Fq * K
        b_ms, b_by = bound(42 * C * C * n, 2 * (x.numel() * x.element_size() + h0.numel() * 4)
                           + wbytes)
        rows.append(dict(kernel="dprnn_stack", shape=f"{label} x[{B},{T},{Fq},{C}] K={K}",
                         plane=plane, reverse=False, err=err, ms=t["kernel"],
                         library_ms=t["library"], bound_ms=b_ms, bound_by=b_by,
                         bits_equal_chain=bits))
        log(_line(rows[-1]) + f" (library: the per-stage chain, {2 * K} launches; bit-identical "
            f"to it: {bits})")
    return rows


def _inter_v2_rows(gk, log, pairs, rng) -> list:
    import torch

    F = torch.nn.functional
    rows = []
    C, Fq = 64, 48
    wi_t, wh_t = _randn(rng, C, 3 * C, scale=C ** -0.5), _randn(rng, C, 3 * C, scale=C ** -0.5)
    bi_t, bh_t = _randn(rng, 3 * C, scale=0.1), _randn(rng, 3 * C, scale=0.1)
    wfc, bfc = _randn(rng, C, C, scale=C ** -0.5), _randn(rng, C, scale=0.1)
    g, bln = 1.0 + _randn(rng, C, scale=0.2), _randn(rng, C, scale=0.1)
    whfc = torch.cat([wh_t, wfc], dim=1)
    eva = (whfc, bh_t, bfc, g, bln)
    lib_t = torch.nn.GRU(C, C, batch_first=True).cuda()
    with torch.no_grad():
        lib_t.weight_ih_l0.copy_(wi_t.T)
        lib_t.weight_hh_l0.copy_(wh_t.T)
        lib_t.bias_ih_l0.copy_(bi_t)
        lib_t.bias_hh_l0.copy_(bh_t)
    for label, B, T, plane in INTER_V2_CASES:
        dt = torch.bfloat16 if plane == "bf16" else torch.float32
        x = _randn(rng, B, T, Fq, C, scale=1.0).to(dt)
        h0 = _randn(rng, B, Fq, C, scale=0.5)
        xp32 = x.float() @ wi_t + bi_t
        xp = xp32.to(torch.bfloat16)
        errs = [_err(gk.dprnn_inter_block_v2(xp, x, h0, *eva),
                     gk.dprnn_inter_block_v2_plain(xp, x, h0, *eva))]
        if plane == "f32":
            errs.append(_err(gk.dprnn_inter_block_v2(xp32, x, h0, *eva),
                             gk.dprnn_inter_block_v2_plain(xp32, x, h0, *eva)))
        err = max(errs)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"dprnn_inter_block_v2 {label} {plane}: {err:.3e} beyond the "
                                 f"plain version")
        xl = x.float().transpose(1, 2).reshape(B * Fq, T, C).contiguous()
        hl0 = h0.reshape(1, B * Fq, C)

        def lib():
            ys, _ = lib_t(xl, hl0)
            return xl + F.layer_norm(F.linear(ys, wfc.T, bfc), (C,), g, bln, 1e-5)

        t = interleaved_ms({"kernel": lambda: gk.dprnn_inter_block_v2(xp, x, h0, *eva),
                            "library": lib}, pairs)
        n = B * Fq * T
        b_ms, b_by = bound(8 * C * C * n, (3 * C * 2 + 2 * C * x.element_size()) * n
                           + 2 * B * Fq * C * 4 + 4 * sum(a.numel() for a in eva))
        rows.append(dict(kernel="dprnn_inter_block_v2", shape=f"{label} x[{B},{T},{Fq},{C}] xp bf16",
                         plane=plane, reverse=False, err=err, ms=t["kernel"],
                         library_ms=t["library"], bound_ms=b_ms, bound_by=b_by))
        log(_line(rows[-1]))
    return rows


def _line(r: dict) -> str:
    m, lo, hi = r["ms"]
    lm, llo, lhi = r["library_ms"]
    rev = " reverse" if r["reverse"] else ""
    return (f"kernel {r['kernel']} {r['shape']} {r['plane']} plane{rev}: max_abs {r['err']:.3e} "
            f"beyond the plain version (tol {KERNEL_TOL:.0e}); ms {m:.4f} [{lo:.4f}-{hi:.4f}] "
            f"library_ms {lm:.4f} [{llo:.4f}-{lhi:.4f}] (median [min-max], interleaved) "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}); kernel / library {m / lm:.3f}")


def e2e(gk, log=print, hops: int = 200, rounds: int = 5, seed: int = 0) -> dict:
    """Offline xRT (B=64 x 4 s) and exact ms per hop (64 streams, one
    ``process_frames`` call per hop) of ``highest`` and ``turbo`` + V2,
    interleaved call by call after a warm-up; the launches of one offline
    call and of one hop of each."""
    import torch

    from dpdfnet_tpu_torch import get_config
    from dpdfnet_tpu_torch.models.params import contract_params, init_params
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality

    cfg = get_config(MODEL)
    params = contract_params(init_params(cfg, seed=seed, device="cuda"))
    rng = np.random.default_rng(seed)
    Bb, secs = 64, 4.0
    big = (0.1 * rng.standard_normal((Bb, int(secs * cfg.sample_rate)))).astype(np.float32)
    frames = (0.1 * rng.standard_normal((Bb, hops + 16, cfg.win_len))).astype(np.float32)
    paths = {"highest": ("highest", False), "turbo+V2": ("turbo", True)}
    engines = {}
    for name, (q, v2) in paths.items():
        os.environ[V2] = "1" if v2 else "0"
        engines[name] = engine_from_quality(cfg, params, q, device="cuda")

    def call(name, fn):
        os.environ[V2] = "1" if paths[name][1] else "0"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(engines[name])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    res = {}
    walls = {n: [] for n in paths}
    for rnd in range(rounds + 1):                        # round 0 warms up
        for name in paths:
            t, y = call(name, lambda e: e.enhance_waveforms(big))
            if not np.isfinite(y).all():
                raise AssertionError(f"e2e {name}: offline output not finite")
            if rnd:
                walls[name].append(t)
    states = {n: engines[n].init_stream_state(batch=Bb) for n in paths}
    hop_ms = {n: [] for n in paths}
    for i in range(hops + 16):                           # 16 warm-up hops
        for name in paths:
            t, (y, states[name]) = call(
                name, lambda e: e.process_frames(frames[:, i:i + 1], states[name]))
            if i >= 16:
                hop_ms[name].append(t * 1e3)
    for name in paths:
        gk.reset_launch_counts()
        call(name, lambda e: e.enhance_waveforms(big))
        offline = {k: v for k, v in gk.launch_counts().items() if v}
        gk.reset_launch_counts()
        call(name, lambda e: e.process_frames(frames[:, :1], e.init_stream_state(batch=Bb)))
        hop = {k: v for k, v in gk.launch_counts().items() if v}
        med = statistics.median(walls[name])
        res[name] = dict(xrt=Bb * secs / med, offline_ms=[w * 1e3 for w in walls[name]],
                         hop_ms_median=statistics.median(hop_ms[name]),
                         hop_ms_mean=statistics.fmean(hop_ms[name]),
                         launches_offline=offline, launches_hop=hop)
        log(f"e2e {name}: offline B={Bb} x {secs} s xRT {Bb * secs / med:.1f} (median of "
            f"{rounds} interleaved calls, ms {[round(w * 1e3, 1) for w in walls[name]]}); exact "
            f"{Bb} streams, {hops} interleaved hops: median {res[name]['hop_ms_median']:.3f} ms "
            f"per hop, mean {res[name]['hop_ms_mean']:.3f}; launches per offline call "
            f"{json.dumps(offline)}, per hop {json.dumps(hop)} (the wrappers count what they "
            f"launch: none where the hop replays a captured graph)")
    os.environ.pop(V2, None)
    return res


def e2e_stack(gk, log=print, hops: int = 200, seed: int = 0) -> dict:
    """Exact ms per hop at 64 streams (one ``process_frames`` call per hop),
    the per-stage DPRNN kernels against the stack kernel, in ``highest`` and
    in ``turbo`` + V2: the four paths interleaved call by call after 16
    warm-up hops, with the launches of one hop of each."""
    import torch

    from dpdfnet_tpu_torch import get_config
    from dpdfnet_tpu_torch.models.params import contract_params, init_params
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality

    cfg = get_config(MODEL)
    params = contract_params(init_params(cfg, seed=seed, device="cuda"))
    rng = np.random.default_rng(seed)
    Bb = 64
    frames = (0.1 * rng.standard_normal((Bb, hops + 16, cfg.win_len))).astype(np.float32)
    paths = {f"{q} {d}": (q, v2, st) for q, v2 in (("highest", False), ("turbo", True))
             for d, st in (("per-stage", False), ("stack", True))}

    def env(v2, st):
        os.environ[V2] = "1" if v2 else "0"
        os.environ["DPDFNET_TPU_STACK"] = "1" if st else "0"

    engines = {}
    for name, (q, v2, st) in paths.items():
        env(v2, st)
        engines[name] = engine_from_quality(cfg, params, q, device="cuda")
    states = {n: engines[n].init_stream_state(batch=Bb) for n in paths}
    hop_ms = {n: [] for n in paths}
    names = list(paths)
    for i in range(hops + 16):
        for name in (names if i % 2 == 0 else names[::-1]):
            env(*paths[name][1:])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, states[name] = engines[name].process_frames(frames[:, i:i + 1], states[name])
            torch.cuda.synchronize()
            if i >= 16:
                hop_ms[name].append((time.perf_counter() - t0) * 1e3)
    res = {}
    for name in names:
        env(*paths[name][1:])
        e = engines[name]
        gk.reset_launch_counts()
        e.process_frames(frames[:, :1], e.init_stream_state(batch=Bb))
        torch.cuda.synchronize()
        hop = {k: v for k, v in gk.launch_counts().items() if v}
        res[name] = dict(hop_ms_median=statistics.median(hop_ms[name]),
                         hop_ms_min=min(hop_ms[name]), hop_ms_max=max(hop_ms[name]),
                         launches_hop=hop)
        log(f"e2e-stack {name}: exact {Bb} streams, {hops} interleaved hops: median "
            f"{res[name]['hop_ms_median']:.3f} ms per hop [{res[name]['hop_ms_min']:.3f}-"
            f"{res[name]['hop_ms_max']:.3f}]; launches per hop {json.dumps(hop)} (none where "
            f"the hop replays a captured graph)")
    os.environ.pop(V2, None)
    os.environ.pop("DPDFNET_TPU_STACK", None)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose dpdfnet_tpu_torch is imported")
    ap.add_argument("--out", help="also write the JSON result to this file")
    ap.add_argument("--pairs", type=int, default=21)
    ap.add_argument("--e2e", action="store_true", help="also time the two engine paths")
    ap.add_argument("--e2e-stack", action="store_true",
                    help="also time the exact hop per-stage against the stack kernel")
    ap.add_argument("--hops", type=int, default=200)
    ap.add_argument("--kernels", default=",".join(KERNELS + ABLATIONS),
                    help=f"comma-separated subset of {', '.join(KERNELS + ABLATIONS)}")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dpdfnet_tpu_torch.ops import gru_kernels as gk

    if not os.path.abspath(gk.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {gk.__file__}, not the package under {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    log(f"kernel_ab root {root} | {smi} | torch {torch.__version__}")
    picked = [k for k in args.kernels.split(",") if k and k != "none"]
    result = {"root": root, "card": smi, "kernels": kernel_rows(gk, log, args.pairs,
                                                                kernels=picked)}
    if args.e2e:
        result["e2e"] = e2e(gk, log, hops=args.hops)
    if args.e2e_stack:
        result["e2e_stack"] = e2e_stack(gk, log, hops=args.hops)
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
