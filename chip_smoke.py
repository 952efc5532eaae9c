#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any fault exits non-zero; nothing is caught and passed over):

1. device check: prints the card's name and power limit (nvidia-smi), turns
   TF32 off for cuBLAS and cuDNN, builds the CUDA kernels (nvcc, sm_90a,
   one process per source, in parallel) and prints the build seconds;
2. each kernel against its plain PyTorch version on the card at the
   flagship's shapes (dpdfnet8_48khz_hr, B=8): max-abs error and its
   tolerance, kernel ms, plain ms, the ms of one PyTorch library call of the
   same function (a yardstick the port never calls), and the roofline
   bound; the kernel and its library call are timed alternately call by
   call, 21 pairs, median [min-max]; the DPRNN stack (one exact hop of 64
   streams and the offline B=8 plane) also bit for bit against the
   per-stage chain it replaces, K x (intra + inter) with the model's
   weights (float32; the run fails at the exact hop if a bit differs), and
   timed against that chain; ``dprnn_intra_block_v2`` with float32 input
   projections bit for bit against ``dprnn_intra_block`` on the matching
   packs (it is the same kernel reading the v2 packs); then gru_scan,
   ``dprnn_inter_block_v2``, the v1 ``dprnn_inter_block`` /
   ``dprnn_intra_block``, ``dprnn_intra_block_v2``, ``gru_bidir`` and the
   stack at every shape the main path gives them (B=8, B=64 x 112, T=1 at
   64 streams, bfloat16 planes; gru_scan forward and reverse; inter v2
   with bfloat16 and float32 xp; intra v2 bit for bit against v1 with
   float32 xp; the stack at one exact hop of both branches, a throughput
   call, the offline shape and the pool's edges) against their plain
   versions and their library calls, the stack's against its per-stage
   chain (``tools/kernel_ab.py``);
3. the main path: ``Engine.enhance_waveforms`` on dpdfnet8_48khz_hr with
   random contracted weights, 3 utterances (1.3, 2.0, 3.1 s) with
   ``lengths``, on the card and on the CPU with the same weights; checks
   finiteness, the card-vs-CPU deviation and the kernels' launch counts;
4. throughput: B=64 x 4 s through ``enhance_waveforms``, median of 3 timed
   calls after a warm-up: xRT, ms per 112-frame segment, peak memory; the
   same with the DPRNN stack kernel (``DPDFNET_TPU_STACK=1``);
5. streaming, card vs CPU: ``process_frames`` with 4 streams x 40 hops in
   exact and throughput modes, with the per-stage DPRNN kernels and with
   the stack kernel: deviation from the CPU engine, launches per hop, and
   exact mode bit-identical across three chunkings;
6. ``StreamEnhancer`` on the card (odd chunk sizes, save/load resume,
   flush) and ``MultiStreamEnhancer`` (8 slots, mixed cadences, each slot
   against a lone stream);
7. ``Engine(fuse=False)`` offline (the ``gru_bidir`` path), card vs CPU,
   with its launch counts;
8. streaming throughput on the card: exact mode with 64 streams x 200
   hops, one call per hop, per-stage against stack (ms per hop, streams at
   real time), and throughput mode at 8 hops per call;
9. the v2 DPRNN stage kernels reached from their wrappers, as the JAX
   package reaches intra v2: every DPRNN block of both branches as intra
   v2 then inter v2 on an offline plane, against the v1 kernels;
10. the quality tiers: ``tier_deviation`` of ``fast`` and ``turbo`` against
   ``highest`` (with and without ``DPDFNET_TPU_PALLAS_V2``), launches per
   segment of the ``fast``, ``turbo`` and ``turbo`` + V2 paths, exact
   ``turbo`` streaming bit-identical across chunkings, ``turbo`` (± V2) on
   the card against ``turbo`` on the CPU (offline, and exact streaming with
   its state), ``StreamEnhancer`` /
   ``MultiStreamEnhancer`` on a ``turbo`` engine, offline xRT per tier and
   exact / throughput ms per hop for ``highest`` against ``turbo``;
11. ``relayout_fm`` (the freq-major chain's entry permute) against its
   plain version, bit-exact, at [64, 112, 40 and 48, 64] float32 to float32
   and to bfloat16 and at two odd shapes, with kernel, bound, plain and
   ``permute().contiguous()`` times;
12. every kernel on the shared walk with its layout modes off, bit-identical
   to the committed digests (``tools/mode_off_digests.json``, whose note
   names the commit each case was taken on); the fm layout modes of the intra and
   inter kernels (``fm_batch``, ``h_bm``, ``defer``) against their plain
   versions at B=64 x 112 frames, each fused mode bit-identical to the
   row-major mode on the same rows, and both DPRNN stacks through the fm
   chain bit-identical to the row-major chain;
13. the fm chain on the main path: launches per 112-frame segment with
   ``DPDFNET_TPU_ENTRY_RELAYOUT=1`` (``relayout_fm`` 2 per segment), card
   against CPU at B=32 x 1 s, exact streaming at 64 streams bit-identical
   across chunkings and within KERNEL_TOL of the row-major chain, and the A/B: offline xRT at B=64 x 4 s and exact ms
   per hop at 64 streams with the chain off, on, and on with the entry
   relayout, in ``highest`` and ``turbo``, interleaved call by call;
14. both step-ablation tools (``dpdfnet_tpu_torch.tools``): every
   specialization against its plain version at a small size and at the JAX
   tools' default shapes, ``full`` bit for bit against the production
   intra / inter kernel (row-major and ``fm_batch`` intra, inter as a
   plane) at both sizes and both plane dtypes, the FFMA and spill
   instructions of each specialization's kernel at the default plan
   (``cuobjdump -sass``), then
   one timing pass of every variant there;
15. one JSON line listing the kernels, then the final JSON status line.

Needs one CUDA device; exits non-zero without one, and without the
``dpdfnet_tpu_torch`` package beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the roofline bound, and kernel / library timed alternately call by call
from dpdfnet_tpu_torch.tools import kernel_ab
from dpdfnet_tpu_torch.tools.kernel_ab import (bound, interleaved_ms as yardstick, on_grid,
                                               stack_chain)

# Tolerances (max-abs, float32 everywhere, TF32 off).
# Kernel vs plain version: the same f32 arithmetic summed in another order;
# over 112-step recurrences the rounding stays near 1e-6, so 1e-4 leaves
# two orders of headroom while still catching any wrong gate or index.
KERNEL_TOL = 1e-4
# Card engine vs CPU engine on the waveform: 16 DPRNN blocks and 5 GRU
# layers per segment, carried over 3-4 segments, then the iSTFT GEMM;
# every reduction differs in order between cuDNN/cuBLAS/kernels and the
# CPU, so the bound is looser than a single kernel's.  The same bound holds
# streaming (40 hops of carried state) and a pool slot against a lone
# stream (batch 8 against batch 1).
ENGINE_TOL = 5e-4
# A bfloat16 plane is rounded once on each side; a ~1e-7 float32 difference
# can flip that rounding, so bf16-plane modes get KERNEL_TOL plus one bf16
# ulp of the plain value.  Intra v2 with bfloat16 input projections (its
# default) is held to KERNEL_TOL on inputs whose products x . wi_cat are
# exact in float32 in any summation order (``on_grid``), so the kernel and
# torch.matmul round the same xp values.
# fast / turbo against highest on the waveform (tier_deviation, contracted
# weights, speech-shaped input whose enhanced output has an rms of about
# 1e-4): max-abs 5e-4, 2.5x the JAX package's 2.0e-4 tier envelope, and
# rel_rms (rms of the difference over the rms of highest's output) 0.1,
# 3x the 3.3e-2 measured on the card; muted or sign-flipped output is at 1.
TIER_TOL = 5e-4
TIER_REL_RMS = 0.1
# turbo on the card against turbo on the CPU.  Exact streaming (rfft front,
# bf16 network): bf16 rounds at other points in cuBLAS / cuDNN than on the
# CPU, as between the port and the JAX package on the CPU (there at most
# 8.5e-4 rel_rms on the output and 3.1e-2 on a state leaf): output rel_rms
# 1e-2, every state leaf at the CPU leaf's dtype and within rel_rms 0.1
# (measured 1.0e-3 and 5.7e-3).  Offline, the card also runs the STFT /
# iSTFT GEMMs in TF32 (the CPU has no TF32), so the two differ by about as
# much as the tier differs from highest: TIER_TOL and TIER_REL_RMS
# (measured 2.2e-5 and 6.0e-2).  A dropped DPRNN block leaves its carried
# hidden at rel_rms 1; a turbo run that skips its bf16 casts changes the
# state's dtypes.
TURBO_STREAM_REL_RMS = 1e-2
TURBO_STATE_REL_RMS = 0.1

MODEL = "dpdfnet8_48khz_hr"
PALLAS = "dpdfnet_tpu/ops/pallas_gru.py"


def log(msg: str) -> None:
    print(msg, flush=True)


STACK = "DPDFNET_TPU_STACK"      # read where weights are packed and at each call
V2 = "DPDFNET_TPU_PALLAS_V2"     # the same, under the fast / turbo tiers
TM = "DPDFNET_TPU_INTRA_TM"      # the freq-major DPRNN chain (default off here), read per call
ENTRY = "DPDFNET_TPU_ENTRY_RELAYOUT"   # its entry permute through relayout_fm (default off)


@contextlib.contextmanager
def set_env(name: str, on: bool):
    """``name`` set to 1 or 0 for the block."""
    saved = os.environ.get(name)
    os.environ[name] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


def rel_rms(got, ref) -> float:
    """rms of ``got - ref`` over the rms of ``ref``."""
    d = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean(d * d) / max(np.mean(np.square(np.asarray(ref, np.float64))),
                                              1e-30)))


def expect_counts(what: str, counts: dict, want: dict) -> None:
    """Every kernel in ``want`` launched exactly that many times (> 0), every
    other kernel not at all."""
    for k, v in counts.items():
        if v != want.get(k, 0) or (k in want and v <= 0):
            raise AssertionError(f"{what}: kernel {k} launched {v} times, expected "
                                 f"{want.get(k, 0)} ({json.dumps(counts)})")


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device ms per call over ``iters`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def spread(t) -> str:
    """``median [min-max]`` of an ``interleaved_ms`` entry."""
    return f"{t[0]:.4f} [{t[1]:.4f}-{t[2]:.4f}]"


def segments(eng, S: int) -> int:
    """112-frame segments the engine runs for an S-sample batch: the bucket
    plus win_len of padding, framed centred every hop."""
    frames = (eng.bucket_len(S) + eng.cfg.win_len) // eng.cfg.hop + 1
    return -(-frames // eng.seg_frames)


def gru_module(wi, bi, wh, bh, bidir=None):
    """cuDNN GRU holding the same weights (the library yardstick)."""
    I, H = wi.shape[0], wh.shape[0]
    m = torch.nn.GRU(I, H, batch_first=True, bidirectional=bidir is not None).cuda()
    with torch.no_grad():
        m.weight_ih_l0.copy_(wi.T)
        m.weight_hh_l0.copy_(wh.T)
        m.bias_ih_l0.copy_(bi)
        m.bias_hh_l0.copy_(bh)
        if bidir is not None:
            m.weight_ih_l0_reverse.copy_(bidir["wi"].T)
            m.weight_hh_l0_reverse.copy_(bidir["wh"].T)
            m.bias_ih_l0_reverse.copy_(bidir["bi"])
            m.bias_hh_l0_reverse.copy_(bidir["bh"])
    return m


def check(name: str, got, ref) -> float:
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{name}: max-abs {err:.3e} vs plain exceeds {KERNEL_TOL:.0e}")
    return err


def check_bf16(name: str, got, ref) -> float:
    """A bf16-plane mode against its plain version under
    ``gru_kernels.err_beyond_bf16_ulp``: returns the max-abs error."""
    from dpdfnet_tpu_torch.ops.gru_kernels import err_beyond_bf16_ulp

    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    err = 0.0
    for a, b in zip(got, ref):
        d = (a.float() - b.float()).abs().max().item()
        if not err_beyond_bf16_ulp(a, b) <= KERNEL_TOL:
            raise AssertionError(f"{name}: max-abs {d:.3e} vs plain exceeds "
                                 f"{KERNEL_TOL:.0e} + one bf16 ulp")
        err = max(err, d)
    return err


def kernel_phase(params, cfg, gk):
    """Each kernel against its plain version at the flagship shapes: B=8
    offline; the stack also at its streaming shape (T=1, B=64)."""
    from dpdfnet_tpu_torch.models.fuse import pack_stack

    B, T, C, H = 8, 112, cfg.conv_ch, cfg.gru_dim
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = {}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    blk = params["enc"]["dprnn_df"][0]
    intra, inter = blk["intra"], blk["inter"]
    pk = intra["packed"]
    ia = (pk["wi2"], pk["wh2"], pk["b2"], intra["fc"]["w"], intra["fc"]["b"],
          intra["ln"]["g"], intra["ln"]["b"])
    gw = inter["gru"]
    ea = (gw["wi"], gw["bi"], gw["wh"], gw["bh"], inter["fc"]["w"], inter["fc"]["b"],
          inter["ln"]["g"], inter["ln"]["b"])
    w_bytes = lambda ts: 4 * sum(t.numel() for t in ts)

    lib_intra_gru = gru_module(intra["fw"]["wi"], intra["fw"]["bi"], intra["fw"]["wh"],
                               intra["fw"]["bh"], bidir=intra["bw"])
    lib_inter_gru = gru_module(gw["wi"], gw["bi"], gw["wh"], gw["bh"])

    def lib_intra(x):
        """cuDNN bidirectional GRU + linear + LayerNorm + residual."""
        ys, _ = lib_intra_gru(x)
        return x + torch.nn.functional.layer_norm(
            torch.nn.functional.linear(ys, intra["fc"]["w"].T, intra["fc"]["b"]),
            (C,), intra["ln"]["g"], intra["ln"]["b"], 1e-5)

    def lib_inter(x, h0):
        """cuDNN GRU along T + linear + LayerNorm + residual."""
        Bx, Tx, Fx, _ = x.shape
        xt = x.transpose(1, 2).reshape(Bx * Fx, Tx, C)
        ys, hl = lib_inter_gru(xt, h0.reshape(1, Bx * Fx, C))
        y = torch.nn.functional.layer_norm(
            torch.nn.functional.linear(ys, inter["fc"]["w"].T, inter["fc"]["b"]),
            (C,), inter["ln"]["g"], inter["ln"]["b"], 1e-5)
        return x + y.reshape(Bx, Fx, Tx, C).transpose(1, 2), hl

    # the v2 weights, as pack_dprnn_bidir builds them under DPDFNET_TPU_PALLAS_V2
    wi_cat, wh_big = gk.pack_intra_v2(pk["wi2"], pk["wh2"], intra["fc"]["w"])
    iva = (wi_cat, wh_big, pk["b2"], intra["fc"]["b"], intra["ln"]["g"], intra["ln"]["b"])
    whfc = torch.cat([gw["wh"], inter["fc"]["w"]], dim=1)
    eva = (whfc, gw["bh"], inter["fc"]["b"], inter["ln"]["g"], inter["ln"]["b"])
    bf16 = torch.bfloat16

    for Fq in (cfg.dprnn_erb_feat, cfg.dprnn_df_feat):
        # ---- intra: [B*T, Fq, C] ----
        x = randn(B * T, Fq, C)
        err = check(f"dprnn_intra_block Fq={Fq}", gk.dprnn_intra_block(x, *ia),
                    gk.dprnn_intra_block_plain(x, *ia))
        t = yardstick({"kernel": lambda: gk.dprnn_intra_block(x, *ia),
                       "library": lambda: lib_intra(x)})
        ms, lib_ms = t["kernel"][0], t["library"][0]
        plain_ms = cuda_ms(lambda: gk.dprnn_intra_block_plain(x, *ia), 3)
        lib_err = (lib_intra(x) - gk.dprnn_intra_block_plain(x, *ia)).abs().max().item()
        n = B * T * Fq
        b_ms, b_by = bound(28 * C * C * n, 2 * C * 4 * n + w_bytes(ia))
        rows[("dprnn_intra_block", Fq)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                              library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"kernel dprnn_intra_block x[{B * T},{Fq},{C}]: max_abs {err:.3e} "
            f"(tol {KERNEL_TOL:.0e}; cuDNN yardstick differs by {lib_err:.1e}) "
            f"ms {spread(t['kernel'])} plain_ms {plain_ms:.4f} library_ms "
            f"{spread(t['library'])} bound_ms {b_ms:.4f} ({b_by})")
        if Fq == cfg.dprnn_df_feat:
            xb = x.to(bf16)
            err_b = check_bf16("dprnn_intra_block bf16 plane", gk.dprnn_intra_block(xb, *ia),
                               gk.dprnn_intra_block_plain(xb, *ia))
            t = yardstick({"kernel": lambda: gk.dprnn_intra_block(xb, *ia),
                           "library": lambda: lib_intra(x)})
            log(f"kernel dprnn_intra_block bf16 plane x[{B * T},{Fq},{C}]: max_abs {err_b:.3e} "
                f"(tol {KERNEL_TOL:.0e} + 1 bf16 ulp) ms {spread(t['kernel'])} (f32 plane "
                f"{ms:.4f}) library_ms {spread(t['library'])}")
            rows[("bf16", "dprnn_intra_block")] = dict(err=err_b, ms=t["kernel"][0])

        # ---- intra v2: the same plane, projections hoisted ----
        err = check(f"dprnn_intra_block_v2 f32 xp Fq={Fq}",
                    gk.dprnn_intra_block_v2(x, *iva, xp_bf16=False),
                    gk.dprnn_intra_block_v2_plain(x, *iva, xp_bf16=False))
        # bf16 xp on exact-sum inputs: x on a 2^-5 grid in [-1.875, 1.875],
        # wi_cat and b2 on a 2^-10 grid in [-0.5, 0.5], so every partial sum
        # of x . wi_cat + b2[0] is a multiple of 2^-15 below 2^6 (exact in
        # float32 in any order) and both sides round the same xp to bf16
        xg = on_grid(x, 2.0 ** -5, 1.875)
        ivg = (on_grid(wi_cat, 2.0 ** -10, 0.5), wh_big, on_grid(pk["b2"], 2.0 ** -10, 0.5),
               *iva[3:])
        ref_xb = gk.dprnn_intra_block_v2_plain(xg, *ivg)
        err_xb = check(f"dprnn_intra_block_v2 bf16 xp Fq={Fq}",
                       gk.dprnn_intra_block_v2(xg, *ivg), ref_xb)
        moved = (ref_xb - gk.dprnn_intra_block_v2_plain(xg, *ivg, xp_bf16=False)
                 ).abs().max().item()
        if not moved > 10 * KERNEL_TOL:
            raise AssertionError(f"dprnn_intra_block_v2 Fq={Fq}: rounding xp to bf16 moves "
                                 f"the plain output by only {moved:.3e}; the bf16-xp check "
                                 f"cannot tell the modes apart")
        # f32 xp: the production intra kernel reading the v2 packs, so v1's bits
        got, v1 = gk.dprnn_intra_block_v2(x, *iva, xp_bf16=False), gk.dprnn_intra_block(x, *ia)
        v1_err = (got - v1).abs().max().item()
        if not torch.equal(got, v1):
            raise AssertionError(f"dprnn_intra_block_v2 Fq={Fq} with f32 xp: not bit-identical "
                                 f"to dprnn_intra_block (max-abs {v1_err:.3e})")
        t = yardstick({"kernel": lambda: gk.dprnn_intra_block_v2(x, *iva),
                       "f32 xp": lambda: gk.dprnn_intra_block_v2(x, *iva, xp_bf16=False),
                       "library": lambda: lib_intra(x)})
        ms, ms_f, lib_ms = t["kernel"][0], t["f32 xp"][0], t["library"][0]
        plain_ms = cuda_ms(lambda: gk.dprnn_intra_block_v2_plain(x, *iva), 3)
        b_ms, b_by = bound(28 * C * C * n, 2 * C * 4 * n + w_bytes(iva))
        rows[("dprnn_intra_block_v2", Fq)] = dict(err=max(err, err_xb), ms=ms, plain_ms=plain_ms,
                                                 library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"kernel dprnn_intra_block_v2 x[{B * T},{Fq},{C}]: max_abs {err:.3e} with f32 xp "
            f"(tol {KERNEL_TOL:.0e}), {err_xb:.3e} with bf16 xp on exact-sum inputs (tol "
            f"{KERNEL_TOL:.0e}; the rounding itself moves the output by {moved:.3e}), "
            f"vs the v1 kernel {v1_err:.3e} (bit-identical with f32 xp); ms "
            f"{spread(t['kernel'])} (bf16 xp; f32 xp {spread(t['f32 xp'])}) plain_ms "
            f"{plain_ms:.4f} library_ms {spread(t['library'])} bound_ms {b_ms:.4f} ({b_by})")

        # ---- inter: [B, T, Fq, C] with a random carried h0 ----
        x = randn(B, T, Fq, C)
        h0 = randn(B, Fq, C, scale=0.5)
        err = check(f"dprnn_inter_block Fq={Fq}", gk.dprnn_inter_block(x, h0, *ea),
                    gk.dprnn_inter_block_plain(x, h0, *ea))
        t = yardstick({"kernel": lambda: gk.dprnn_inter_block(x, h0, *ea),
                       "library": lambda: lib_inter(x, h0)})
        ms, lib_ms = t["kernel"][0], t["library"][0]
        plain_ms = cuda_ms(lambda: gk.dprnn_inter_block_plain(x, h0, *ea), 3)
        n = B * Fq * T
        hb = 2 * B * Fq * C * 4
        b_ms, b_by = bound(14 * C * C * n, 2 * C * 4 * n + hb + w_bytes(ea))
        rows[("dprnn_inter_block", Fq)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                              library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"kernel dprnn_inter_block x[{B},{T},{Fq},{C}] h0 random: max_abs {err:.3e} "
            f"(tol {KERNEL_TOL:.0e}) ms {spread(t['kernel'])} plain_ms {plain_ms:.4f} "
            f"library_ms {spread(t['library'])} bound_ms {b_ms:.4f} ({b_by})")
        inter_ms = ms
        if Fq == cfg.dprnn_df_feat:
            xb = x.to(bf16)
            err_b = check_bf16("dprnn_inter_block bf16 plane", gk.dprnn_inter_block(xb, h0, *ea),
                               gk.dprnn_inter_block_plain(xb, h0, *ea))
            t = yardstick({"kernel": lambda: gk.dprnn_inter_block(xb, h0, *ea),
                           "library": lambda: lib_inter(x, h0)})
            log(f"kernel dprnn_inter_block bf16 plane x[{B},{T},{Fq},{C}]: max_abs {err_b:.3e} "
                f"(tol {KERNEL_TOL:.0e} + 1 bf16 ulp) ms {spread(t['kernel'])} (f32 plane "
                f"{ms:.4f}) library_ms {spread(t['library'])}")
            rows[("bf16", "dprnn_inter_block")] = dict(err=err_b, ms=t["kernel"][0])

        # ---- inter v2: the same plane, xp = x . Wi + bi in bf16 given ----
        def xp_of(x):
            return (x @ gw["wi"] + gw["bi"]).to(bf16)

        xp = xp_of(x)
        err = check(f"dprnn_inter_block_v2 Fq={Fq}", gk.dprnn_inter_block_v2(xp, x, h0, *eva),
                    gk.dprnn_inter_block_v2_plain(xp, x, h0, *eva))
        t = yardstick({"kernel": lambda: gk.dprnn_inter_block_v2(xp, x, h0, *eva),
                       "with GEMM": lambda: gk.dprnn_inter_block_v2(xp_of(x), x, h0, *eva),
                       "library": lambda: lib_inter(x, h0)})
        ms, lib_ms = t["kernel"][0], t["library"][0]
        plain_ms = cuda_ms(lambda: gk.dprnn_inter_block_v2_plain(xp, x, h0, *eva), 3)
        b_ms, b_by = bound(8 * C * C * n, (3 * C * 2 + 2 * C * 4) * n + hb + w_bytes(eva))
        bg_ms, bg_by = bound(14 * C * C * n, 2 * C * 4 * n + hb + w_bytes(ea))
        rows[("dprnn_inter_block_v2", Fq)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                                 library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"kernel dprnn_inter_block_v2 x[{B},{T},{Fq},{C}] xp bf16, h0 random: max_abs "
            f"{err:.3e} (tol {KERNEL_TOL:.0e}) ms {spread(t['kernel'])} alone, "
            f"{spread(t['with GEMM'])} with its xp GEMM (v1 inter {inter_ms:.4f}) plain_ms "
            f"{plain_ms:.4f} library_ms {spread(t['library'])} (cuDNN GRU + linear + LN) bound_ms {b_ms:.4f} ({b_by}; with the GEMM "
            f"{bg_ms:.4f}, {bg_by})")

    # ---- gru_scan: [B, T, I=H] from h0, forward and reverse ----
    gp = params["erb_dec"]["emb_gru"]["grus"][0]
    ga = (gp["wi"], gp["bi"], gp["wh"], gp["bh"])
    I = gp["wi"].shape[0]
    x = randn(B, T, I)
    h0 = randn(B, H, scale=0.5)
    for reverse in (False, True):
        err = check(f"gru_scan reverse={reverse}", gk.gru_scan(x, h0, *ga, reverse=reverse),
                    gk.gru_scan_plain(x, h0, *ga, reverse=reverse))
        lib = gru_module(*ga)
        xin = (x.flip(1) if reverse else x).contiguous()
        t = yardstick({"kernel": lambda: gk.gru_scan(x, h0, *ga, reverse=reverse),
                       "library": lambda: lib(xin, h0[None])})
        ms, lib_ms = t["kernel"][0], t["library"][0]
        plain_ms = cuda_ms(lambda: gk.gru_scan_plain(x, h0, *ga, reverse=reverse), 3)
        n = B * T
        b_ms, b_by = bound(6 * H * (I + H) * n,
                           (I + H) * 4 * n + 2 * B * H * 4 + w_bytes(ga))
        rows[("gru_scan", reverse)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"kernel gru_scan x[{B},{T},{I}] H={H} reverse={reverse}: max_abs {err:.3e} "
            f"(tol {KERNEL_TOL:.0e}) ms {spread(t['kernel'])} plain_ms {plain_ms:.4f} "
            f"library_ms {spread(t['library'])} bound_ms {b_ms:.4f} ({b_by})")
    xb = x.to(bf16)
    err_b = check_bf16("gru_scan bf16 plane", gk.gru_scan(xb, h0, *ga),
                       gk.gru_scan_plain(xb, h0, *ga))
    t = yardstick({"kernel": lambda: gk.gru_scan(xb, h0, *ga), "library": lambda: lib(x, h0[None])})
    log(f"kernel gru_scan bf16 plane x[{B},{T},{I}]: max_abs {err_b:.3e} "
        f"(tol {KERNEL_TOL:.0e} + 1 bf16 ulp) ms {spread(t['kernel'])} (f32 plane "
        f"{rows[('gru_scan', False)]['ms']:.4f}) library_ms {spread(t['library'])}")
    rows[("bf16", "gru_scan")] = dict(err=err_b, ms=t["kernel"][0])

    # ---- gru_bidir: [B*T, Fq=48, C] rows from zero state ----
    Fq = cfg.dprnn_df_feat
    x = randn(B * T, Fq, C)
    ba = (pk["wi2"], pk["wh2"], pk["b2"])
    err = check("gru_bidir", gk.gru_bidir(x, *ba), gk.gru_bidir_plain(x, *ba))
    lib = gru_module(intra["fw"]["wi"], intra["fw"]["bi"], intra["fw"]["wh"],
                     intra["fw"]["bh"], bidir=intra["bw"])
    t = yardstick({"kernel": lambda: gk.gru_bidir(x, *ba), "library": lambda: lib(x)})
    ms, lib_ms = t["kernel"][0], t["library"][0]
    plain_ms = cuda_ms(lambda: gk.gru_bidir_plain(x, *ba), 3)
    n = B * T * Fq
    b_ms, b_by = bound(24 * C * C * n, 3 * C * 4 * n + w_bytes(ba))
    rows[("gru_bidir", Fq)] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                   bound_ms=b_ms, bound_by=b_by)
    log(f"kernel gru_bidir x[{B * T},{Fq},{C}]: max_abs {err:.3e} (tol {KERNEL_TOL:.0e}) "
        f"ms {spread(t['kernel'])} plain_ms {plain_ms:.4f} library_ms {spread(t['library'])} "
        f"(cuDNN bidir GRU) "
        f"bound_ms {b_ms:.4f} ({b_by})")

    # ---- dprnn_stack: the streaming shape and the offline shape ----
    K = cfg.dprnn_blocks

    for branch, Fq in (("dprnn_erb", cfg.dprnn_erb_feat), ("dprnn_df", cfg.dprnn_df_feat)):
        blocks = params["enc"][branch]
        stacked = pack_stack(blocks)
        # the per-stage chain the stack replaces: K x (intra + inter)
        intra_k = [(b["intra"]["packed"]["wi2"], b["intra"]["packed"]["wh2"],
                    b["intra"]["packed"]["b2"], b["intra"]["fc"]["w"], b["intra"]["fc"]["b"],
                    b["intra"]["ln"]["g"], b["intra"]["ln"]["b"]) for b in blocks]
        inter_k = [(b["inter"]["gru"]["wi"], b["inter"]["gru"]["bi"], b["inter"]["gru"]["wh"],
                    b["inter"]["gru"]["bh"], b["inter"]["fc"]["w"], b["inter"]["fc"]["b"],
                    b["inter"]["ln"]["g"], b["inter"]["ln"]["b"]) for b in blocks]

        def chain(x, h0):
            out, hs = stack_chain(gk, x, h0, intra_k, inter_k)
            return out, torch.stack(hs)

        for Bs, Ts, label in ((64, 1, "stream"), (B, T, "offline")):
            x = randn(Bs, Ts, Fq, C)
            h0 = randn(K, Bs, Fq, C, scale=0.5)
            got = gk.dprnn_stack(x, h0, stacked)
            err = check(f"dprnn_stack {label} Fq={Fq}", got, gk.dprnn_stack_plain(x, h0, stacked))
            ref = chain(x, h0)
            bits = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            if Ts == 1 and not bits:
                raise AssertionError(
                    f"dprnn_stack {label} Fq={Fq}: not bit-identical to {K} x (intra + inter) "
                    f"(out {(got[0] - ref[0]).abs().max().item():.3e}, h_last "
                    f"{(got[1] - ref[1]).abs().max().item():.3e})")
            t = yardstick({"kernel": lambda: gk.dprnn_stack(x, h0, stacked),
                           "chain": lambda: chain(x, h0)}, 21 if Ts == 1 else 5)
            ms = t["kernel"][0]
            plain_ms = cuda_ms(lambda: gk.dprnn_stack_plain(x, h0, stacked), 3 if Ts == 1 else 1)
            n = Bs * Ts * Fq * K
            b_ms, b_by = bound(42 * C * C * n, 2 * (x.numel() + h0.numel()) * 4
                               + w_bytes(stacked.values()))
            rows[("dprnn_stack", label, Fq)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                                    library_ms=None, bound_ms=b_ms,
                                                    bound_by=b_by, chain_ms=t["chain"][0])
            log(f"kernel dprnn_stack {label} x[{Bs},{Ts},{Fq},{C}] K={K}: max_abs {err:.3e} "
                f"(tol {KERNEL_TOL:.0e}); bit-identical to the per-stage chain: {bits}; ms "
                f"{spread(t['kernel'])} against the chain's {2 * K} launches "
                f"{spread(t['chain'])}; plain_ms {plain_ms:.4f} library_ms none "
                f"(no single PyTorch call runs a DPRNN stack) bound_ms {b_ms:.4f} ({b_by})")
    torch.cuda.synchronize()
    return rows


def stream_frames(rng, B, T, win):
    """[B, T, win] sample frames cut from continuous noisy tones, hop win/2."""
    hop = win // 2
    n = (T - 1) * hop + win
    t = np.arange(n) / 48000.0
    sig = np.stack([0.2 * np.sin(2 * np.pi * (200 + 70 * b) * t) + 0.05 * rng.standard_normal(n)
                    for b in range(B)]).astype(np.float32)
    idx = np.arange(T)[:, None] * hop + np.arange(win)[None, :]
    return sig[:, idx]


def stream_spans(T):
    """Throughput mode's forward_spec calls for T frames: the largest
    power-of-two bucket (up to 128) that fits, repeatedly."""
    spans, pos = [], 0
    while pos < T:
        step = max(b for b in (1, 2, 4, 8, 16, 32, 64, 128) if b <= T - pos)
        spans.append(step)
        pos += step
    return spans


def run_chunked(eng, frames, cuts, mode="exact"):
    st, ys, pos = eng.init_stream_state(batch=frames.shape[0]), [], 0
    for n in cuts:
        y, st = eng.process_frames(frames[:, pos:pos + n], st, mode=mode)
        ys.append(y)
        pos += n
    return np.concatenate(ys, axis=1)


def streaming_phase(cfg, eng, eng_stack, cpu_eng, gk, rng):
    """process_frames card vs CPU, launches per hop, chunk invariance."""
    B, T = 4, 40
    frames = stream_frames(rng, B, T, cfg.win_len)
    launches = {}
    for mode in ("exact", "throughput"):
        calls = T if mode == "exact" else len(stream_spans(T))
        t0 = time.perf_counter()
        ref, _ = cpu_eng.process_frames(frames, cpu_eng.init_stream_state(batch=B), mode=mode)
        t_cpu = time.perf_counter() - t0
        for name, e, on in (("per-stage", eng, False), ("stack", eng_stack, True)):
            with set_env(STACK, on):
                torch.cuda.synchronize()
                gk.reset_launch_counts()
                y, _ = e.process_frames(frames, e.init_stream_state(batch=B), mode=mode)
                torch.cuda.synchronize()
                counts = gk.launch_counts()
            per_call = ({"dprnn_stack": 2} if on else
                        {"dprnn_intra_block": 2 * cfg.dprnn_blocks,
                         "dprnn_inter_block": 2 * cfg.dprnn_blocks})
            per_call["gru_scan"] = 5
            expect_counts(f"streaming {mode} {name}", counts,
                          {k: v * calls for k, v in per_call.items()})
            if mode == "exact":
                launches[name] = counts
            if not np.isfinite(y).all():
                raise AssertionError(f"streaming {mode} {name}: output not finite")
            err = float(np.abs(y - ref).max())
            log(f"streaming {mode} {name} B={B} x {T} hops: card vs CPU max_abs {err:.3e} "
                f"(tol {ENGINE_TOL:.0e}); launches {json.dumps(counts)} = per forward_spec "
                f"call {json.dumps(per_call)} x {calls} calls (CPU run {t_cpu:.1f} s)")
            if not err <= ENGINE_TOL:
                raise AssertionError(f"streaming {mode} {name} deviates from the CPU by {err:.3e}")
            if mode == "exact":
                with set_env(STACK, on):
                    for cuts in ([1] * T, [3, 5] * (T // 8)):
                        other = run_chunked(e, frames, cuts)
                        if not np.array_equal(other, y):
                            raise AssertionError(
                                f"exact streaming {name}: chunking {cuts[:4]}... differs from "
                                f"all-at-once by {float(np.abs(other - y).max()):.3e}")
                log(f"exact streaming {name}: bit-identical for chunkings all-at-once, "
                    f"1+1+..., 3+5+...")
    return launches


def enhancer_phase(cfg, eng, rng):
    """StreamEnhancer and MultiStreamEnhancer on the card."""
    from dpdfnet_tpu_torch import MultiStreamEnhancer, StreamEnhancer

    sr, hop = cfg.sample_rate, cfg.hop
    x = (0.1 * rng.standard_normal(sr)).astype(np.float32)                  # 1 s
    sizes = [331, 97, 1203, 7, 3 * hop + 1, 4999]

    def chunked(se, sig):
        outs, pos, i = [], 0, 0
        while pos < len(sig):
            outs.append(se.process(sig[pos:pos + sizes[i % len(sizes)]]))
            pos += sizes[i % len(sizes)]
            i += 1
        return outs

    se = StreamEnhancer(engine=eng)
    a = np.concatenate(chunked(se, x[: sr // 2]))
    snap = se.save_state()
    b = np.concatenate(chunked(se, x[sr // 2:]))
    tail = se.flush()
    se2 = StreamEnhancer(engine=eng)
    se2.load_state(snap)
    b2 = np.concatenate(chunked(se2, x[sr // 2:]))
    if not np.array_equal(b, b2):
        raise AssertionError("StreamEnhancer: save_state -> load_state does not resume bit-exact")
    if not 0 < tail.size <= hop:
        raise AssertionError(f"StreamEnhancer.flush returned {tail.size} samples (hop {hop})")
    whole = np.concatenate([a, b, tail])
    if whole.shape != x.shape or not np.isfinite(whole).all():
        raise AssertionError(f"StreamEnhancer output {whole.shape}, finite "
                             f"{np.isfinite(whole).all()}")
    log(f"StreamEnhancer: chunks {sizes}, {whole.size} samples out for {x.size} in, "
        f"save/load resume bit-exact, flush {tail.size} samples (<= hop {hop})")

    pool = MultiStreamEnhancer(capacity=8, engine=eng)
    sids = [pool.open() for _ in range(8)]
    xs = [(0.1 * rng.standard_normal(sr // 2)).astype(np.float32) for _ in sids]
    cadence = [hop, 2 * hop, 3 * hop + 17, 5 * hop, 999, hop // 2, 7 * hop, 4001]
    outs = {sid: [] for sid in sids}
    pos = {sid: 0 for sid in sids}
    while any(pos[s] < len(xs[s]) for s in sids):
        feed = {}
        for i, sid in enumerate(sids):
            if pos[sid] < len(xs[sid]):
                feed[sid] = xs[sid][pos[sid]:pos[sid] + cadence[i]]
                pos[sid] += cadence[i]
        for sid, y in pool.process_many(feed).items():
            outs[sid].append(y)
    worst = 0.0
    for sid in sids:
        got = np.concatenate(outs[sid] + [pool.flush(sid)])
        lone = StreamEnhancer(engine=eng)
        ref = np.concatenate([lone.process(xs[sid]), lone.flush()])
        if got.shape != ref.shape:
            raise AssertionError(f"pool slot {sid}: {got.shape} samples vs lone {ref.shape}")
        worst = max(worst, float(np.abs(got - ref).max()))
    log(f"MultiStreamEnhancer: 8 slots, cadences {cadence} samples per call: each slot vs a "
        f"lone StreamEnhancer max_abs {worst:.3e} (tol {ENGINE_TOL:.0e})")
    if not worst <= ENGINE_TOL:
        raise AssertionError(f"pool slots deviate from lone streams by {worst:.3e}")


def unfused_phase(cfg, params, cpu_params, gk, rng):
    """Engine(fuse=False): the raw-params route through gru_bidir."""
    from dpdfnet_tpu_torch import Engine

    sr = cfg.sample_rate
    lengths = np.array([int(0.6 * sr), int(1.0 * sr), int(1.4 * sr)])
    S = int(lengths.max())
    wavs = np.zeros((3, S), np.float32)
    for i, ln in enumerate(lengths):
        wavs[i, :ln] = 0.1 * rng.standard_normal(ln)
    eng = Engine(cfg, params, fuse=False, device="cuda")
    eng.enhance_waveforms(wavs[:, : sr // 4])                                # warm-up
    torch.cuda.synchronize()
    gk.reset_launch_counts()
    y = eng.enhance_waveforms(wavs, lengths=lengths)
    torch.cuda.synchronize()
    counts = gk.launch_counts()
    n_seg = segments(eng, S)
    ref = Engine(cfg, cpu_params, fuse=False, device="cpu").enhance_waveforms(wavs, lengths=lengths)
    err = float(np.abs(y - ref).max())
    per_seg = {"gru_bidir": 2 * cfg.dprnn_blocks, "gru_scan": 5 + 2 * cfg.dprnn_blocks}
    log(f"engine fuse=False B=3 (0.6/1.0/1.4 s): card vs CPU max_abs {err:.3e} "
        f"(tol {ENGINE_TOL:.0e}); launches ({n_seg} segments) {json.dumps(counts)}, "
        f"expected per segment {json.dumps(per_seg)}")
    if not np.isfinite(y).all() or not err <= ENGINE_TOL:
        raise AssertionError(f"fuse=False engine deviates from the CPU by {err:.3e}")
    expect_counts("engine fuse=False", counts, {k: v * n_seg for k, v in per_seg.items()})
    return counts


def stream_throughput(cfg, engines, order, smi, rng):
    """Exact mode, 64 streams x 200 hops, one call per hop; throughput mode
    at 8 hops per call.  ``engines``: name -> (engine, stack on), run in
    ``order`` (A, B, B, A pairs the two within one call)."""
    B, T = 64, 200
    hop_s = cfg.hop / cfg.sample_rate
    frames = stream_frames(rng, B, T, cfg.win_len)
    res = {}
    for name in order:
        e, on = engines[name]
        with set_env(STACK, on):
            for mode, per_call in (("exact", 1), ("throughput", 8)):
                st = e.init_stream_state(batch=B)
                for i in range(0, 16, per_call):                            # warm-up
                    _, st = e.process_frames(frames[:, i:i + per_call], st, mode=mode)
                st = e.init_stream_state(batch=B)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(0, T, per_call):
                    y, st = e.process_frames(frames[:, i:i + per_call], st, mode=mode)
                torch.cuda.synchronize()
                ms_hop = (time.perf_counter() - t0) * 1e3 / T
                if not np.isfinite(y).all():
                    raise AssertionError(f"stream throughput {name} {mode}: not finite")
                res.setdefault((name, mode), []).append(ms_hop)
                log(f"streaming {mode} {name}: {B} streams x {T} hops, {per_call} hop(s) per "
                    f"call: {ms_hop:.3f} ms per hop, streams at real time "
                    f"{B * hop_s * 1e3 / ms_hop:.1f} | {smi}")
    return res


def v2_wrapper_phase(params, cfg, gk):
    """The v2 stage kernels reached from their wrappers: every DPRNN block
    of both branches as ``dprnn_intra_block_v2`` then ``dprnn_inter_block_v2``
    on an offline plane x[8, 112, Fq, 64] from zero hiddens, against the v1
    kernels on the same plane.  With float32 projections the two chains are
    one function in another summation order (ENGINE_TOL over 8 blocks);
    with bfloat16 projections (the v2 defaults) the deviation is reported.
    Returns the launches of the float32 chain."""
    B, T, C = 8, 112, cfg.conv_ch
    g = torch.Generator(device="cuda").manual_seed(2)
    counts = {}

    def chain(blocks, x, v2, xp_bf16):
        Fq = x.shape[2]
        h0 = torch.zeros(B, Fq, C, device="cuda")
        for blk in blocks:
            intra, inter = blk["intra"], blk["inter"]
            pk, gw = intra["packed"], inter["gru"]
            epi_i = (intra["fc"]["b"], intra["ln"]["g"], intra["ln"]["b"])
            epi_t = (inter["fc"]["b"], inter["ln"]["g"], inter["ln"]["b"])
            rows = x.reshape(B * T, Fq, C)
            if v2:
                wi_cat, wh_big = gk.pack_intra_v2(pk["wi2"], pk["wh2"], intra["fc"]["w"])
                x = gk.dprnn_intra_block_v2(rows, wi_cat, wh_big, pk["b2"], *epi_i,
                                            xp_bf16=xp_bf16).reshape(B, T, Fq, C)
                xp = x @ gw["wi"] + gw["bi"]
                whfc = torch.cat([gw["wh"], inter["fc"]["w"]], dim=1)
                x, _ = gk.dprnn_inter_block_v2(xp.to(torch.bfloat16) if xp_bf16 else xp, x,
                                               h0, whfc, gw["bh"], *epi_t)
            else:
                x = gk.dprnn_intra_block(rows, pk["wi2"], pk["wh2"], pk["b2"],
                                         intra["fc"]["w"], *epi_i).reshape(B, T, Fq, C)
                x, _ = gk.dprnn_inter_block(x, h0, gw["wi"], gw["bi"], gw["wh"], gw["bh"],
                                            inter["fc"]["w"], *epi_t)
        return x

    for branch, Fq in (("dprnn_erb", cfg.dprnn_erb_feat), ("dprnn_df", cfg.dprnn_df_feat)):
        blocks = params["enc"][branch]
        x = torch.randn((B, T, Fq, C), generator=g, device="cuda")
        ref = chain(blocks, x, False, False)
        torch.cuda.synchronize()
        gk.reset_launch_counts()
        y = chain(blocks, x, True, False)
        torch.cuda.synchronize()
        for k, v in gk.launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        y_bf = chain(blocks, x, True, True)
        err = float((y - ref).abs().max())
        err_bf = float((y_bf - ref).abs().max())
        log(f"v2 stage kernels from their wrappers, {branch} ({len(blocks)} blocks) "
            f"x[{B},{T},{Fq},{C}]: f32 xp vs the v1 kernels max_abs {err:.3e} "
            f"(tol {ENGINE_TOL:.0e}); bf16 xp (the v2 defaults) vs v1 {err_bf:.3e}")
        if not (err <= ENGINE_TOL and torch.isfinite(y_bf).all()):
            raise AssertionError(f"v2 chain {branch} deviates from the v1 kernels by {err:.3e}")
    K = cfg.dprnn_blocks
    expect_counts("v2 stage kernels from their wrappers", counts,
                  {"dprnn_intra_block_v2": 2 * K, "dprnn_inter_block_v2": 2 * K})
    return counts


def tier_phase(cfg, params, cpu_params, gk, smi, rng, wavs, lengths):
    """The quality tiers on the card.  Returns the launches of the
    ``turbo`` + V2 offline path."""
    from dpdfnet_tpu_torch.quality import speechlike_test_signal, tier_deviation
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality
    from dpdfnet_tpu_torch.utils.tree import tree_leaves

    K = cfg.dprnn_blocks
    # ---- deviation from highest (contracted weights, speech-like input) ----
    for v2 in (False, True):
        with set_env(STACK, False), set_env(V2, v2):
            dev = tier_deviation(MODEL, params=params, contract=None, device="cuda",
                                 tiers=("high", "fast", "turbo"))
        for tier in ("high", "fast", "turbo"):
            d = dev[tier]
            log(f"tier_deviation {MODEL} {tier}{' +V2' if v2 else ''} vs highest (B=2 x 4 s): "
                f"max_abs {d['max_abs']:.3e} (tol {TIER_TOL:.0e}), rel_rms {d['rel_rms']:.3e} "
                f"(tol {TIER_REL_RMS:g}; highest's output rms {dev['_ref_rms']:.3e}), "
                f"{d['rms_vs_input_db']:.1f} dB vs input")
            if not (d["max_abs"] <= TIER_TOL and d["rel_rms"] <= TIER_REL_RMS):
                raise AssertionError(f"tier {tier} (V2 {v2}) deviates from highest by "
                                     f"{d['max_abs']:.3e} max-abs, {d['rel_rms']:.3e} rel_rms")

    # ---- engines ----
    engines = {}
    for name, q, v2 in (("highest", "highest", False), ("fast", "fast", False),
                        ("turbo", "turbo", False), ("turbo+V2", "turbo", True)):
        with set_env(STACK, False), set_env(V2, v2):
            engines[name] = (engine_from_quality(cfg, params, q, device="cuda"), v2)

    # ---- launches per segment on each tier's offline path ----
    S = int(lengths.max())
    per_seg = {"dprnn_intra_block": 2 * K, "dprnn_inter_block": 2 * K, "gru_scan": 5}
    per_seg_v2 = {"dprnn_intra_block": 2 * K, "dprnn_inter_block_v2": 2 * K, "gru_scan": 5}
    ys, v2_counts = {}, None
    for name in ("highest", "fast", "turbo", "turbo+V2"):
        e, v2 = engines[name]
        with set_env(STACK, False), set_env(V2, v2):
            e.enhance_waveforms(wavs[:, : cfg.sample_rate // 2])             # warm-up
            torch.cuda.synchronize()
            gk.reset_launch_counts()
            ys[name] = e.enhance_waveforms(wavs, lengths=lengths)
            torch.cuda.synchronize()
            counts = gk.launch_counts()
        n_seg = segments(e, S)
        want = per_seg_v2 if v2 else per_seg
        dev = float(np.abs(ys[name] - ys["highest"]).max())
        log(f"tier {name} offline B=3 (1.3/2.0/3.1 s): launches ({n_seg} segments) "
            f"{json.dumps(counts)}, expected per segment {json.dumps(want)}; "
            f"vs highest max_abs {dev:.3e}")
        if not np.isfinite(ys[name]).all():
            raise AssertionError(f"tier {name}: output not finite")
        expect_counts(f"tier {name} offline", counts, {k: n_seg * v for k, v in want.items()})
        if v2:
            v2_counts = counts

    # ---- exact turbo streaming: card, bit-identical across chunkings ----
    B, T = 4, 40
    frames = stream_frames(rng, B, T, cfg.win_len)
    for name in ("turbo", "turbo+V2"):
        e, v2 = engines[name]
        with set_env(STACK, False), set_env(V2, v2):
            torch.cuda.synchronize()
            gk.reset_launch_counts()
            y = run_chunked(e, frames, [T])
            torch.cuda.synchronize()
            counts = gk.launch_counts()
            expect_counts(f"exact streaming {name}", counts,
                          {k: T * v for k, v in (per_seg_v2 if v2 else per_seg).items()})
            for cuts in ([1] * T, [3, 5] * (T // 8)):
                other = run_chunked(e, frames, cuts)
                if not np.array_equal(other, y):
                    raise AssertionError(
                        f"exact streaming {name}: chunking {cuts[:4]}... differs from "
                        f"all-at-once by {float(np.abs(other - y).max()):.3e}")
            y_tp, _ = e.process_frames(frames, e.init_stream_state(batch=B), mode="throughput")
            st = e.init_stream_state(batch=B)
        dtypes = sorted({str(v.dtype).replace("torch.", "") for _, v in tree_leaves(st)})
        y_hi = run_chunked(engines["highest"][0], frames, [T])
        log(f"exact streaming {name} B={B} x {T} hops: bit-identical for chunkings "
            f"all-at-once, 1+1+..., 3+5+...; launches per hop "
            f"{json.dumps({k: v // T for k, v in counts.items() if v})}; state leaves "
            f"{dtypes}; vs highest max_abs {float(np.abs(y - y_hi).max()):.3e}; throughput "
            f"mode vs exact {float(np.abs(y_tp - y).max()):.3e}")
        if not (np.isfinite(y).all() and np.isfinite(y_tp).all()):
            raise AssertionError(f"streaming {name}: output not finite")

    # ---- turbo on the card against turbo on the CPU, speech-shaped input ----
    sr, n_hops = cfg.sample_rate, 16
    sp = speechlike_test_signal(1.0, sr, seed=5, batch=2)
    sp_frames = sp[:, sr // 4 + np.arange(n_hops)[:, None] * cfg.hop
                   + np.arange(cfg.win_len)[None, :]]
    for name in ("turbo", "turbo+V2"):
        e, v2 = engines[name]
        with set_env(STACK, False), set_env(V2, v2):
            cpu = engine_from_quality(cfg, cpu_params, "turbo", device="cpu")
            y_off, ref_off = e.enhance_waveforms(sp), cpu.enhance_waveforms(sp)
            y_st, st = e.process_frames(sp_frames, e.init_stream_state(batch=2))
            ref_st, st_ref = cpu.process_frames(sp_frames, cpu.init_stream_state(batch=2))
        off_abs, off_rel = float(np.abs(y_off - ref_off).max()), rel_rms(y_off, ref_off)
        st_rel = rel_rms(y_st, ref_st)
        leaves_ref = dict(tree_leaves(st_ref))
        worst_leaf = (0.0, "")
        for k, v in tree_leaves(st):
            if v.dtype != leaves_ref[k].dtype:
                raise AssertionError(f"turbo {name} state leaf {k}: {v.dtype} on the card, "
                                     f"{leaves_ref[k].dtype} on the CPU")
            worst_leaf = max(worst_leaf, (rel_rms(v.float().cpu().numpy(),
                                                  leaves_ref[k].float().numpy()), k))
        log(f"{name} card vs CPU, speech-shaped input: offline B=2 x 1 s max_abs "
            f"{off_abs:.3e} (tol {TIER_TOL:.0e}), rel_rms {off_rel:.3e} (tol "
            f"{TIER_REL_RMS:g}); exact streaming B=2 x {n_hops} hops rel_rms {st_rel:.3e} (tol "
            f"{TURBO_STREAM_REL_RMS:g}), worst state leaf {worst_leaf[1]} rel_rms "
            f"{worst_leaf[0]:.3e} (tol {TURBO_STATE_REL_RMS:g}), leaf dtypes equal")
        if not (off_abs <= TIER_TOL and off_rel <= TIER_REL_RMS and st_rel <= TURBO_STREAM_REL_RMS
                and worst_leaf[0] <= TURBO_STATE_REL_RMS):
            raise AssertionError(f"{name} on the card deviates from the CPU engine")

    # ---- StreamEnhancer and MultiStreamEnhancer on a turbo engine ----
    with set_env(STACK, False), set_env(V2, False):
        enhancer_phase(cfg, engines["turbo"][0], rng)

    # ---- offline xRT per tier, B=64 x 4 s ----
    Bb, secs = 64, 4.0
    big = (0.1 * rng.standard_normal((Bb, int(secs * cfg.sample_rate)))).astype(np.float32)
    order = ("highest", "fast", "turbo", "turbo+V2", "turbo+V2", "turbo", "fast", "highest")
    for name in order:
        e, v2 = engines[name]
        with set_env(STACK, False), set_env(V2, v2):
            e.enhance_waveforms(big)                                        # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = e.enhance_waveforms(big)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        if not np.isfinite(out).all():
            raise AssertionError(f"throughput output ({name}) is not finite")
        wall = statistics.median(times)
        segs = segments(e, big.shape[1])
        log(f"throughput {MODEL} tier {name} B={Bb} x {secs} s: xRT {Bb * secs / wall:.1f}, "
            f"median {wall * 1e3:.1f} ms per call (runs {[round(t * 1e3, 1) for t in times]}), "
            f"{wall * 1e3 / segs:.2f} ms per segment, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | {smi}")

    # ---- per-call weight casts under turbo: every float weight leaf once ----
    e = engines["turbo"][0]
    leaves = [v for _, v in tree_leaves(e.params)
              if isinstance(v, torch.Tensor) and v.is_floating_point()]
    cast_ms = cuda_ms(lambda: [w.to(torch.bfloat16) for w in leaves])
    log(f"turbo weight casts: casting all {len(leaves)} float32 weight leaves "
        f"({sum(w.numel() for w in leaves) * 4 / 2 ** 20:.1f} MiB) to bf16 once takes "
        f"{cast_ms:.4f} ms of device time (an upper bound of one forward_spec call's casts)")

    # ---- streaming ms per hop, highest against turbo ----
    stream_throughput(cfg, {"highest": (engines["highest"][0], False),
                            "turbo": (engines["turbo"][0], False)},
                      ("highest", "turbo", "turbo", "highest"), smi, rng)
    return v2_counts


def relayout_phase(gk):
    """relayout_fm against its plain version, bit-exact; times at every
    shape.  Returns the kernel-line numbers at [64, 112, 48, 64] f32."""
    g = torch.Generator(device="cuda").manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    row = None
    for shape, src, dst in (((64, 112, 40, 64), f32, f32), ((64, 112, 48, 64), f32, f32),
                            ((64, 112, 40, 64), f32, bf16), ((64, 112, 48, 64), f32, bf16),
                            ((5, 7, 13, 6), f32, bf16), ((3, 9, 11, 64), bf16, f32)):
        x = torch.randn(shape, generator=g, device="cuda").to(src)
        got = gk.relayout_fm(x, out_dtype=dst)
        ref = gk.relayout_fm_plain(x, dst)
        if not torch.equal(got, ref):
            raise AssertionError(f"relayout_fm {shape} {src} -> {dst} differs from its plain "
                                 f"version by {(got.float() - ref.float()).abs().max():.3e}")
        out = torch.empty_like(ref)
        xp = x.permute(2, 1, 0, 3)
        ms = cuda_ms(lambda: gk.relayout_fm(x, out_dtype=dst), 20)
        plain_ms = cuda_ms(lambda: gk.relayout_fm_plain(x, dst), 20)
        lib_ms = cuda_ms((lambda: xp.contiguous()) if src == dst else (lambda: out.copy_(xp)), 20)
        b_ms, b_by = bound(0, x.numel() * (x.element_size() + ref.element_size()))
        log(f"kernel relayout_fm x[{','.join(map(str, shape))}] {str(src)[6:]} -> "
            f"{str(dst)[6:]}: bit-exact (max_abs 0); ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {lib_ms:.4f} ({'permute().contiguous()' if src == dst else 'copy_ of the permuted view'}) "
            f"bound_ms {b_ms:.4f} ({b_by}; {b_ms / ms:.2f} of it)")
        if shape == (64, 112, 48, 64) and src == dst:
            row = dict(err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
    return row


def mode_off_phase(gk):
    """Every DPRNN / GRU kernel (DPRNN intra / inter and their v2 forms,
    gru_scan, gru_bidir, the stack) with its layout modes off, against the
    committed digests (``tools/mode_off_digests.json``): bit-identical
    outputs."""
    from dpdfnet_tpu_torch.tools import mode_off_digest as mod

    record = json.loads(mod.RECORD.read_text())
    here = mod.toolchain()
    bad = mod.compare(mod.kernel_digests(gk), record, here)
    if bad:
        raise AssertionError("mode off: not bit-identical to the committed digests:\n  "
                             + "\n  ".join(bad))
    log(f"mode off: {len(record['digests'])} cases of the DPRNN / GRU kernels bit-identical "
        f"(SHA-256 of their outputs, max_abs 0) to the committed record "
        f"({json.dumps(record['toolchain'])})")


def fm_modes_phase(params, cfg, gk):
    """The intra / inter kernels' fm layout modes at B=64 x 112 frames, Fq
    48: against the plain versions, fused modes bit-identical to the
    row-major mode on the same rows, and both DPRNN stacks bit-identical
    through the fm chain and the row-major chain.  Returns kernel-line rows."""
    from dpdfnet_tpu_torch.models import dpdfnet as tmd

    B, T, C, Fq = 64, 112, cfg.conv_ch, cfg.dprnn_df_feat
    g = torch.Generator(device="cuda").manual_seed(4)
    blk = params["enc"]["dprnn_df"][0]
    intra, inter = blk["intra"], blk["inter"]
    pk, gw = intra["packed"], inter["gru"]
    ia = (pk["wi2"], pk["wh2"], pk["b2"], intra["fc"]["w"], intra["fc"]["b"],
          intra["ln"]["g"], intra["ln"]["b"])
    ea = (gw["wi"], gw["bi"], gw["wh"], gw["bh"], inter["fc"]["w"], inter["fc"]["b"],
          inter["ln"]["g"], inter["ln"]["b"])
    rows = {}
    x4 = torch.randn((B, T, Fq, C), generator=g, device="cuda")

    # ---- intra, fm_batch ----
    plane = x4.permute(2, 1, 0, 3).reshape(Fq, T * B, C).contiguous()
    got = gk.dprnn_intra_block(plane, *ia, fm_batch=B)
    err = check("dprnn_intra_block fm_batch", got,
                gk.dprnn_intra_block_plain(plane, *ia, fm_batch=B))
    rm_in = x4.transpose(0, 1).reshape(T * B, Fq, C).contiguous()
    rm = gk.dprnn_intra_block(rm_in, *ia)
    if not torch.equal(got, rm.reshape(T, B, Fq, C).transpose(1, 2)):
        raise AssertionError("dprnn_intra_block: the fm mode is not bit-identical to the "
                             "row-major mode")
    err_b = check_bf16("dprnn_intra_block fm_batch bf16 plane",
                       gk.dprnn_intra_block(plane.to(torch.bfloat16), *ia, fm_batch=B),
                       gk.dprnn_intra_block_plain(plane.to(torch.bfloat16), *ia, fm_batch=B))
    ms = cuda_ms(lambda: gk.dprnn_intra_block(plane, *ia, fm_batch=B))
    ms_rm = cuda_ms(lambda: gk.dprnn_intra_block(rm_in, *ia))
    plain_ms = cuda_ms(lambda: gk.dprnn_intra_block_plain(plane, *ia, fm_batch=B), 3)
    lib_gru = gru_module(intra["fw"]["wi"], intra["fw"]["bi"], intra["fw"]["wh"],
                         intra["fw"]["bh"], bidir=intra["bw"])
    lib_in = plane.transpose(0, 1)

    def lib_intra():
        ys, _ = lib_gru(lib_in)
        return lib_in + torch.nn.functional.layer_norm(
            torch.nn.functional.linear(ys, intra["fc"]["w"].T, intra["fc"]["b"]),
            (C,), intra["ln"]["g"], intra["ln"]["b"], 1e-5)

    lib_ms = cuda_ms(lib_intra)
    n = B * T * Fq
    b_ms, b_by = bound(28 * C * C * n, 2 * C * 4 * n + 4 * sum(t.numel() for t in ia))
    rows["dprnn_intra_block_tm"] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"kernel dprnn_intra_block fm_batch={B} x[{Fq},{T * B},{C}] -> [{T},{Fq},{B},{C}]: "
        f"max_abs {err:.3e} (bf16 plane {err_b:.3e}; tol {KERNEL_TOL:.0e}), bit-identical to "
        f"the row-major mode; ms {ms:.4f} (row-major {ms_rm:.4f}) plain_ms {plain_ms:.4f} "
        f"library_ms {lib_ms:.4f} (cuDNN bidir GRU + linear + LN) bound_ms {b_ms:.4f} ({b_by})")

    # ---- inter, fm_batch x h_bm x defer ----
    x_fm = got.reshape(T, Fq * B, C)
    h4 = torch.randn((B, Fq, C), generator=g, device="cuda") * 0.5
    h_rows = h4.transpose(0, 1).reshape(Fq * B, C).contiguous()
    x_fm_out = x_fm.reshape(T, Fq, B, C).transpose(0, 1)
    rm_x = x_fm.reshape(T, Fq, B, C).permute(2, 0, 1, 3).contiguous()
    rm_out, rm_hl = gk.dprnn_inter_block(rm_x, h4, *ea, defer=False)
    ms_rm = cuda_ms(lambda: gk.dprnn_inter_block(rm_x, h4, *ea, defer=False))
    for h_bm in (False, True):
        for defer in (False, True):
            h0 = h4 if h_bm else h_rows
            out, hl = gk.dprnn_inter_block(x_fm, h0, *ea, fm_batch=B, h_bm=h_bm, defer=defer)
            ref, hl_ref = gk.dprnn_inter_block_plain(x_fm, h0, *ea, fm_batch=B, h_bm=h_bm,
                                                     defer=defer)
            if defer:
                ref = gk.inter_tail(ref, x_fm_out, *ea[4:])
            err = check(f"dprnn_inter_block fm h_bm={h_bm} defer={defer}", (out, hl),
                        (ref, hl_ref))
            same = ""
            if not defer:
                if not (torch.equal(out, rm_out.permute(2, 1, 0, 3)) and torch.equal(
                        hl if h_bm else hl.reshape(Fq, B, C).transpose(0, 1), rm_hl)):
                    raise AssertionError(f"dprnn_inter_block fm h_bm={h_bm}: not bit-identical "
                                         f"to the row-major mode")
                same = ", bit-identical to the row-major mode"
            ms = cuda_ms(lambda: gk.dprnn_inter_block(x_fm, h0, *ea, fm_batch=B, h_bm=h_bm,
                                                      defer=defer))
            log(f"kernel dprnn_inter_block fm_batch={B} h_bm={h_bm} defer={defer} "
                f"x[{T},{Fq * B},{C}]: max_abs {err:.3e} (tol {KERNEL_TOL:.0e}){same}; ms "
                f"{ms:.4f} (row-major {ms_rm:.4f}{'; the deferred tail in PyTorch included' if defer else ''})")
            rows[("inter_fm", h_bm, defer)] = dict(err=err, ms=ms)

    # ---- both DPRNN stacks: the fm chain against the row-major chain ----
    for branch, Fb in (("dprnn_erb", cfg.dprnn_erb_feat), ("dprnn_df", Fq)):
        x = torch.randn((B, T, Fb, C), generator=g, device="cuda")
        hs = [torch.randn((B, Fb, C), generator=g, device="cuda") * 0.5
              for _ in params["enc"][branch]]
        with set_env(TM, False):
            ref, hs_ref = tmd._dprnn(params["enc"][branch], x, hs)
        for entry in (False, True):
            with set_env(TM, True), set_env(ENTRY, entry):
                gk.reset_launch_counts()
                got, hs_got = tmd._dprnn(params["enc"][branch], x, hs)
                counts = gk.launch_counts()
            if counts["relayout_fm"] != int(entry) or not torch.equal(got, ref) or not all(
                    torch.equal(a, b) for a, b in zip(hs_got, hs_ref)):
                raise AssertionError(f"{branch}: the fm chain (entry relayout {entry}) is not "
                                     f"bit-identical to the row-major chain ({counts})")
        log(f"DPRNN stack {branch} x[{B},{T},{Fb},{C}]: the fm chain, with and without the "
            f"entry relayout, bit-identical to the row-major chain (max_abs 0, every hidden)")
    torch.cuda.synchronize()
    return rows


def fm_chain_phase(cfg, params, cpu_params, gk, smi, rng):
    """The fm chain: card vs CPU, exact streaming chunk invariance and
    launches per hop at 64 streams (the launches per segment on the main
    path are read in ``main``)."""
    from dpdfnet_tpu_torch import Engine
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality

    K, sr = cfg.dprnn_blocks, cfg.sample_rate
    with set_env(STACK, False):
        eng = Engine(cfg, params, device="cuda")
    # ---- card against CPU, B = 32 x 1 s, with and without the entry relayout ----
    w32 = (0.1 * rng.standard_normal((32, sr))).astype(np.float32)
    t0 = time.perf_counter()
    with set_env(STACK, False), set_env(TM, True):
        ref = Engine(cfg, cpu_params, device="cpu").enhance_waveforms(w32)
    t_cpu = time.perf_counter() - t0
    for entry in (False, True):
        with set_env(STACK, False), set_env(TM, True), set_env(ENTRY, entry):
            y = eng.enhance_waveforms(w32)
        err = float(np.abs(y - ref).max())
        log(f"fm chain B=32 x 1 s (entry relayout {entry}): card vs CPU max_abs {err:.3e} "
            f"(tol {ENGINE_TOL:.0e}; CPU run {t_cpu:.1f} s)")
        if not (np.isfinite(y).all() and err <= ENGINE_TOL):
            raise AssertionError(f"fm chain on the card deviates from the CPU by {err:.3e}")

    # ---- exact streaming at 64 streams through the fm chain (T == 1) ----
    frames = stream_frames(rng, 64, 12, cfg.win_len)
    with set_env(STACK, False), set_env(TM, True):
        torch.cuda.synchronize()
        gk.reset_launch_counts()
        y = run_chunked(eng, frames, [12])
        torch.cuda.synchronize()
        counts = gk.launch_counts()
        expect_counts("fm chain exact streaming", counts,
                      {"dprnn_intra_block": 12 * 2 * K, "dprnn_inter_block": 12 * 2 * K,
                       "gru_scan": 12 * 5})
        for cuts in ([1] * 12, [3, 5, 4]):
            other = run_chunked(eng, frames, cuts)
            if not np.array_equal(other, y):
                raise AssertionError(f"fm chain exact streaming: chunking {cuts[:4]} differs "
                                     f"by {float(np.abs(other - y).max()):.3e}")
        with set_env(TM, False):
            y_rm = run_chunked(eng, frames, [12])
    # the DPRNN stacks are bit-identical (phase 12); the exit contraction
    # (grouped_linear_fm against grouped_linear) sums in another order
    rm_err = float(np.abs(y - y_rm).max())
    log(f"fm chain exact streaming 64 streams x 12 hops: bit-identical for chunkings "
        f"all-at-once, 1+1+..., 3+5+4; launches per hop "
        f"{json.dumps({k: v // 12 for k, v in counts.items() if v})}; vs the row-major chain "
        f"max_abs {rm_err:.3e} (tol {KERNEL_TOL:.0e})")
    if not rm_err <= KERNEL_TOL:
        raise AssertionError(f"fm chain exact streaming deviates from the row-major chain by "
                             f"{rm_err:.3e}")


def fm_ab_phase(cfg, params, smi, rng):
    """The A/B of the fm chain, in highest and turbo: the chain off
    (row-major), on, and on with the entry relayout, interleaved call by
    call (the switches are read per call), so that drift of the shared host
    cancels: offline B=64 x 4 s, 5 rounds, median xRT; exact streaming at
    64 streams, one hop per call, 200 rounds of one hop per configuration
    (each with its own stream state), median ms per hop.  Returns the
    medians."""
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality

    Bb, secs, hops = 64, 4.0, 200
    big = (0.1 * rng.standard_normal((Bb, int(secs * cfg.sample_rate)))).astype(np.float32)
    sframes = stream_frames(rng, Bb, hops + 16, cfg.win_len)
    cfgs = {"row-major": (False, False), "fm": (True, False), "fm+relayout": (True, True)}
    res = {}

    def timed(name, fn):
        tm, entry = cfgs[name]
        with set_env(STACK, False), set_env(TM, tm), set_env(ENTRY, entry):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    for q in ("highest", "turbo"):
        e = engine_from_quality(cfg, params, q, device="cuda")
        walls = {n: [] for n in cfgs}
        for rnd in range(6):                                    # round 0 warms up
            for name in cfgs:
                t, out = timed(name, lambda: e.enhance_waveforms(big))
                if not np.isfinite(out).all():
                    raise AssertionError(f"A/B {q} {name}: offline output not finite")
                if rnd:
                    walls[name].append(t)
        states = {n: e.init_stream_state(batch=Bb) for n in cfgs}
        hop_ms = {n: [] for n in cfgs}
        for i in range(hops + 16):                              # 16 warm-up hops
            for name in cfgs:
                t, (ys, states[name]) = timed(
                    name, lambda: e.process_frames(sframes[:, i:i + 1], states[name]))
                if i >= 16:
                    hop_ms[name].append(t * 1e3)
        if not np.isfinite(ys).all():
            raise AssertionError(f"A/B {q}: streaming output not finite")
        for name in cfgs:
            xrt = Bb * secs / statistics.median(walls[name])
            med, mean = statistics.median(hop_ms[name]), statistics.fmean(hop_ms[name])
            res[(q, name)] = (xrt, med)
            log(f"A/B {q} {name}: offline B={Bb} x {secs} s xRT {xrt:.1f} (median of 5 "
                f"interleaved calls, runs {[round(t * 1e3, 1) for t in walls[name]]} ms); exact "
                f"64 streams, {hops} interleaved hops: median {med:.3f} ms per hop, mean "
                f"{mean:.3f} | {smi}")
    return res


def ablation_phase(smi):
    """Both step-ablation tools: every specialization against its plain
    version at a small size (both plane dtypes) and at the JAX tools'
    default shapes on the inputs that are timed, ``full`` bit for bit
    against the production kernel at both sizes and plane dtypes, the FFMA
    and spill instructions of each specialization's kernel, then one timing
    pass of every variant there.  Returns the kernel-line rows, with
    ``full``'s max-abs at the default shapes."""
    from dpdfnet_tpu_torch.ops import gru_kernels as gk
    from dpdfnet_tpu_torch.tools import inter_step_ablation as abl_e
    from dpdfnet_tpu_torch.tools import intra_step_ablation as abl_i
    from dpdfnet_tpu_torch.tools import sass_counts

    def gate(tool, errs):
        bad = {k: v for k, v in errs.items() if not v <= KERNEL_TOL}
        if bad:
            raise AssertionError(f"{tool} ablation {bad}: beyond one bf16 ulp of the plain "
                                 f"version by more than {KERNEL_TOL:.0e}")

    def same_as_production(tool, mod, dtype, *shape, seed=1):
        same = mod.full_matches_production(*shape, dtype=dtype, seed=seed)
        log(f"{tool} step ablation full x{list(shape)} {str(dtype).replace('torch.', '')}: "
            f"bit-identical to the production kernel {same}")
        if not all(same.values()):
            raise AssertionError(f"{tool} ablation full differs from the production kernel: "
                                 f"{same}")

    for dtype in (torch.bfloat16, torch.float32):
        for tool, mod, shape in (("intra", abl_i, (40, 16)), ("inter", abl_e, (40, 9))):
            gate(tool, mod.check_specializations(*shape, dtype=dtype, log=log))
            same_as_production(tool, mod, dtype, *shape)
    rows = {}
    C = 64
    sms = gk._sm_count(torch.device("cuda"))
    for tool, mod, run in (("intra", abl_i, abl_i.run_intra), ("inter", abl_e, abl_e.run_inter)):
        nrows, T = kernel_ab.ABLATION_SHAPES[tool]
        # every specialization (intra: both layouts) at the timed shape, on
        # the timed inputs (seed 0): grid, row-tail and offset faults show here
        gate(tool, mod.check_specializations(nrows, T, log=log, seed=0))
        for dtype in (torch.bfloat16, torch.float32):
            same_as_production(tool, mod, dtype, nrows, T, seed=0)
        # FFMAs and spills in the SASS of each kernel at the timed plan, bf16
        # planes: the product-keeping specializations against full and the
        # production kernel
        if tool == "intra":
            args = f"<{gk.intra_plan(nrows, T, sms).rows_per_warp}, __nv_bfloat16"
        else:
            plan = gk.inter_v1_plan(nrows, T, sms)
            args = f"<{plan.rows_per_warp}, {plan.ts}, "
        for lib in (f"dprnn_{tool}", f"{tool}_step_ablation") + (
                ("dprnn_intra_v2",) if tool == "intra" else ()):
            for name, n in sorted(sass_counts(lib).items()):
                if args in name and "bfloat16" in name:
                    log(f"sass {lib}: {n['FFMA']} FFMA, {n['LDL'] + n['STL']} local loads and "
                        f"stores in {name.split('(')[0]}")
        log(f"{tool} step ablation, rows {nrows}, T {T}, C {C}, bf16 planes | {smi}")
        run.launches = 0
        res = mod.time_variants(list(mod.VARIANTS), nrows, T, C, log=log)
        launches = run.launches
        f = kernel_ab.ablation_full(tool)
        ref, got = f["plain"](), f["kernel"]()
        plain_ms = cuda_ms(f["plain"], 3)
        lib_ms = cuda_ms(f["library"])
        b_ms, b_by = bound(f["flops"], f["nbytes"])
        spec, ms, ns = res["full"]
        err = (got.float() - ref.float()).abs().max().item()
        beyond = gk.err_beyond_bf16_ulp(got, ref)
        gate(tool, {"full": beyond})
        rows[tool] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by, launches=launches)
        log(f"{tool} step ablation full: max_abs {err:.3e} ({beyond:.3e} beyond one bf16 "
            f"ulp; tol {KERNEL_TOL:.0e}) ms {ms:.4f} ({ns:.1f} ns/step) plain_ms "
            f"{plain_ms:.4f} library_ms {lib_ms:.4f} (cuDNN GRU + linear + LN on the same "
            f"rows) bound_ms {b_ms:.4f} ({b_by}); {launches} launches in the timing pass")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    from dpdfnet_tpu_torch import Engine, get_config
    from dpdfnet_tpu_torch.models.params import contract_params, init_params
    from dpdfnet_tpu_torch.models.fuse import prepare_inference_params
    from dpdfnet_tpu_torch.ops import _build
    from dpdfnet_tpu_torch.ops import gru_kernels as gk
    from dpdfnet_tpu_torch.utils.tree import tree_map

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per library "
        + json.dumps({k: round(v, 1) for k, v in built.items()}))
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    cfg = get_config(MODEL)
    params = contract_params(init_params(cfg, seed=0, device="cuda"))
    cpu_params = tree_map(lambda _, x: x.cpu(), params)

    # ---- phase 2: kernels vs plain versions ----
    kernel_rows = kernel_phase(prepare_inference_params(params, cfg), cfg, gk)
    not_v1 = [r["shape"] + " " + r["plane"] for r in kernel_ab.kernel_rows(gk, log)
              if r.get("bits_v1") is False]
    if not_v1:
        raise AssertionError(f"dprnn_intra_block_v2 with f32 xp not bit-identical to "
                             f"dprnn_intra_block at {not_v1}")

    # ---- phase 3: the main path, card vs CPU ----
    rng = np.random.default_rng(0)
    sr = cfg.sample_rate
    lengths = np.array([int(1.3 * sr), int(2.0 * sr), int(3.1 * sr)])
    S = int(lengths.max())
    t = np.arange(S) / sr
    wavs = np.zeros((3, S), np.float32)
    for i, ln in enumerate(lengths):
        tone = 0.2 * np.sin(2 * np.pi * (220 + 110 * i) * t[:ln])
        wavs[i, :ln] = tone + 0.05 * rng.standard_normal(ln)
    with set_env(STACK, False):
        eng = Engine(cfg, params, device="cuda")
    eng.enhance_waveforms(wavs[:, : sr // 2])              # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    gk.reset_launch_counts()
    y_gpu = eng.enhance_waveforms(wavs, lengths=lengths)
    torch.cuda.synchronize()
    counts = gk.launch_counts()
    n_seg = segments(eng, S)
    t_cpu = time.perf_counter()
    cpu_eng = Engine(cfg, cpu_params, device="cpu")
    y_cpu = cpu_eng.enhance_waveforms(wavs, lengths=lengths)
    t_cpu = time.perf_counter() - t_cpu
    if not np.isfinite(y_gpu).all():
        raise AssertionError("engine output is not finite")
    dev_err = float(np.abs(y_gpu - y_cpu).max())
    log(f"engine {MODEL} B=3 (1.3/2.0/3.1 s): card vs CPU max_abs {dev_err:.3e} "
        f"(tol {ENGINE_TOL:.0e}), output rms {float(np.sqrt(np.mean(y_gpu ** 2))):.4f}, "
        f"CPU run {t_cpu:.1f} s")
    if not dev_err <= ENGINE_TOL:
        raise AssertionError(f"card engine deviates from the CPU engine by {dev_err:.3e}")
    if any(np.any(y_gpu[i, ln:] != 0.0) for i, ln in enumerate(lengths)):
        raise AssertionError("output past an utterance's length is not zeroed")
    per_seg = {"dprnn_intra_block": 2 * cfg.dprnn_blocks,
               "dprnn_inter_block": 2 * cfg.dprnn_blocks, "gru_scan": 5}
    log(f"launches on the main path ({n_seg} segments): {json.dumps(counts)}; "
        f"expected per segment {json.dumps(per_seg)}")
    expect_counts("offline main path", counts, {k: n_seg * v for k, v in per_seg.items()})

    # ---- phase 4: offline throughput, per-stage and stack ----
    with set_env(STACK, True):
        eng_stack = Engine(cfg, params, device="cuda")
    B, secs = 64, 4.0
    big = (0.1 * rng.standard_normal((B, int(secs * sr)))).astype(np.float32)
    xrt = {}
    for name, e, on in (("per-stage", eng, False), ("stack", eng_stack, True)):
        with set_env(STACK, on):
            e.enhance_waveforms(big)                                    # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = e.enhance_waveforms(big)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        if not np.isfinite(out).all():
            raise AssertionError(f"throughput output ({name}) is not finite")
        wall = statistics.median(times)
        segs = segments(e, big.shape[1])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        xrt[name] = B * secs / wall
        log(f"throughput {MODEL} {name} B={B} x {secs} s, f32: xRT {xrt[name]:.1f}, "
            f"median {wall * 1e3:.1f} ms per call (runs {[round(t * 1e3, 1) for t in times]}), "
            f"{wall * 1e3 / segs:.2f} ms per {e.seg_frames}-frame segment ({segs} segments), "
            f"peak memory {peak:.2f} GiB | {smi}")

    # ---- phase 5: streaming, card vs CPU ----
    stream_counts = streaming_phase(cfg, eng, eng_stack, cpu_eng, gk, rng)

    # ---- phase 6: StreamEnhancer and MultiStreamEnhancer ----
    with set_env(STACK, False):
        enhancer_phase(cfg, eng, rng)

    # ---- phase 7: Engine(fuse=False) ----
    unfused_counts = unfused_phase(cfg, params, cpu_params, gk, rng)

    # ---- phase 8: streaming throughput ----
    stream_throughput(cfg, {"per-stage": (eng, False), "stack": (eng_stack, True)},
                      ("per-stage", "stack", "stack", "per-stage"), smi, rng)

    # ---- phase 9: the v2 stage kernels from their wrappers ----
    v2_counts = v2_wrapper_phase(prepare_inference_params(params, cfg), cfg, gk)

    # ---- phase 10: the quality tiers ----
    tier_counts = tier_phase(cfg, params, cpu_params, gk, smi, rng, wavs, lengths)

    # ---- phase 11: relayout_fm ----
    kernel_rows["relayout_fm"] = relayout_phase(gk)

    # ---- phase 12: the fm layout modes of the intra and inter kernels ----
    mode_off_phase(gk)
    kernel_rows.update(fm_modes_phase(prepare_inference_params(params, cfg), cfg, gk))

    # ---- phase 13: the fm chain on the main path, and the A/B ----
    fm_chain_phase(cfg, params, cpu_params, gk, smi, rng)
    fm_ab_phase(cfg, params, smi, rng)
    with set_env(STACK, False), set_env(TM, True), set_env(ENTRY, True):
        e = Engine(cfg, params, device="cuda")
        e.enhance_waveforms(wavs[:, : sr // 2])
        torch.cuda.synchronize()
        gk.reset_launch_counts()
        y_fm = e.enhance_waveforms(np.tile(wavs, (22, 1))[:64], lengths=np.tile(lengths, 22)[:64])
        torch.cuda.synchronize()
        fm_counts = gk.launch_counts()
    n_seg = segments(e, S)
    per_seg = {"dprnn_intra_block": 2 * cfg.dprnn_blocks,
               "dprnn_inter_block": 2 * cfg.dprnn_blocks, "gru_scan": 5, "relayout_fm": 2}
    log(f"fm chain main path, B=64 (the 3 utterances tiled), entry relayout on: launches "
        f"({n_seg} segments) {json.dumps(fm_counts)}, expected per segment "
        f"{json.dumps(per_seg)}; vs the B=3 run max_abs "
        f"{float(np.abs(y_fm[:3] - y_gpu).max()):.3e}")
    expect_counts("fm chain main path", fm_counts, {k: n_seg * v for k, v in per_seg.items()})
    if not float(np.abs(y_fm[:3] - y_gpu).max()) <= ENGINE_TOL:
        raise AssertionError("the fm chain at B=64 deviates from the row-major chain at B=3")

    # ---- phase 14: the step-ablation tools ----
    abl_rows = ablation_phase(smi)

    # ---- phase 15: kernel list ----
    def entry(name, key, source, replaces, launches, rows=kernel_rows):
        r = rows[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    df = cfg.dprnn_df_feat
    csrc = "dpdfnet_tpu_torch/csrc"
    kernels = [
        entry("dprnn_intra_block", ("dprnn_intra_block", df), f"{csrc}/dprnn_intra.cu",
              f"{PALLAS}:598", counts["dprnn_intra_block"]),
        entry("dprnn_inter_block", ("dprnn_inter_block", df), f"{csrc}/dprnn_inter.cu",
              f"{PALLAS}:226", counts["dprnn_inter_block"]),
        entry("gru_scan", ("gru_scan", False), f"{csrc}/gru_scan.cu", f"{PALLAS}:433",
              counts["gru_scan"]),
        entry("gru_bidir", ("gru_bidir", df), f"{csrc}/gru_bidir.cu", f"{PALLAS}:462",
              unfused_counts["gru_bidir"]),
        entry("dprnn_stack", ("dprnn_stack", "stream", df), f"{csrc}/dprnn_stack.cu",
              f"{PALLAS}:1633", stream_counts["stack"]["dprnn_stack"]),
        entry("dprnn_intra_block_v2", ("dprnn_intra_block_v2", df),
              f"{csrc}/dprnn_intra_v2.cu", f"{PALLAS}:1934", v2_counts["dprnn_intra_block_v2"]),
        entry("dprnn_inter_block_v2", ("dprnn_inter_block_v2", df),
              f"{csrc}/dprnn_inter_v2.cu", f"{PALLAS}:2128",
              tier_counts["dprnn_inter_block_v2"]),
        entry("dprnn_intra_block_tm", "dprnn_intra_block_tm", f"{csrc}/dprnn_intra.cu",
              f"{PALLAS}:903", fm_counts["dprnn_intra_block"]),
        entry("relayout_fm", "relayout_fm", f"{csrc}/relayout_fm.cu", f"{PALLAS}:2290",
              fm_counts["relayout_fm"]),
        entry("intra_step_ablation", "intra", f"{csrc}/intra_step_ablation.cu",
              "tools/intra_step_ablation.py:101", abl_rows["intra"]["launches"], abl_rows),
        entry("inter_step_ablation", "inter", f"{csrc}/inter_step_ablation.cu",
              "tools/inter_step_ablation.py:99", abl_rows["inter"]["launches"], abl_rows),
    ]
    errs = {"dprnn_intra_block": [("dprnn_intra_block", f) for f in (cfg.dprnn_erb_feat, df)],
            "dprnn_inter_block": [("dprnn_inter_block", f) for f in (cfg.dprnn_erb_feat, df)],
            "gru_scan": [("gru_scan", r) for r in (False, True)],
            "gru_bidir": [("gru_bidir", df)],
            "dprnn_stack": [k for k in kernel_rows if k[0] == "dprnn_stack"],
            "dprnn_intra_block_v2": [("dprnn_intra_block_v2", f)
                                     for f in (cfg.dprnn_erb_feat, df)],
            "dprnn_inter_block_v2": [("dprnn_inter_block_v2", f)
                                     for f in (cfg.dprnn_erb_feat, df)]}
    for k in kernels:
        if k["name"] in errs:
            k["max_abs_err"] = max(kernel_rows[key]["err"] for key in errs[k["name"]])
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
