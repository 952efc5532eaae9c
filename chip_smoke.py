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
   calls after a warm-up: xRT, ms per 112-frame segment, peak memory and
   the launches per segment; the same with the DPRNN stack kernel
   (``DPDFNET_TPU_STACK=1``, whose launches the kernel list reports);
5. streaming, card vs CPU: ``process_frames`` with 4 streams x 40 hops in
   exact and throughput modes, with the per-stage DPRNN kernels and with
   the stack kernel: deviation from the CPU engine; on the card each
   program is a CUDA graph, so the wrappers count the launches of the eager
   run before each capture and the engine counts the replays of the
   rest; exact mode bit-identical across three chunkings;
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
16. the package surface on ``dpdfnet8_48khz_hr`` at full width and depth,
   the model resolved by name from an npz of phase 3's weights in a
   temporary ``DPDFNET_TPU_MODEL_DIR`` (a download attempt raises):
   ``api.enhance`` on 3 s at 48 kHz equal to ``Engine.enhance_waveforms``
   of the cached engine, and at 16 kHz (resampled); the segment-stepped
   path (``progress_callback``) equal to it, with segments + 1 callbacks
   and 16 intra, 16 inter and 5 gru_scan launches per segment; ``cli
   enhance`` within one 16-bit step of ``enhance_file`` (in this process,
   and ``python -m dpdfnet_tpu_torch`` in a fresh one, with its wall time);
   ``StreamEnhancer`` / ``MultiStreamEnhancer(8)`` built by name
   bit-identical to the ``engine=`` path over 40 hops; ``cli bench``
   offline B=64 x 4 s in ``high`` and ``turbo`` and ``--streaming`` at 64
   exact streams, each JSON line printed after the card's name and power
   limit;
17. checkpoints in, training out, on ``dpdfnet8_48khz_hr`` at full width
   and depth (run after 16): phase 3's weights written as a reference-layout
   ``.pth`` (``tools/synth_checkpoint.py``) in a temporary zoo directory,
   resolved by name and converted on the card by ``zoo.load_model_params``
   (which caches the npz; a second load reads it without converting), every
   leaf bit-equal to phase 3's, and an engine on the converted weights
   bit-identical to phase 3's output on phase 3's input with the same
   launches per segment; then 5 ``train.make_train_step`` steps with
   ``torch.optim.Adam(lr=1e-3)`` on one batch of B=4 x 1.0 s
   (``speechlike_test_signal`` plus seeded noise): every loss finite and
   the last below the first, the ERB filterbanks bit-unchanged, no kernel
   launched inside the steps, ms per step (median of steps 2-5), peak
   memory, the card's name and power limit; an engine on the trained
   weights that launches the kernels again; and one step on the card
   against the same step on the CPU at B=1 x 0.25 s (the loss, and every
   gradient leaf relative to its largest CPU value);
18. the captured streaming programs and export, on ``dpdfnet8_48khz_hr``
   at full width and depth (run after 17): (a) exact streaming through
   the CUDA graph at 64 streams x 200 hops in ``highest`` against an eager
   per-frame loop of the same engine (front / ``forward_spec`` / back
   called here; ``torch.equal`` expected, max-abs reported), bit-identical
   across the chunkings of ``stream_steps``, card vs CPU (streams 0-3, 50
   hops), one eager hop's 16 / 16 / 5 launches before the capture and 199
   replays; ``turbo`` + V2 exact (chunk invariance, card vs CPU rel_rms)
   and ``highest`` throughput mode at 8 hops per call (card vs CPU,
   launches and replays); two ``StreamEnhancer`` s and a
   ``MultiStreamEnhancer(8)`` on one engine, interleaved call by call, and
   two ``StreamEnhancer`` s driven from two threads at once, each equal to
   its own run alone; (b) exact ms per hop at 64 streams, an eager
   per-frame loop against the graph against the stack kernel's graph
   (whose cache key must differ), interleaved block by block, in
   ``highest`` and ``turbo`` + V2, then from the device trace of
   ``runtime/profile.py --stream`` (graph in both tiers and the stack's
   graph) device busy share, device ops per hop, gru_scan's time per
   launch and the port's kernels each replayed hop ran (16 / 16 / 5, the
   stack 2 / 5), with one replay per hop and no wrapper launch; (c) ``export.export_stream`` at B=1: seconds to export,
   MB, seconds to load, the graph's ``dpdfnet::*`` nodes, 16 / 16 / 5
   launches per loaded step, the loaded step against the engine's spec
   program over 100 frames (1e-5), and
   ``tools/consume_exported.py`` in a fresh process on a 3 s wav against
   ``StreamEnhancer`` (2e-4, the 16-bit step; no model module loaded);
   (d) ``export.export_offline`` at B=4 x 2 s (padded to its bucket)
   against ``Engine.enhance_waveforms`` (1e-5); the phase's wall time;
19. multi-device on ``dpdfnet8_48khz_hr`` at full width and depth (run
   after 18): (a) ``Engine(mesh=make_mesh())`` over every visible card,
   offline B=64 x 4 s and exact / throughput streaming at 64 streams x 40
   hops, against the engine without a mesh (``torch.equal`` on one card,
   MESH_TOL on more); (b) the mesh ``[cuda:0, cuda:0]`` (two replicas on
   one card, the split, the pad and the gather with the real kernels):
   offline B=63 (padded to 64) and exact / throughput streaming at 64
   streams in ``highest`` (MESH_TOL) and ``turbo`` + V2 (rel_rms
   TURBO_MESH_REL_RMS), the launches per segment per replica, the graph
   replays per replica, and a stream batch of 63 raising; (c)
   ``make_train_step(mesh=[cuda:0, cuda:0])`` at B=4 x 1.0 s against the
   step without a mesh (TRAIN_LOSS_REL, TRAIN_GRAD_REL), then its ms per
   step and peak memory; (d) what the mesh wrapper costs on one card:
   offline xRT and exact ms per hop of the engine without a mesh, the mesh
   of one card and ``[cuda:0, cuda:0]``, interleaved; (e) the native host
   library built from the port's ``csrc/dpdfnet_host.cpp`` and loaded,
   ``ola_commit`` bit-equal to NumPy, ``resample`` within 1e-3 of
   ``resample_poly``, the PCM16 WAV codec equal to the NumPy codec; (f)
   ``enhance-dir --distributed`` in one process per card (two on one card) through
   ``torch.distributed.run`` against one process: the hosts' shards, the
   files within one 16-bit step; the phase's wall time;
20. (run after 19) the frequency-folded 48 kHz plane
   (``models.fuse.fold_hr_tail``, left out of the default tree that every
   earlier phase runs): the default engine holds no folded weights; a
   folded engine on the card against one on the CPU within ENGINE_TOL;
   folded against the default on the card, offline and exact streaming,
   FOLD_TOL in highest and FOLD_TURBO_REL_RMS in turbo; the A/B, offline
   xRT at B=64 x 4 s and exact ms per hop at 64 streams through the CUDA
   graph, in highest and turbo, interleaved (median [min-max]); one point
   each of the
   ``bench_sweep``, ``stream_sweep`` and ``tier_accuracy`` tools on the
   card; the phase's wall time;
21. (run after 20) the reference-ONNX quality gate through the port's
   exported step, on ``dpdfnet8_48khz_hr`` at full width and depth: (a)
   ``export.export_stream`` of phase 3's weights at B=1 behind a session
   shaped as the reference's ``onnxruntime`` one (``StepSession``: the
   sidecar as its metadata, the spectrum in and out at the reference's
   scale), driven by ``quality.enhance_reference_onnx`` over 2 s of 48 kHz
   ``speechlike_test_signal``: one session call per frame, 16 intra, 16
   inter and 5 gru_scan launches per call, all but the last ``win_len``
   samples within rel_rms ONNX_REL_RMS of phase 3's engine (the last
   ``win_len``, which the reference pipeline zero-fills, zeros), max-abs,
   SI-SNR against the engine and ms per session call; (b)
   ``quality.validate_vs_onnx`` on a 2-clip 48 kHz corpus (1.5 s each,
   clean = noisy), the model resolved by name from an npz of phase 3's
   weights in a temporary ``DPDFNET_TPU_MODEL_DIR``, the session seeded
   under the artifact's path: finite STOI and SI-SNR columns for both
   arms, then rc 1 and the "PESQ unavailable" line where ``pesq`` does not
   import, or finite PESQ columns and the verdict where it does; the
   gate's lines, and the phase's wall time;
15. (run after 21) one JSON line listing the kernels, then the final JSON
   status line.

Needs one CUDA device; exits non-zero without one, and without the
``dpdfnet_tpu_torch`` package beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import threading
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
# One train step on the card against the same step on the CPU (phase 17b,
# B=1 x 0.25 s, 26 frames of recurrences through forward and backward, the
# plain path in float32 with TF32 off on both): the loss within 1e-5
# relative, and every gradient leaf's max-abs deviation within 1e-4 of that
# leaf's largest CPU magnitude (measured 8.2e-8 and 8.9e-7 on the card).
# The CPU step itself agrees with the JAX package's value_and_grad to 2e-7
# on the loss and 2e-6 per leaf on this model at 7 frames
# (tests/test_torch_train.py); a dropped or wrongly routed term moves a
# leaf by O(1) of its magnitude.
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-4
# The engine on a mesh against the engine without one (phase 19), highest:
# each shard runs the single-device path on B / n rows, so only the
# cuBLAS / cuDNN algorithm a smaller batch gets can differ (the hand-written
# kernels are row-wise); max-abs 1e-5 on outputs of rms about 0.1, twenty
# times below ENGINE_TOL.  A shard routed to the wrong rows or a lost pad
# row moves the output by its own magnitude.  turbo + V2: bf16 planes
# round at other points when the GEMM shapes change, so rel_rms 3e-3, the
# bound between the port's and the JAX package's turbo tiers.
MESH_TOL = 1e-5
TURBO_MESH_REL_RMS = 3e-3
# The folded 48 kHz plane against the unfolded one on the card (phase 20):
# the same linear maps with the taps of three convs summed in another
# order, so highest differs by float32 rounding (about 7e-9 on the CPU)
# and turbo by bf16 roundings that flip (rel_rms about 3e-6 on the CPU);
# a tap at the wrong fold position moves the mask by its own size.
FOLD_TOL = 1e-5
FOLD_TURBO_REL_RMS = 1e-3

# The reference pipeline (quality.enhance_reference_onnx: NumPy STFT, one
# exported-step call per frame, float64 overlap-add) against the offline
# engine on the card, both in ``high``: the same network, the streaming
# step's T == 1 kernels and per-frame convs against the offline plane's, so
# float32 rounding in another order (on the CPU the two read 1.3e-9 max-abs
# on an output peak of 1.2e-4).  A lost state carry, a wrong wnorm or a
# shifted frame moves the output by its own size, rel_rms near 1.
ONNX_REL_RMS = 1e-4

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


def graph_counted(e, gk, fn):
    """Run ``fn()``, which streams through engine ``e``; returns its result,
    the launches the wrappers made (they count only launches they make
    themselves: the eager warm-up run of each graph the run captured), the
    graphs captured and the graph replays in the run."""
    torch.cuda.synchronize()
    gk.reset_launch_counts()
    graphs, replays = len(e._graphs), e.graph_replays
    out = fn()
    torch.cuda.synchronize()
    return out, gk.launch_counts(), len(e._graphs) - graphs, e.graph_replays - replays


def expect_graph_counts(what: str, counted, per_call: dict, calls: int) -> None:
    """``graph_counted``'s launches and replays for ``calls`` forward_spec
    calls of ``per_call`` launches each: each captured graph's warm-up run
    launched once, every other call was one replay."""
    _, counts, captured, replays = counted
    expect_counts(what, counts, {k: v * captured for k, v in per_call.items() if captured})
    if replays != calls - captured:
        raise AssertionError(f"{what}: {replays} graph replays and {captured} captures for "
                             f"{calls} calls")


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


def stream_steps(T):
    """Throughput mode's forward_spec calls for T frames: the largest
    power-of-two bucket (up to 128) that fits, repeatedly."""
    steps, pos = [], 0
    while pos < T:
        step = max(b for b in (1, 2, 4, 8, 16, 32, 64, 128) if b <= T - pos)
        steps.append(step)
        pos += step
    return steps


def run_chunked(eng, frames, cuts, mode="exact"):
    st, ys, pos = eng.init_stream_state(batch=frames.shape[0]), [], 0
    for n in cuts:
        y, st = eng.process_frames(frames[:, pos:pos + n], st, mode=mode)
        ys.append(y)
        pos += n
    return np.concatenate(ys, axis=1)


def streaming_phase(cfg, eng, eng_stack, cpu_eng, gk, rng):
    """process_frames card vs CPU, launches and graph replays, chunk
    invariance."""
    B, T = 4, 40
    frames = stream_frames(rng, B, T, cfg.win_len)
    for mode in ("exact", "throughput"):
        calls = T if mode == "exact" else len(stream_steps(T))
        t0 = time.perf_counter()
        ref, _ = cpu_eng.process_frames(frames, cpu_eng.init_stream_state(batch=B), mode=mode)
        t_cpu = time.perf_counter() - t0
        for name, e, on in (("per-stage", eng, False), ("stack", eng_stack, True)):
            with set_env(STACK, on):
                counted = graph_counted(e, gk, lambda: e.process_frames(
                    frames, e.init_stream_state(batch=B), mode=mode))
            (y, _), counts, captured, replays = counted
            per_call = ({"dprnn_stack": 2} if on else
                        {"dprnn_intra_block": 2 * cfg.dprnn_blocks,
                         "dprnn_inter_block": 2 * cfg.dprnn_blocks})
            per_call["gru_scan"] = 5
            expect_graph_counts(f"streaming {mode} {name}", counted, per_call, calls)
            if not np.isfinite(y).all():
                raise AssertionError(f"streaming {mode} {name}: output not finite")
            err = float(np.abs(y - ref).max())
            log(f"streaming {mode} {name} B={B} x {T} hops: card vs CPU max_abs {err:.3e} "
                f"(tol {ENGINE_TOL:.0e}); {calls} forward_spec calls: {captured} graph(s) "
                f"captured, each after an eager run that launched {json.dumps(per_call)} "
                f"({json.dumps(counts)} counted), {replays} replays (CPU run {t_cpu:.1f} s)")
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
            counted = graph_counted(e, gk, lambda: run_chunked(e, frames, [T]))
            y, counts, captured, replays = counted
            expect_graph_counts(f"exact streaming {name}", counted,
                                per_seg_v2 if v2 else per_seg, T)
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
            f"all-at-once, 1+1+..., 3+5+...; {captured} graph captured after an eager hop "
            f"that launched {json.dumps({k: v for k, v in counts.items() if v})}, {replays} "
            f"replays; state leaves "
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
        counted = graph_counted(eng, gk, lambda: run_chunked(eng, frames, [12]))
        y, counts, captured, replays = counted
        expect_graph_counts("fm chain exact streaming", counted,
                            {"dprnn_intra_block": 2 * K, "dprnn_inter_block": 2 * K,
                             "gru_scan": 5}, 12)
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
        f"all-at-once, 1+1+..., 3+5+4; {captured} graph captured after an eager hop that "
        f"launched {json.dumps({k: v for k, v in counts.items() if v})}, {replays} replays; "
        f"vs the row-major chain "
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


@contextlib.contextmanager
def model_dir(params):
    """A temporary ``DPDFNET_TPU_MODEL_DIR`` (and cache directory) holding
    ``params`` as ``MODEL``'s npz, so the zoo resolves ``MODEL`` by name;
    any download attempt raises, and the API's engine cache is cleared on
    entry and exit.  Yields the directory."""
    import tempfile
    from pathlib import Path

    from dpdfnet_tpu_torch import api, zoo
    from dpdfnet_tpu_torch.utils.serialization import save_params

    def no_download(url, destination):
        raise RuntimeError(f"chip_smoke: a download was attempted ({url})")

    saved_env = {k: os.environ.get(k) for k in ("DPDFNET_TPU_MODEL_DIR",
                                                "DPDFNET_TPU_CACHE_DIR", "NO_BANNER")}
    saved_download = zoo._download_one
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        save_params(d / f"{MODEL}.params.npz", params)
        os.environ.update(DPDFNET_TPU_MODEL_DIR=str(d), DPDFNET_TPU_CACHE_DIR=str(d / "cache"),
                          NO_BANNER="1")
        zoo._download_one = no_download
        api.clear_engine_cache()
        try:
            yield d
        finally:
            zoo._download_one = saved_download
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            api.clear_engine_cache()


def package_phase(cfg, params, eng, gk, smi, rng):
    """Phase 16: the user-facing package on the card.  The model is resolved
    by name from an npz of ``params`` in a temporary
    ``DPDFNET_TPU_MODEL_DIR``; any download attempt raises."""
    import contextlib as cl
    import io

    from dpdfnet_tpu_torch import MultiStreamEnhancer, StreamEnhancer, api, cli
    from dpdfnet_tpu_torch.audio_io import read_wav, write_wav

    t_phase = time.perf_counter()
    sr, hop = cfg.sample_rate, cfg.hop
    with model_dir(params) as d:
        # ---- 1. enhance by name against the cached engine; the resample path ----
        t = np.arange(3 * sr) / sr
        x = (0.2 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.size)
             ).astype(np.float32)
        t0 = time.perf_counter()
        y = api.enhance(x, sr, model=MODEL)
        t_first = time.perf_counter() - t0
        cached = api._get_engine(MODEL)
        ref = cached.enhance_waveforms(x)
        err = float(np.abs(y - ref).max())
        log(f"api.enhance {MODEL} 3 s at {sr} Hz (first call {t_first:.2f} s, engine build "
            f"included): vs Engine.enhance_waveforms of the cached engine torch.equal "
            f"{torch.equal(torch.from_numpy(y), torch.from_numpy(ref))}, max_abs {err:.3e}")
        if not np.isfinite(y).all() or not np.array_equal(y, ref):
            raise AssertionError(f"api.enhance differs from the engine path by {err:.3e}")
        x16 = x[::3].copy()
        y16 = api.enhance(x16, 16000, model=MODEL)
        log(f"api.enhance 3 s at 16000 Hz (resampled to {sr} and back): {y16.shape[0]} "
            f"samples out for {x16.shape[0]} in, finite {bool(np.isfinite(y16).all())}")
        if y16.shape != x16.shape or not np.isfinite(y16).all():
            raise AssertionError("api.enhance at 16 kHz: wrong length or not finite")

        # ---- 2. the segment-stepped path and its launches ----
        events = []
        torch.cuda.synchronize()
        gk.reset_launch_counts()
        y_step = api.enhance(x, sr, model=MODEL,
                             progress_callback=lambda done, total: events.append((done, total)))
        torch.cuda.synchronize()
        counts = gk.launch_counts()
        n_seg = segments(cached, x.shape[0])
        per_seg = {"dprnn_intra_block": 2 * cfg.dprnn_blocks,
                   "dprnn_inter_block": 2 * cfg.dprnn_blocks, "gru_scan": 5}
        log(f"api.enhance with progress_callback: {len(events)} callbacks {events}, "
            f"torch.equal to the unstepped call {np.array_equal(y_step, y)}; launches "
            f"({n_seg} segments) {json.dumps(counts)}, expected per segment "
            f"{json.dumps(per_seg)}")
        if not np.array_equal(y_step, y) or len(events) != n_seg + 1:
            raise AssertionError("the stepped path differs from the unstepped one, or its "
                                 f"callbacks ({len(events)}) are not segments + 1")
        expect_counts("stepped offline path", counts, {k: n_seg * v for k, v in per_seg.items()})

        # ---- 3. the CLI against enhance_file ----
        src, out_cli, out_api = d / "in.wav", d / "cli.wav", d / "api.wav"
        write_wav(src, x, sr)
        t0 = time.perf_counter()
        with cl.redirect_stdout(io.StringIO()):
            rc = cli.main(["enhance", str(src), str(out_cli), "--model", MODEL])
        t_cli = time.perf_counter() - t0
        api.enhance_file(src, out_api, model=MODEL)
        a, b = read_wav(out_cli)[0], read_wav(out_api)[0]
        steps = float(np.abs(a - b).max()) * 32768.0
        log(f"cli enhance {MODEL} (3 s wav): rc {rc}, {t_cli:.3f} s wall in-process (engine "
            f"cached, kernels built); vs enhance_file max {steps:.0f} 16-bit steps")
        if rc != 0 or a.shape != x.shape or not steps <= 1.0:
            raise AssertionError(f"cli enhance: rc {rc}, {steps} steps from enhance_file")
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "dpdfnet_tpu_torch", "enhance", str(src),
                              str(d / "proc.wav"), "--model", MODEL], env=env,
                             capture_output=True, text=True, timeout=300)
        t_proc = time.perf_counter() - t0
        steps_proc = float(np.abs(read_wav(d / "proc.wav")[0] - b).max()) * 32768.0 \
            if res.returncode == 0 else float("nan")
        log(f"python -m dpdfnet_tpu_torch enhance {MODEL} (3 s wav) in a fresh process: rc "
            f"{res.returncode}, {t_proc:.2f} s wall (interpreter, torch and CUDA start, npz "
            f"load, engine build, kernel libraries loaded from this run's build, first "
            f"call); vs enhance_file max {steps_proc:.0f} 16-bit steps | {smi}")
        if res.returncode != 0 or not steps_proc <= 1.0:
            raise AssertionError(f"python -m dpdfnet_tpu_torch enhance: rc {res.returncode}, "
                                 f"{steps_proc} steps; stderr {res.stderr[-2000:]}")

        # ---- 4. streams built by name against the engine= path (phase 6) ----
        n = 40 * hop + cfg.win_len
        xs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for _ in range(8)]
        cuts = [0, 333, 2 * hop + 7, 17 * hop, n]
        by_name, by_engine = StreamEnhancer(model=MODEL), StreamEnhancer(engine=eng)
        if by_name._engine is not cached:
            raise AssertionError("StreamEnhancer(model=...) did not take the cached engine")
        ya, yb = [], []
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            ya.append(by_name.process(xs[0][lo:hi]))
            yb.append(by_engine.process(xs[0][lo:hi]))
        ya, yb = np.concatenate(ya + [by_name.flush()]), np.concatenate(yb + [by_engine.flush()])
        pool_a = MultiStreamEnhancer(8, model=MODEL)
        pool_b = MultiStreamEnhancer(8, engine=eng)
        sids = [pool_a.open() for _ in range(8)]
        if sids != [pool_b.open() for _ in range(8)]:
            raise AssertionError("the two pools opened different slots")
        pa, pb = {s: [] for s in sids}, {s: [] for s in sids}
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            feed = {s: xs[s][lo:hi] for s in sids}
            for s, o in pool_a.process_many(feed).items():
                pa[s].append(o)
            for s, o in pool_b.process_many(feed).items():
                pb[s].append(o)
        pool_same = all(np.array_equal(np.concatenate(pa[s]), np.concatenate(pb[s]))
                        for s in sids)
        log(f"StreamEnhancer(model=...) 40 hops vs StreamEnhancer(engine=...): bit-identical "
            f"{np.array_equal(ya, yb)} ({ya.size} samples); MultiStreamEnhancer(8, model=...) "
            f"40 hops per slot vs engine=: bit-identical {pool_same}")
        if not np.array_equal(ya, yb) or not pool_same:
            raise AssertionError("a stream built by name differs from the engine= path")

        # ---- 5. the bench runner through the CLI ----
        log(f"bench runner lines | {smi}")
        for argv in (["--batch", "64", "--seconds", "4", "--precision", "high"],
                     ["--batch", "64", "--seconds", "4", "--precision", "turbo"],
                     ["--streaming", "--streams", "64", "--mode", "exact",
                      "--precision", "high"]):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with cl.redirect_stdout(buf):
                rc = cli.main(["bench", "--model", MODEL, "--random-weights", *argv])
            line = buf.getvalue().strip().splitlines()[-1] if buf.getvalue().strip() else ""
            if rc != 0 or not line.startswith("{"):
                raise AssertionError(f"cli bench {argv}: rc {rc}, output {buf.getvalue()!r}")
            print(line, flush=True)
            log(f"(cli bench {' '.join(argv)}: {time.perf_counter() - t0:.1f} s wall)")
        log(f"phase 16: {time.perf_counter() - t_phase:.1f} s wall")


def convert_phase(cfg, params, gk, wavs, lengths, y_ref):
    """Phase 17a: phase 3's weights as a reference-layout ``.pth``
    (``tools.synth_checkpoint``, exact BatchNorm statistics) in a temporary
    zoo directory, resolved by name and converted on the card; the second
    load reads the npz the first wrote.  An engine on the converted weights
    runs phase 3's input through the kernels."""
    import tempfile
    from pathlib import Path

    from dpdfnet_tpu_torch import Engine, zoo
    from dpdfnet_tpu_torch.models import convert
    from dpdfnet_tpu_torch.tools.synth_checkpoint import save_checkpoint
    from dpdfnet_tpu_torch.utils.tree import tree_leaves

    def no_download(url, destination):
        raise RuntimeError(f"chip_smoke: a download was attempted ({url})")

    def no_convert(*args, **kwargs):
        raise AssertionError("converted again although the npz is cached")

    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    save_checkpoint(d / f"{MODEL}.pth", params, cfg)
    pth_mib = (d / f"{MODEL}.pth").stat().st_size / 2 ** 20
    saved_env = {k: os.environ.get(k) for k in ("DPDFNET_TPU_MODEL_DIR",
                                                "DPDFNET_TPU_CACHE_DIR")}
    os.environ.update(DPDFNET_TPU_MODEL_DIR=str(d), DPDFNET_TPU_CACHE_DIR=str(d / "cache"))
    saved_download, zoo._download_one = zoo._download_one, no_download
    saved_convert = convert.load_params
    try:
        resolved = zoo.resolve_model(model=MODEL, auto_download=False)
        t0 = time.perf_counter()
        conv = zoo.load_model_params(resolved, device="cuda")
        torch.cuda.synchronize()
        t_conv = time.perf_counter() - t0
        if not resolved.params_path.is_file():
            raise AssertionError(f"no npz cached at {resolved.params_path}")
        convert.load_params = no_convert
        t0 = time.perf_counter()
        cached = zoo.load_model_params(resolved, device="cuda")
        torch.cuda.synchronize()
        t_npz = time.perf_counter() - t0
    finally:
        convert.load_params = saved_convert
        zoo._download_one = saved_download
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmp.cleanup()
    src, got, again = dict(tree_leaves(params)), dict(tree_leaves(conv)), \
        dict(tree_leaves(cached))
    if not src.keys() == got.keys() == again.keys():
        raise AssertionError("the converted tree's leaves differ from the source's")
    exact = all(got[k].is_cuda and torch.equal(got[k], src[k]) and torch.equal(again[k], src[k])
                for k in src)
    log(f"convert {MODEL}: .pth ({pth_mib:.1f} MiB, {len(src)} leaves) converted on the card in {t_conv:.2f} s (npz written), "
        f"the npz read back in {t_npz:.2f} s without converting; every leaf bit-equal to "
        f"phase 3's weights {exact}")
    if not exact:
        raise AssertionError("the converted weights differ from the checkpoint's source")
    with set_env(STACK, False):
        eng = Engine(cfg, conv, device="cuda")
        eng.enhance_waveforms(wavs[:, : cfg.sample_rate // 2])         # warm-up
        torch.cuda.synchronize()
        gk.reset_launch_counts()
        y = eng.enhance_waveforms(wavs, lengths=lengths)
        torch.cuda.synchronize()
        counts = gk.launch_counts()
    n_seg = segments(eng, wavs.shape[1])
    per_seg = {"dprnn_intra_block": 2 * cfg.dprnn_blocks,
               "dprnn_inter_block": 2 * cfg.dprnn_blocks, "gru_scan": 5}
    same = bool(np.array_equal(y, y_ref))
    log(f"engine on the converted weights, phase 3's input: torch.equal to phase 3's output "
        f"{same} (max_abs {float(np.abs(y - y_ref).max()):.3e}); launches ({n_seg} segments) "
        f"{json.dumps(counts)}")
    if not same:
        raise AssertionError("the engine on the converted weights differs from phase 3's")
    expect_counts("converted-weights main path", counts,
                  {k: n_seg * v for k, v in per_seg.items()})


def train_phase(cfg, gk, smi):
    """Phase 17b: ``train.make_train_step`` with ``torch.optim.Adam`` on the
    full-width, full-depth model, kernels off inside the steps; then one
    step on the card against the same step on the CPU."""
    from dpdfnet_tpu_torch import Engine
    from dpdfnet_tpu_torch.models.params import contract_params, init_params
    from dpdfnet_tpu_torch.quality import speechlike_test_signal
    from dpdfnet_tpu_torch.train import make_train_step, trainable_parameters
    from dpdfnet_tpu_torch.utils.tree import tree_leaves, tree_map

    sr = cfg.sample_rate
    rng = np.random.default_rng(17)
    clean = speechlike_test_signal(1.0, sr, seed=0, batch=4)
    noisy = clean + (0.02 * rng.standard_normal(clean.shape)).astype(np.float32)
    clean_t, noisy_t = torch.from_numpy(clean).cuda(), torch.from_numpy(noisy).cuda()
    params = contract_params(init_params(cfg, seed=0, device="cuda"))
    fbs = {k: params[k].clone() for k in ("erb_fb", "erb_inv_fb")}
    step = make_train_step(cfg, torch.optim.Adam(trainable_parameters(params), lr=1e-3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launch_counts()
    losses, times = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        loss, aux = step(params, noisy_t, clean_t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = gk.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fb_same = all(torch.equal(params[k], v) for k, v in fbs.items())
    ms = statistics.median(times[1:]) * 1e3
    log(f"train {MODEL} B=4 x 1.0 s, Adam(lr=1e-3), 5 steps on one batch: losses "
        f"{[round(v, 6) for v in losses]}, spec {float(aux['spec']):.6f} lsnr "
        f"{float(aux['lsnr']):.3f} (last step); launches inside the steps {json.dumps(counts)}; "
        f"erb_fb / erb_inv_fb bit-unchanged {fb_same}")
    log(f"train step {MODEL} B=4 x 1.0 s: {ms:.1f} ms per step (median of steps 2-5; "
        f"steps {[round(t * 1e3, 1) for t in times]} ms), peak memory {peak:.2f} GiB | {smi}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite or not falling: {losses}")
    if not fb_same:
        raise AssertionError("a train step changed the ERB filterbanks")
    expect_counts("train steps", counts, {})

    # the kernels are back outside the step
    trained = tree_map(lambda _, x: x.detach(), params)
    with set_env(STACK, False):
        eng = Engine(cfg, trained, device="cuda")
        gk.reset_launch_counts()
        y = eng.enhance_waveforms(noisy[:1])
        torch.cuda.synchronize()
        counts = gk.launch_counts()
    log(f"engine on the trained weights: finite {bool(np.isfinite(y).all())}, launches "
        f"{json.dumps(counts)}")
    if not np.isfinite(y).all() or not all(counts[k] > 0 for k in (
            "dprnn_intra_block", "dprnn_inter_block", "gru_scan")):
        raise AssertionError("after the train steps an engine call did not run the kernels")

    # one step on the card against the same step on the CPU
    x = np.stack([noisy[0, : sr // 4], clean[0, : sr // 4]])
    steps = {}
    for dev in ("cuda", "cpu"):
        p = contract_params(init_params(cfg, seed=0, device=dev))
        leaves = trainable_parameters(p)
        st = make_train_step(cfg, torch.optim.SGD(leaves, lr=0.0))
        xt = torch.from_numpy(x).to(dev)
        loss, _ = st(p, xt[:1], xt[1:])
        steps[dev] = (float(loss), {k: (torch.zeros_like(v) if v.grad is None else v.grad).cpu()
                                    for k, v in tree_leaves(p) if v.requires_grad})
    (l_gpu, g_gpu), (l_cpu, g_cpu) = steps["cuda"], steps["cpu"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst = sorted(((float((g_gpu[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30), k)
                    for k, g in g_cpu.items()), reverse=True)
    log(f"train step card vs CPU, B=1 x 0.25 s: loss {l_gpu:.8f} vs {l_cpu:.8f} (rel "
        f"{loss_rel:.2e}, tol {TRAIN_LOSS_REL:.0e}); {len(g_cpu)} gradient leaves, worst "
        f"max-abs / leaf max {[(k, f'{e:.2e}') for e, k in worst[:3]]} (tol "
        f"{TRAIN_GRAD_REL:.0e})")
    if not loss_rel <= TRAIN_LOSS_REL or not worst[0][0] <= TRAIN_GRAD_REL:
        raise AssertionError("the train step on the card deviates from the CPU step")


def _hops(e, frames, per_call=1, mode="exact", st=None):
    """``frames`` through ``e.process_frames``, ``per_call`` hops per call;
    returns the output frames and the last state."""
    st = e.init_stream_state(batch=frames.shape[0]) if st is None else st
    ys = []
    for i in range(0, frames.shape[1], per_call):
        y, st = e.process_frames(frames[:, i:i + per_call], st, mode=mode)
        ys.append(y)
    return np.concatenate(ys, axis=1), st


def _eager_hops(e, frames, st=None):
    """The exact hop without a graph, as ``process_frames`` makes it once per
    hop (frames up, front, ``forward_spec``, back, output down), called here
    on the engine's weights and math mode; returns the output frames and
    the last state."""
    from dpdfnet_tpu_torch.models.dpdfnet import forward_spec
    from dpdfnet_tpu_torch.runtime.engine import _math_mode

    front, back = e._stream_ends()
    st = e.init_stream_state(batch=frames.shape[0]) if st is None else st
    ys = []
    with _math_mode(e.precision):
        for t in range(frames.shape[1]):
            x = torch.from_numpy(np.ascontiguousarray(frames[:, t:t + 1])).cuda()
            out, st, _ = forward_spec(e.params, e.cfg, front(x), st, precision=e.precision)
            ys.append(back(out).cpu().numpy())
    return np.concatenate(ys, axis=1), st


def graph_phase(cfg, params, cpu_eng, cpu_params, gk, rng):
    """Phase 18a: exact streaming through the captured graph at 64 streams x
    200 hops on the flagship, against the eager per-frame loop, across
    chunkings, against the CPU, with the wrappers' launches and the graph
    replays counted; turbo + V2 exact and highest throughput mode;
    enhancers sharing one engine, interleaved and from two threads."""
    from dpdfnet_tpu_torch import Engine, MultiStreamEnhancer, StreamEnhancer
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality

    B, T = 64, 200
    frames = stream_frames(rng, B, T, cfg.win_len)
    per_hop = {"dprnn_intra_block": 2 * cfg.dprnn_blocks,
               "dprnn_inter_block": 2 * cfg.dprnn_blocks, "gru_scan": 5}
    with set_env(STACK, False):
        e = Engine(cfg, params, precision="highest", device="cuda")
        counted = graph_counted(e, gk, lambda: _hops(e, frames))
        (y, _), counts, captured, replays = counted
        expect_graph_counts("graph exact 64 x 200", counted, per_hop, T)
        ref, _ = _eager_hops(e, frames)
        same = bool(np.array_equal(y, ref))
        log(f"graph exact {MODEL} highest {B} streams x {T} hops, one call per hop: vs the "
            f"eager per-frame loop torch.equal {same}, max_abs {float(np.abs(y - ref).max()):.3e}; "
            f"{captured} graph captured after an eager hop that launched {json.dumps(counts)}, "
            f"{replays} replays (the kernels a replay runs: 18b's traces)")
        if not np.isfinite(y).all() or not float(np.abs(y - ref).max()) <= KERNEL_TOL:
            raise AssertionError("graph exact streaming deviates from the eager loop")
        for cuts in ([T], stream_steps(T), [3, 5] * (T // 8)):
            other = run_chunked(e, frames, cuts)
            if not np.array_equal(other, y):
                raise AssertionError(f"graph exact streaming: chunking {cuts[:4]}... differs "
                                     f"by {float(np.abs(other - y).max()):.3e}")
        log("graph exact: bit-identical for chunkings 1+1+..., all-at-once, "
            f"{'+'.join(map(str, stream_steps(T)))}, 3+5+...")
        n_cpu = 50
        t0 = time.perf_counter()
        y_cpu, _ = cpu_eng.process_frames(frames[:4, :n_cpu], cpu_eng.init_stream_state(batch=4))
        err = float(np.abs(y[:4, :n_cpu] - y_cpu).max())
        log(f"graph exact card vs CPU (streams 0-3 of the 64, {n_cpu} hops): max_abs {err:.3e} "
            f"(tol {ENGINE_TOL:.0e}; CPU {time.perf_counter() - t0:.1f} s)")
        if not err <= ENGINE_TOL:
            raise AssertionError(f"graph exact streaming deviates from the CPU by {err:.3e}")

        # throughput mode, highest, 8 hops per call
        counted = graph_counted(e, gk, lambda: _hops(e, frames, per_call=8, mode="throughput"))
        (y_tp, _), tp_counts, tp_captured, tp_replays = counted
        expect_graph_counts("graph throughput 64 x 200", counted, per_hop, T // 8)
        y_tp_cpu, _ = cpu_eng.process_frames(frames[:4, :48], cpu_eng.init_stream_state(batch=4),
                                             mode="throughput")
        # the CPU engine splits 48 frames as 32 + 16, the card 6 x 8: chunking moves
        # throughput mode by about 1e-5, well inside the engine bound
        err_tp = float(np.abs(y_tp[:4, :48] - y_tp_cpu).max())
        err_ex = float(np.abs(y_tp - y).max())
        log(f"graph throughput highest {B} streams x {T} hops, 8 per call: card vs CPU (streams "
            f"0-3, 48 hops) max_abs {err_tp:.3e} (tol {ENGINE_TOL:.0e}), vs exact {err_ex:.3e}; "
            f"{tp_captured} graph captured after an eager call that launched "
            f"{json.dumps(tp_counts)}, {tp_replays} replays")
        if not (np.isfinite(y_tp).all() and err_tp <= ENGINE_TOL and err_ex <= ENGINE_TOL):
            raise AssertionError("graph throughput mode deviates from the CPU or from exact")

        # enhancers sharing the engine, interleaved call by call
        sr, hop = cfg.sample_rate, cfg.hop
        xs = [(0.1 * rng.standard_normal(sr)).astype(np.float32) for _ in range(10)]
        chunk = 3 * hop + 7

        def pool_run(pool, sids, i):
            return pool.process_many({s: xs[2 + j][i:i + chunk] for j, s in enumerate(sids)})

        def alone(x):
            se = StreamEnhancer(engine=e)
            return np.concatenate([se.process(x[i:i + chunk]) for i in range(0, sr, chunk)])

        def collect(outs, got):
            for s, v in got.items():
                outs.setdefault(s, []).append(v)

        pool_alone = MultiStreamEnhancer(capacity=8, engine=e)
        sids_alone = [pool_alone.open() for _ in range(8)]
        ref_pool = {}
        for i in range(0, sr, chunk):
            collect(ref_pool, pool_run(pool_alone, sids_alone, i))
        ref_a, ref_b = alone(xs[0]), alone(xs[1])
        a, b = StreamEnhancer(engine=e), StreamEnhancer(engine=e)
        pool = MultiStreamEnhancer(capacity=8, engine=e)
        sids = [pool.open() for _ in range(8)]
        got_a, got_b, got_pool = [], [], {}
        for i in range(0, sr, chunk):
            got_a.append(a.process(xs[0][i:i + chunk]))
            collect(got_pool, pool_run(pool, sids, i))
            got_b.append(b.process(xs[1][i:i + chunk]))
        ok = (np.array_equal(np.concatenate(got_a), ref_a)
              and np.array_equal(np.concatenate(got_b), ref_b)
              and all(np.array_equal(np.concatenate(got_pool[s]), np.concatenate(ref_pool[r]))
                      for s, r in zip(sids, sids_alone)))
        log(f"two StreamEnhancers and a MultiStreamEnhancer(8) on one engine, interleaved call "
            f"by call ({chunk} samples per call, 1 s each): each equal to its own run alone {ok}")
        if not ok:
            raise AssertionError("streams sharing one engine are not independent")
        got_t, errors = {}, []

        def worker(k):
            try:
                got_t[k] = alone(xs[k])
            except Exception as exc:                       # raised below
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        ok = np.array_equal(got_t[0], ref_a) and np.array_equal(got_t[1], ref_b)
        log(f"two StreamEnhancers on one engine driven from two threads at once: each equal "
            f"to its own run alone {ok}")
        if not ok:
            raise AssertionError("streams sharing one engine across threads are not independent")

    # turbo + V2 exact: chunk invariance at 64 streams, card vs CPU
    with set_env(STACK, False), set_env(V2, True):
        et = engine_from_quality(cfg, params, "turbo", device="cuda")
        counted = graph_counted(et, gk, lambda: _hops(et, frames))
        (yt, _), counts_t, _, replays_t = counted
        per_hop_t = {"dprnn_intra_block": per_hop["dprnn_intra_block"],
                     "dprnn_inter_block_v2": per_hop["dprnn_inter_block"], "gru_scan": 5}
        expect_graph_counts("graph exact turbo+V2", counted, per_hop_t, T)
        for cuts in ([T], stream_steps(T)):
            if not np.array_equal(run_chunked(et, frames, cuts), yt):
                raise AssertionError(f"graph exact turbo+V2: chunking {cuts[:4]} differs")
        cpu_t = engine_from_quality(cfg, cpu_params, "turbo", device="cpu")
        yt_cpu, _ = cpu_t.process_frames(frames[:2, :20], cpu_t.init_stream_state(batch=2))
        rr = rel_rms(yt[:2, :20], yt_cpu)
    log(f"graph exact turbo+V2 {B} streams x {T} hops: bit-identical across chunkings 1+1+..., "
        f"all-at-once, {'+'.join(map(str, stream_steps(T)))}; card vs CPU (streams 0-1, 20 "
        f"hops) rel_rms {rr:.3e} (tol {TURBO_STREAM_REL_RMS:g}); the eager hop before the "
        f"capture launched {json.dumps(counts_t)}, {replays_t} replays")
    if not (np.isfinite(yt).all() and rr <= TURBO_STREAM_REL_RMS):
        raise AssertionError(f"graph exact turbo+V2 deviates from the CPU: rel_rms {rr:.3e}")


def graph_ab_phase(cfg, params, smi, rng, hops=200, block=20):
    """Phase 18b: exact ms per hop at 64 streams, the eager per-frame loop
    (``_eager_hops``) against the graph and the stack kernel's graph,
    interleaved block by block in one process, in highest and turbo + V2;
    then device busy share, device ops and the port's kernels per replayed
    hop from the trace of ``runtime/profile.py --stream``."""
    from dpdfnet_tpu_torch import Engine
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality

    B = 64
    frames = stream_frames(rng, B, hops + 8, cfg.win_len)
    arms = {}
    for tier, v2 in (("highest", False), ("turbo+V2", True)):
        for stack in (False, True):
            with set_env(STACK, stack), set_env(V2, v2):
                e = (Engine(cfg, params, precision="highest", device="cuda") if not v2 else
                     engine_from_quality(cfg, params, "turbo", device="cuda"))
            names = [f"{tier} stack graph"] if stack else [f"{tier} eager", f"{tier} graph"]
            for name in names:
                arms[name] = {"e": e, "stack": stack, "v2": v2,
                              "run": _eager_hops if "eager" in name else
                              lambda e, f, st: _hops(e, f, st=st)}
    for a in arms.values():
        with set_env(STACK, a["stack"]), set_env(V2, a["v2"]):
            _, a["st"] = a["run"](a["e"], frames[:, :8], None)        # warm-up, capture
        a["ms"] = []
    names = list(arms)
    for k, start in enumerate(range(8, 8 + hops, block)):
        for name in (names if k % 2 == 0 else names[::-1]):
            a = arms[name]
            with set_env(STACK, a["stack"]), set_env(V2, a["v2"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, a["st"] = a["run"](a["e"], frames[:, start:start + block], a["st"])
                torch.cuda.synchronize()
                a["ms"].append((time.perf_counter() - t0) * 1e3 / block)
    res = {}
    for name, a in arms.items():
        res[name] = (statistics.median(a["ms"]), min(a["ms"]), max(a["ms"]))
        log(f"ms per hop {name}: {spread(res[name])} ({B} streams, {hops} hops in blocks of "
            f"{block}, interleaved) | {smi}")
    for tier in ("highest", "turbo+V2"):
        keys = {k for a in (arms[f"{tier} graph"], arms[f"{tier} stack graph"])
                for k in a["e"]._graphs}
        stack_flags = {k[2] for k in keys if len(k) > 2 and k[:2] == (B, 1)}
        if stack_flags != {False, True}:
            raise AssertionError(f"{tier}: the stack arm's graph key does not differ "
                                 f"({stack_flags})")
        log(f"graph speed-up {tier}: eager / graph {res[f'{tier} eager'][0] / res[f'{tier} graph'][0]:.3f}, "
            f"graph / stack graph {res[f'{tier} graph'][0] / res[f'{tier} stack graph'][0]:.3f}")
    K = cfg.dprnn_blocks
    per_hop = {"dprnn_intra_kernel": 2 * K, "dprnn_inter_kernel": 2 * K,
               "gru_recur_cluster_kernel": 5}
    prof = {}
    for label, extra, want in (
            ("highest graph", ["--quality", "highest"], per_hop),
            ("highest stack graph", ["--quality", "highest", "--stack"],
             {"dprnn_stack_kernel": 2, "gru_recur_cluster_kernel": 5}),
            ("turbo+V2 graph", ["--quality", "turbo", "--v2"],
             {"dprnn_intra_kernel": 2 * K, "dprnn_inter_v2_kernel": 2 * K,
              "gru_recur_cluster_kernel": 5})):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "dpdfnet_tpu_torch.runtime.profile",
                              "--stream", "--hops", "50", *extra], capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"profile {label} failed: {out.stderr[-2000:]}")
        p = json.loads(out.stdout[out.stdout.index("{"):])
        hops_p = p["hops"]
        prof[label] = p
        log(f"profile --stream {label} ({B} streams, {hops_p} hops): ms per hop "
            f"{p['ms_per_hop']:.3f}, device busy {p['device_busy_ms'] / hops_p:.3f} ms per hop, "
            f"busy share {p['device_busy_share']:.3f}, device ops per hop "
            f"{p['device_ops'] / hops_p:.1f}, gru_scan {p['family_ms'].get('gru_scan', 0.0) / hops_p / 5:.4f} "
            f"ms per launch, families per hop "
            f"{json.dumps({k: round(v / hops_p, 4) for k, v in p['family_ms'].items()})}; "
            f"{p['graph_replays']} graph replays, wrapper launches "
            f"{json.dumps({k: v for k, v in p['launches'].items() if v})}, kernels in the trace "
            f"{json.dumps(p['kernel_launches'])} ({time.perf_counter() - t0:.1f} s)")
        if p["graph_replays"] != hops_p or any(p["launches"].values()):
            raise AssertionError(f"profile {label}: {p['graph_replays']} replays for {hops_p} "
                                 f"hops, wrapper launches {p['launches']}")
        if p["kernel_launches"] != {k: v * hops_p for k, v in want.items()}:
            raise AssertionError(f"profile {label}: the replays ran {p['kernel_launches']}, "
                                 f"expected {want} per hop")
    return res, prof


def export_phase(cfg, params, eng, gk, smi, rng):
    """Phase 18c-d: ``export_stream`` at B=1 and ``export_offline`` at B=4 x
    2 s of the flagship on the card: timings and size, the graph's kernel
    ops, launches per loaded step, the loaded step against the engine's
    spec program, the standalone consumer in a fresh process against
    ``StreamEnhancer``, the offline artifact against the engine."""
    import collections
    import tempfile
    from pathlib import Path

    from dpdfnet_tpu_torch import StreamEnhancer
    from dpdfnet_tpu_torch import export as ex
    from dpdfnet_tpu_torch.audio_io import read_wav, write_wav

    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    with set_env(STACK, False):
        t0 = time.perf_counter()
        path = ex.export_stream(params, cfg, d / f"{MODEL}.stream.pt2")
        t_exp = time.perf_counter() - t0
        mb = path.stat().st_size / 2 ** 20
        t0 = time.perf_counter()
        loaded = ex.load_exported(path)
        t_load = time.perf_counter() - t0
        ops = collections.Counter(str(n.target) for n in loaded.program.graph.nodes
                                  if n.op == "call_function" and str(n.target).startswith("dpdfnet."))
        log(f"export_stream {MODEL} B=1: {t_exp:.1f} s to export, {mb:.1f} MB on disk, "
            f"{t_load:.1f} s to load; kernel ops in the graph {json.dumps(dict(ops))}")
        spec = torch.from_numpy((0.1 * rng.standard_normal((1, 100, cfg.freq_bins, 2))
                                 ).astype(np.float32)).cuda()
        ref, _ = eng._stream_spec_fn(1, 100)(spec, eng.init_stream_state(batch=1))
        flat = torch.from_numpy(ex.build_initial_flat_state(loaded.meta))[None].cuda()
        loaded.call(spec[:, :1], flat.clone())                            # warm-up
        torch.cuda.synchronize()
        gk.reset_launch_counts()
        outs = []
        for t in range(100):
            o, flat = loaded.call(spec[:, t:t + 1], flat)
            outs.append(o)
        torch.cuda.synchronize()
        counts = gk.launch_counts()
        got = torch.cat(outs, dim=1)
        err = (got - ref).abs().max().item()
        per_step = {"dprnn_intra_block": 2 * cfg.dprnn_blocks,
                    "dprnn_inter_block": 2 * cfg.dprnn_blocks, "gru_scan": 5}
        log(f"loaded step, 100 frames vs the engine's spec program: max_abs {err:.3e} (tol "
            f"1e-05), torch.equal {torch.equal(got, ref)}; launches {json.dumps(counts)} = "
            f"{json.dumps(per_step)} per step x 100")
        expect_counts("loaded export step", counts, {k: 100 * v for k, v in per_step.items()})
        if not err <= 1e-5:
            raise AssertionError(f"the exported step deviates from the spec program by {err:.3e}")

        sr = cfg.sample_rate
        x = (0.2 * np.sin(2 * np.pi * 330 * np.arange(3 * sr) / sr)
             + 0.05 * rng.standard_normal(3 * sr)).astype(np.float32)
        in_wav, out_wav = d / "in.wav", d / "out.wav"
        write_wav(in_wav, x, sr, subtype="PCM_16")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "dpdfnet_tpu_torch.tools.consume_exported",
                            str(path), str(in_wav), str(out_wav)], capture_output=True,
                           text=True, timeout=600)
        t_cons = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"consume_exported failed: {r.stderr[-2000:]}")
        modules = json.loads(r.stdout.strip().splitlines()[-1].split(" ", 1)[1])
        got_wav, _ = read_wav(out_wav)
        se = StreamEnhancer(engine=eng)
        q = np.asarray(read_wav(in_wav)[0], np.float32)
        ref_wav = np.concatenate([se.process(q), se.flush()])
        n = min(got_wav.shape[0], ref_wav.shape[0])
        err_c = float(np.abs(got_wav[:n] - ref_wav[:n]).max())
        banned = [m for m in modules if m.startswith(("dpdfnet_tpu_torch.models",
                                                      "dpdfnet_tpu_torch.runtime",
                                                      "dpdfnet_tpu_torch.export",
                                                      "dpdfnet_tpu_torch.stream"))]
        log(f"consume_exported in a fresh process, 3 s wav: {t_cons:.1f} s wall, vs "
            f"StreamEnhancer max_abs {err_c:.3e} over {n} samples (tol 2e-04, the 16-bit step); "
            f"modules loaded {modules}")
        if not err_c <= 2e-4 or banned or n < 2 * sr:
            raise AssertionError(f"the consumer deviates by {err_c:.3e} or loaded {banned}")

        # offline at B=4 x 2 s: the bucket enhance_waveforms pads 2 s to
        S0 = 2 * sr
        S = eng.bucket_len(S0)
        wav = (0.1 * rng.standard_normal((4, S0))).astype(np.float32)
        t0 = time.perf_counter()
        po = ex.export_offline(params, cfg, d / f"{MODEL}.offline.pt2", batch=4,
                               seconds=S / sr)
        t_off = time.perf_counter() - t0
        lo = ex.load_exported(po)
        padded = np.zeros((4, S), np.float32)
        padded[:, :S0] = wav
        y = lo.call(torch.from_numpy(padded).cuda(), torch.zeros((), device="cuda"))
        y = y.cpu().numpy()[:, :S0]
        y_ref = eng.enhance_waveforms(wav)
        err_o = float(np.abs(y - y_ref).max())
        log(f"export_offline {MODEL} B=4 x {S / sr:g} s (2 s padded to the bucket): "
            f"{t_off:.1f} s to export, {po.stat().st_size / 2 ** 20:.1f} MB; vs "
            f"Engine.enhance_waveforms max_abs {err_o:.3e} (tol 1e-05), equal "
            f"{np.array_equal(y, y_ref)} | {smi}")
        if not np.isfinite(y).all() or not err_o <= 1e-5:
            raise AssertionError(f"the offline artifact deviates from the engine by {err_o:.3e}")
    tmp.cleanup()
    return counts


def mesh_phase(cfg, params, gk, smi, rng):
    """Phase 19a-b: the engine on a mesh.  (a) the mesh over every visible
    card against the engine without a mesh, and on several cards each
    shard against one engine on its card; (b) the mesh ``[cuda:0,
    cuda:0]``: the split, the pad and the gather with the real kernels, in
    ``highest`` and ``turbo`` + V2, with the launches and graph replays per
    replica, the second shard against one engine on its rows, and a stream
    batch the mesh cannot split.  Returns the
    engines 19d times: the one without a mesh, the mesh ``[cuda:0,
    cuda:0]`` and the mesh over every card when there are several."""
    from dpdfnet_tpu_torch import Engine
    from dpdfnet_tpu_torch.parallel.mesh import Sharded, make_mesh
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality
    from dpdfnet_tpu_torch.utils.tree import tree_map

    K = cfg.dprnn_blocks
    per_call = {"dprnn_intra_block": 2 * K, "dprnn_inter_block": 2 * K, "gru_scan": 5}
    B, hops = 64, 40
    big = (0.1 * rng.standard_normal((B, int(4.0 * cfg.sample_rate)))).astype(np.float32)
    frames = stream_frames(rng, B, hops, cfg.win_len)

    def runs(e, rows=B, streams=B):
        """Offline on ``rows`` utterances, exact and throughput streaming on
        ``streams`` streams."""
        y = e.enhance_waveforms(big[:rows])
        fr = frames[:streams]
        ys, st = e.process_frames(fr, e.init_stream_state(batch=streams))
        tp, _ = e.process_frames(fr, e.init_stream_state(batch=streams), mode="throughput")
        return y, ys, tp, st

    def dev(got, ref):
        return float(np.abs(got - ref).max()), rel_rms(got, ref)

    def shards_vs_one(tag, e, outs, rows, streams):
        """Each shard k >= 1 of the mesh engine ``e`` against one engine on
        shard k's device given the same rows: ``outs`` are e's offline
        output on ``big[:rows]`` and its exact and throughput outputs on
        ``frames[:streams]``.  Both run the same rows through the same
        code, so a launch on another card than its tensors' fails or moves
        the output by its own magnitude."""
        n = e.mesh.size
        b, bs = -(-rows // n), streams // n
        padded = np.zeros((b * n, big.shape[1]), np.float32)
        padded[:rows] = big[:rows]
        for k, d in enumerate(e.mesh.devices[1:], 1):
            ek = Engine(cfg, tree_map(lambda _, x: x.to(d), params), precision="highest",
                        device=d)
            y_k = ek.enhance_waveforms(padded[k * b:(k + 1) * b])[:max(0, min(b, rows - k * b))]
            fr_k = frames[k * bs:(k + 1) * bs]
            ys_k, _ = ek.process_frames(fr_k, ek.init_stream_state(batch=bs))
            tp_k, _ = ek.process_frames(fr_k, ek.init_stream_state(batch=bs), mode="throughput")
            pairs = [(outs[0][k * b:k * b + len(y_k)], y_k), (outs[1][k * bs:(k + 1) * bs], ys_k),
                     (outs[2][k * bs:(k + 1) * bs], tp_k)]
            errs_k = [dev(g, r)[0] for g, r in pairs]
            log(f"{tag} shard {k} of the mesh against one engine on {d} (offline {len(y_k)} "
                f"rows, exact and throughput {bs} streams): max_abs "
                f"{['%.3e' % x for x in errs_k]}, bit-identical "
                f"{[bool(np.array_equal(g, r)) for g, r in pairs]} (tol {MESH_TOL:.0e})")
            if not max(errs_k) <= MESH_TOL:
                raise AssertionError(f"{tag}: shard {k} deviates from one engine on {d}: "
                                     f"{errs_k}")

    with set_env(STACK, False):
        one = Engine(cfg, params, precision="highest", device="cuda")
        ref = runs(one)

        # ---- 19a: every visible card ----
        mesh = make_mesh()
        n = mesh.size
        Bs = B - B % n                        # streams: a multiple of the mesh size
        em = Engine(cfg, params, precision="highest", mesh=mesh)
        got = runs(em, streams=Bs)
        errs = [dev(g, r[:len(g)])[0] for g, r in zip(got[:3], ref[:3])]
        same = [bool(np.array_equal(g, r[:len(g)])) for g, r in zip(got[:3], ref[:3])]
        log(f"19a mesh over every visible card {[str(d) for d in mesh.devices]}: offline "
            f"B={B} x 4 s, exact and throughput streaming {Bs} streams x {hops} hops against "
            f"the engine without a mesh: max_abs {['%.3e' % e for e in errs]}, "
            f"bit-identical {same} (tol: equal on one card, {MESH_TOL:.0e} on more)")
        if n == 1 and not all(same) or not max(errs) <= MESH_TOL:
            raise AssertionError(f"19a: the mesh engine deviates from one engine: {errs}")
        shards_vs_one("19a", em, got[:3], B, Bs)
        if n == 1:
            em = None

        # ---- 19b: [cuda:0, cuda:0], highest ----
        m2 = make_mesh(["cuda:0", "cuda:0"])
        e2 = Engine(cfg, params, precision="highest", mesh=m2)
        n_seg = segments(e2, big.shape[1])
        torch.cuda.synchronize()
        gk.reset_launch_counts()
        y63 = e2.enhance_waveforms(big[:63])
        torch.cuda.synchronize()
        counts = gk.launch_counts()
        err = dev(y63, ref[0][:63])
        log(f"19b mesh [cuda:0, cuda:0] highest offline B=63 x 4 s (padded to 64, 2 shards of "
            f"32): vs the engine without a mesh max_abs {err[0]:.3e} rel_rms {err[1]:.3e} "
            f"(tol {MESH_TOL:.0e}); launches {json.dumps(counts)} ({n_seg} segments x 2 "
            f"replicas, expected per segment per replica {json.dumps(per_call)})")
        expect_counts("19b offline", counts, {k: 2 * n_seg * v for k, v in per_call.items()})
        if y63.shape != (63, big.shape[1]) or not err[0] <= MESH_TOL:
            raise AssertionError(f"19b: offline on the mesh deviates by {err[0]:.3e}")
        outs = {}
        for mode, r in (("exact", ref[1]), ("throughput", ref[2])):
            steps = [1] * hops if mode == "exact" else stream_steps(hops)
            for call in (1, 2):
                replays = [rep.graph_replays for rep in e2.replicas]
                st = e2.init_stream_state(batch=B)
                torch.cuda.synchronize()
                gk.reset_launch_counts()
                y, st = e2.process_frames(frames, st, mode=mode)
                torch.cuda.synchronize()
                counts = gk.launch_counts()
                replays = [rep.graph_replays - r0 for rep, r0 in zip(e2.replicas, replays)]
                err = dev(y, r)
                captured = len(set(steps)) if call == 1 else 0
                log(f"19b {mode} streaming {B} streams x {hops} hops, call {call}: max_abs "
                    f"{err[0]:.3e} (tol {MESH_TOL:.0e}); state {type(st).__name__} of "
                    f"{len(st)} shards of {st[0]['enc_gru'][0].shape[0]} streams; graph "
                    f"replays per replica {replays}, wrapper launches {json.dumps(counts)} "
                    f"(the eager step of each of the {captured} captures per replica)")
                expect_counts(f"19b {mode} call {call}", counts,
                              {k: 2 * captured * v for k, v in per_call.items() if captured})
                if replays != [len(steps) - captured] * 2 or not isinstance(st, Sharded):
                    raise AssertionError(f"19b {mode}: replays {replays} for {len(steps)} steps")
                if not err[0] <= MESH_TOL:
                    raise AssertionError(f"19b {mode}: the mesh deviates by {err[0]:.3e}")
                outs[mode] = y
        shards_vs_one("19b", e2, (y63, outs["exact"], outs["throughput"]), 63, B)
        for bad in (lambda: e2.init_stream_state(batch=63),
                    lambda: e2.process_frames(frames[:63], None)):
            try:
                bad()
            except ValueError as exc:
                msg = str(exc)
            else:
                raise AssertionError("19b: a stream batch of 63 on a mesh of 2 did not raise")
            if "multiple of the mesh size" not in msg:
                raise AssertionError(f"19b: unexpected error {msg!r}")
        log(f"19b a stream batch of 63 raises: {msg}")

    # ---- 19b: turbo + V2 ----
    with set_env(STACK, False), set_env(V2, True):
        t1 = engine_from_quality(cfg, params, "turbo", device="cuda")
        t2 = engine_from_quality(cfg, params, "turbo", mesh=m2)
        tref = runs(t1)
        counts = {}
        for name, e, rows in (("one", t1, 32), ("mesh", t2, 63)):
            torch.cuda.synchronize()
            gk.reset_launch_counts()
            e.enhance_waveforms(big[:rows])
            torch.cuda.synchronize()
            counts[name] = gk.launch_counts()
        tgot = runs(t2, rows=63)
    errs = [dev(g, r[:g.shape[0]]) for g, r in zip(tgot[:3], tref[:3])]
    log(f"19b mesh [cuda:0, cuda:0] turbo + V2 against turbo + V2 without a mesh (offline "
        f"B=63, exact, throughput): max_abs / rel_rms "
        f"{[('%.3e' % a, '%.3e' % b) for a, b in errs]} (tol rel_rms {TURBO_MESH_REL_RMS:.0e}); "
        f"offline launches on the mesh {json.dumps(counts['mesh'])}, twice one engine's "
        f"{json.dumps(counts['one'])}")
    if not all(b <= TURBO_MESH_REL_RMS for _, b in errs):
        raise AssertionError(f"19b turbo: the mesh deviates: {errs}")
    if not counts["one"].get("dprnn_inter_block_v2"):
        raise AssertionError("19b turbo: the V2 inter kernel did not run")
    expect_counts("19b turbo offline", counts["mesh"],
                  {k: 2 * v for k, v in counts["one"].items() if v})
    return one, e2, em


def mesh_train_phase(cfg, smi):
    """Phase 19c: ``make_train_step(mesh=[cuda:0, cuda:0])`` at B=4 x 1.0 s
    against the step without a mesh (the loss, and each gradient leaf
    against its largest value), then ms per step and peak memory."""
    from dpdfnet_tpu_torch.models.params import contract_params, init_params
    from dpdfnet_tpu_torch.parallel.mesh import make_mesh
    from dpdfnet_tpu_torch.quality import speechlike_test_signal
    from dpdfnet_tpu_torch.train import make_train_step, trainable_parameters
    from dpdfnet_tpu_torch.utils.tree import tree_leaves

    rng = np.random.default_rng(19)
    clean = speechlike_test_signal(1.0, cfg.sample_rate, seed=0, batch=4)
    noisy = clean + (0.02 * rng.standard_normal(clean.shape)).astype(np.float32)
    clean_t, noisy_t = torch.from_numpy(clean).cuda(), torch.from_numpy(noisy).cuda()
    m2 = make_mesh(["cuda:0", "cuda:0"])
    steps = {}
    for name, mesh in (("none", None), ("mesh", m2)):
        p = contract_params(init_params(cfg, seed=0, device="cuda"))
        st = make_train_step(cfg, torch.optim.SGD(trainable_parameters(p), lr=0.0), mesh=mesh)
        loss, _ = st(p, noisy_t, clean_t)
        steps[name] = (float(loss), {k: (torch.zeros_like(v) if v.grad is None else v.grad)
                                     for k, v in tree_leaves(p) if v.requires_grad})
    (l_m, g_m), (l_1, g_1) = steps["mesh"], steps["none"]
    loss_rel = abs(l_m - l_1) / abs(l_1)
    worst = sorted(((float((g_m[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30), k)
                    for k, g in g_1.items()), reverse=True)
    log(f"19c train step on the mesh [cuda:0, cuda:0] vs without, B=4 x 1.0 s: loss "
        f"{l_m:.8f} vs {l_1:.8f} (rel {loss_rel:.2e}, tol {TRAIN_LOSS_REL:.0e}); "
        f"{len(g_1)} gradient leaves, worst max-abs / leaf max "
        f"{[(k, f'{e:.2e}') for e, k in worst[:3]]} (tol {TRAIN_GRAD_REL:.0e})")
    if not loss_rel <= TRAIN_LOSS_REL or not worst[0][0] <= TRAIN_GRAD_REL:
        raise AssertionError("the train step on the mesh deviates from the step without one")
    p = contract_params(init_params(cfg, seed=0, device="cuda"))
    step = make_train_step(cfg, torch.optim.Adam(trainable_parameters(p), lr=1e-3), mesh=m2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        loss, _ = step(p, noisy_t, clean_t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"19c train step on the mesh [cuda:0, cuda:0], B=4 x 1.0 s, Adam: "
        f"{statistics.median(times[1:]) * 1e3:.1f} ms per step (median of steps 2-4; steps "
        f"{[round(t * 1e3, 1) for t in times]} ms), peak memory {peak:.2f} GiB, losses "
        f"{[round(v, 6) for v in losses]} | {smi}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"19c: mesh train losses not finite or not falling: {losses}")


def mesh_cost_phase(cfg, params, one, e2, em, smi, rng):
    """Phase 19d: what the mesh wrapper costs on one card: offline xRT at
    B=64 x 4 s and exact ms per hop at 64 streams for the engine without a
    mesh, the mesh of one card and the mesh ``[cuda:0, cuda:0]`` (and the
    mesh ``em`` over every card, when there are several), interleaved call
    by call (offline) and block by block (streaming)."""
    from dpdfnet_tpu_torch import Engine
    from dpdfnet_tpu_torch.parallel.mesh import make_mesh

    B, secs, block = 64, 4.0, 20
    big = (0.1 * rng.standard_normal((B, int(secs * cfg.sample_rate)))).astype(np.float32)
    frames = stream_frames(rng, B, 8 + 4 * block, cfg.win_len)
    with set_env(STACK, False):
        arms = {"no mesh": one,
                "mesh [cuda:0]": Engine(cfg, params, precision="highest",
                                        mesh=make_mesh(["cuda:0"])),
                "mesh [cuda:0, cuda:0]": e2}
        if em is not None and B % em.mesh.size == 0:
            arms[f"mesh over {em.mesh.size} cards"] = em
        names = list(arms)
        off = {n: [] for n in names}
        hop = {n: [] for n in names}
        states = {}
        for n, e in arms.items():
            e.enhance_waveforms(big)                                   # warm-up
            _, states[n] = _hops(e, frames[:, :8])                     # capture
        for k in range(3):
            for n in (names if k % 2 == 0 else names[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                arms[n].enhance_waveforms(big)
                torch.cuda.synchronize()
                off[n].append(B * secs / (time.perf_counter() - t0))
        for k in range(4):
            for n in (names if k % 2 == 0 else names[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, states[n] = _hops(arms[n], frames[:, 8 + k * block:8 + (k + 1) * block],
                                     st=states[n])
                torch.cuda.synchronize()
                hop[n].append((time.perf_counter() - t0) * 1e3 / block)
    for n in names:
        log(f"19d {n}: offline xRT B={B} x {secs} s median {statistics.median(off[n]):.1f} "
            f"[{min(off[n]):.1f}-{max(off[n]):.1f}] (3 calls), exact ms per hop {B} streams "
            f"median {statistics.median(hop[n]):.3f} [{min(hop[n]):.3f}-{max(hop[n]):.3f}] "
            f"(4 blocks of {block}), interleaved | {smi}")


def native_phase(smi):
    """Phase 19e: the native host library, built from the port's
    ``csrc/dpdfnet_host.cpp`` and loaded on the card's machine:
    ``ola_commit`` bit-equal to the NumPy form, ``resample`` within 1e-3 of
    scipy's ``resample_poly``, and the PCM16 WAV writer's bytes and the
    reader's samples equal to the NumPy codec's."""
    import tempfile
    from pathlib import Path

    from scipy.signal import resample_poly

    from dpdfnet_tpu_torch import audio_io, native

    t0 = time.perf_counter()
    ok = native.available()
    log(f"19e native library {native.lib_path()} built and loaded {ok} "
        f"({time.perf_counter() - t0:.2f} s)")
    if not ok:
        raise AssertionError("19e: the native host library did not build or load")
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((50, 960)).astype(np.float32)
    tail0 = rng.standard_normal(480).astype(np.float32)
    tail = tail0.copy()
    got = native.ola_commit(frames, tail)
    plain = (frames[:, :480] + np.concatenate([tail0[None], frames[:-1, 480:]])).reshape(-1)
    if not (np.array_equal(got, plain) and np.array_equal(tail, frames[-1, 480:])):
        raise AssertionError("19e: ola_commit differs from the NumPy form")
    t = np.arange(16000) / 16000
    x = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1330 * t)
         ).astype(np.float32)
    errs = {}
    for up, down in ((3, 1), (1, 3), (160, 441), (441, 160)):
        y = native.resample(x, up, down)
        r = resample_poly(x.astype(np.float64), up, down).astype(np.float32)
        n = min(len(y), len(r))
        errs[f"{up}/{down}"] = float(np.abs(y[200:n - 200] - r[200:n - 200]).max())
        if abs(len(y) - len(r)) > 1 or not errs[f"{up}/{down}"] <= 1e-3:
            raise AssertionError(f"19e: resample {up}/{down} deviates from scipy")
    with tempfile.TemporaryDirectory() as d:
        a, b = Path(d) / "native.wav", Path(d) / "numpy.wav"
        w = np.clip(0.5 * rng.standard_normal((48000, 2)), -1, 1).astype(np.float32)
        if not native.wav_write(a, w, 48000):
            raise AssertionError("19e: the native WAV writer failed")
        load = native.load
        native.load = lambda: None                 # the NumPy codec
        try:
            audio_io.write_wav(b, w, 48000)
            y_plain, _ = audio_io.read_wav(a)
        finally:
            native.load = load
        y, sr = native.wav_read(a)
        same = a.read_bytes() == b.read_bytes() and sr == 48000 and np.array_equal(y, y_plain)
    log(f"19e ola_commit bit-equal to NumPy True; resample vs resample_poly max_abs "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} (tol 1e-3); PCM16 "
        f"WAV 1 s x 2 channels: native bytes and samples equal to the NumPy codec's {same}")
    if not same:
        raise AssertionError("19e: the native WAV codec differs from the NumPy codec")


def distributed_phase(cfg, params, smi):
    """Phase 19f: ``enhance-dir --distributed`` in one process per visible
    card (two on one card) through ``torch.distributed.run``, against one
    ``enhance-dir`` run in one process: each host's ``[INFO]`` line, the
    shards' files disjoint and together the single run's files, each
    within one 16-bit step of it."""
    import tempfile
    from pathlib import Path

    from dpdfnet_tpu_torch import audio_io
    from dpdfnet_tpu_torch.utils.serialization import save_params

    procs = max(2, torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        save_params(d / f"{MODEL}.params.npz", params)
        src = d / "in"
        src.mkdir()
        rng = np.random.default_rng(6)
        for i in range(2 * procs + 1):
            n = int((1.0 + 0.25 * i) * cfg.sample_rate)
            audio_io.write_wav(src / f"u{i}.wav",
                               (0.1 * rng.standard_normal(n)).astype(np.float32),
                               cfg.sample_rate)
        env = dict(os.environ, DPDFNET_TPU_MODEL_DIR=str(d), DPDFNET_TPU_CACHE_DIR=str(d / "c"),
                   NO_BANNER="1")
        for k in ("DPDFNET_TPU_NUM_HOSTS", "DPDFNET_TPU_HOST_ID"):
            env.pop(k, None)
        cmd = ["-m", "dpdfnet_tpu_torch", "enhance-dir", str(src)]
        args = ["--model", MODEL, "--batch-size", "4"]
        t0 = time.perf_counter()
        one = subprocess.run([sys.executable, *cmd, str(d / "one"), *args], env=env,
                             capture_output=True, text=True, timeout=600)
        t_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        dist = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               f"--nproc-per-node={procs}", *cmd, str(d / "dist"), *args,
                               "--distributed"], env=env, capture_output=True, text=True,
                              timeout=600)
        t_dist = time.perf_counter() - t0
        if one.returncode != 0 or dist.returncode != 0:
            raise AssertionError(f"19f enhance-dir failed: {one.stderr[-1500:]}\n"
                                 f"{dist.stderr[-3000:]}")
        info = sorted(line for line in dist.stdout.splitlines() if line.startswith("[INFO] host"))
        whole = {p.name: audio_io.read_wav(p)[0] for p in (d / "one").iterdir()}
        got = {p.name: audio_io.read_wav(p)[0] for p in (d / "dist").iterdir()}
        worst = max(float(np.abs(got[k] - whole[k]).max()) for k in whole) if \
            sorted(got) == sorted(whole) else float("inf")
    want = [f"[INFO] host {h}/{procs}: processing {len(range(h, 2 * procs + 1, procs))} of "
            f"{2 * procs + 1} files" for h in range(procs)]
    log(f"19f enhance-dir --distributed, {procs} processes on {torch.cuda.device_count()} "
        f"card(s) (torch.distributed.run, NCCL): {info}; {len(got)} files, max-abs against one "
        f"process {worst:.3e} (tol one 16-bit step); wall {t_dist:.1f} s against {t_one:.1f} s "
        f"in one process | {smi}")
    if info != want or not worst <= 1.0 / 32768.0:
        raise AssertionError(f"19f: the distributed run differs: {info} (want {want}), "
                             f"max-abs {worst}")


def phase19(cfg, params, gk, smi) -> None:
    t_phase = time.perf_counter()
    rng = np.random.default_rng(19)
    one, e2, em = mesh_phase(cfg, params, gk, smi, rng)
    mesh_train_phase(cfg, smi)
    mesh_cost_phase(cfg, params, one, e2, em, smi, rng)
    native_phase(smi)
    distributed_phase(cfg, params, smi)
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s wall")


def _interleaved(arms: dict, rounds: int, run) -> dict:
    """``run(arm)`` once per arm per round after a warm-up round, the arms'
    order reversed every other round (A B, B A, ...), each timed on the host
    clock around a synchronised call; returns each arm's list of seconds."""
    names = list(arms)
    for name in names:
        run(arms[name])                                         # warm-up, capture
    walls = {n: [] for n in names}
    for k in range(rounds):
        for name in (names if k % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(arms[name])
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    return walls


def fold_phase(cfg, params, cpu_params, eng, smi, rng, wavs, lengths):
    """Phase 20: the frequency-folded 48 kHz plane (``models.fuse.
    fold_hr_tail``, which the JAX package's ``prepare_inference_params``
    runs and the port's leaves out) against the default, unfolded tree on
    the card: (a) the default engine holds no folded weights, and a folded
    engine (``fuse_separable``, ``fold_hr_tail``, ``pack_dprnn_bidir``,
    ``fuse=False``) on the card agrees with one on the CPU within
    ENGINE_TOL on phase 3's utterances; (b) folded against unfolded on the
    card, offline (phase 3's utterances) and exact streaming (4 streams x
    40 hops), max-abs FOLD_TOL in highest and rel_rms FOLD_TURBO_REL_RMS in
    turbo; (c) the A/B: offline xRT at B=64 x 4 s (5 interleaved rounds)
    and exact ms per hop at 64 streams through the CUDA graph (200 hops in
    interleaved blocks of 20), in highest and turbo, median [min-max]; (d)
    one point each of the ``bench_sweep``, ``stream_sweep`` and
    ``tier_accuracy`` tools on the card.  Returns the A/B's medians and
    ranges."""
    from dpdfnet_tpu_torch import Engine
    from dpdfnet_tpu_torch.models.fuse import fold_hr_tail, fuse_separable, pack_dprnn_bidir
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality
    from dpdfnet_tpu_torch.tools import bench_sweep, stream_sweep, tier_accuracy

    def fold(p):
        return pack_dprnn_bidir(fold_hr_tail(fuse_separable(p, cfg), cfg), cfg)

    t_phase = time.perf_counter()
    if "erb_conv0_folded" in eng.params["enc"]:
        raise AssertionError("the default engine holds folded weights")
    folded = fold(params)
    y_card = Engine(cfg, folded, fuse=False, device="cuda").enhance_waveforms(wavs,
                                                                             lengths=lengths)
    y_cpu = Engine(cfg, fold(cpu_params), fuse=False, device="cpu").enhance_waveforms(
        wavs, lengths=lengths)
    err = float(np.abs(y_card - y_cpu).max())
    log(f"fold: folded engine B=3 (phase 3's utterances) card vs CPU max_abs {err:.3e} "
        f"(tol {ENGINE_TOL:.0e})")
    if not (np.isfinite(y_card).all() and err <= ENGINE_TOL):
        raise AssertionError(f"the folded card engine deviates from the CPU by {err:.3e}")

    B, hops, block = 64, 200, 20
    big = (0.1 * rng.standard_normal((B, int(4.0 * cfg.sample_rate)))).astype(np.float32)
    frames = stream_frames(rng, B, hops, cfg.win_len)
    small = stream_frames(rng, 4, 40, cfg.win_len)
    res = {}
    for q in ("highest", "turbo"):
        arms = {"folded": {"e": engine_from_quality(cfg, folded, q, device="cuda",
                                                    fuse=False)},
                "unfolded": {"e": engine_from_quality(cfg, params, q, device="cuda")}}
        for what, fn in (("offline", lambda e: e.enhance_waveforms(wavs, lengths=lengths)),
                         ("exact", lambda e: e.process_frames(
                             small, e.init_stream_state(batch=4))[0])):
            yf, yu = fn(arms["folded"]["e"]), fn(arms["unfolded"]["e"])
            d = yf - yu
            if q == "highest":
                dev, tol = float(np.abs(d).max()), FOLD_TOL
            else:
                dev, tol = rel_rms(yf, yu), FOLD_TURBO_REL_RMS
            log(f"fold {q} {what}: folded vs unfolded on the card "
                f"{'max_abs' if q == 'highest' else 'rel_rms'} {dev:.3e} (tol {tol:.0e})")
            if not (np.isfinite(yf).all() and dev <= tol):
                raise AssertionError(f"fold {q} {what}: folded deviates from unfolded by {dev:.3e}")
        walls = _interleaved(arms, 5, lambda a: a["e"].enhance_waveforms(big))
        for name, w in walls.items():
            xs = sorted(B * 4.0 / t for t in w)
            res[(q, "xrt", name)] = (statistics.median(xs), xs[0], xs[-1])
        for a in arms.values():
            a["st"] = a["e"].init_stream_state(batch=B)
            a["pos"] = 0

        def hop_block(a):
            i = a["pos"] % hops
            n = min(block, hops - i)
            _, a["st"] = _hops(a["e"], frames[:, i:i + n], st=a["st"])
            a["pos"] += n
        walls = _interleaved(arms, hops // block, hop_block)
        for name, w in walls.items():
            ms = sorted(t * 1e3 / block for t in w)
            res[(q, "ms", name)] = (statistics.median(ms), ms[0], ms[-1])
        for name in arms:
            log(f"fold A/B {q} {name}: offline B={B} x 4 s xRT {spread(res[(q, 'xrt', name)])} "
                f"(5 interleaved calls); exact ms per hop {spread(res[(q, 'ms', name)])} "
                f"({B} streams, {hops} hops in interleaved blocks of {block}, CUDA graph) | {smi}")
        log(f"fold A/B {q}: folded / unfolded xRT "
            f"{res[(q, 'xrt', 'folded')][0] / res[(q, 'xrt', 'unfolded')][0]:.4f}, ms per hop "
            f"{res[(q, 'ms', 'folded')][0] / res[(q, 'ms', 'unfolded')][0]:.4f}")

    def tool(mod, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        out = buf.getvalue().strip().splitlines()
        if rc != 0 or not out:
            raise AssertionError(f"{mod.__name__} {argv}: exit {rc}, output {out}")
        return [json.loads(line) for line in out]

    t0 = time.perf_counter()
    (b,) = tool(bench_sweep, ["--model", MODEL, "--points", "b64:s112", "--seconds", "4",
                              "--reps", "3"])
    (s,) = tool(stream_sweep, ["--model", MODEL, "--points", "exact:s64:high"])
    (t,) = tool(tier_accuracy, ["--model", MODEL, "--json"])
    dev_name = torch.cuda.get_device_name(0)
    if not b["device"] == s["device"] == t["device"] == dev_name:
        raise AssertionError(f"a tool ran off the card: {b['device']}, {s['device']}, {t['device']}")
    dev_tiers = {f"{r}/{k}": (round(v["max_abs"], 8), round(v["rel_rms"], 6))
                 for r, tiers in t["results"].items() for k, v in tiers.items()
                 if not k.startswith("_")}
    log(f"tools on the card ({time.perf_counter() - t0:.1f} s): bench_sweep {json.dumps(b)}; "
        f"stream_sweep {s['point']} {s['value']} ms per hop; tier_accuracy (max_abs, rel_rms) "
        f"{json.dumps(dev_tiers)} | {smi}")
    contractive = t["results"]["contractive"]
    for tier in ("fast", "turbo"):
        if not (contractive[tier]["max_abs"] <= TIER_TOL
                and contractive[tier]["rel_rms"] <= TIER_REL_RMS):
            raise AssertionError(f"tier_accuracy {tier}: {contractive[tier]}")
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s wall")
    return res


class StepSession:
    """A session shaped as the reference's ``onnxruntime`` one over a loaded
    ``export_stream`` artifact on the card (what ``quality.
    enhance_reference_onnx`` reads: ``get_modelmeta().custom_metadata_map``,
    ``get_inputs()``, ``get_outputs()``, ``run()``).  The sidecar is the
    metadata; ``run`` takes and returns the spectrum at the reference's
    scale (the artifact's is times ``wnorm``) and the state as ``[S]``, and
    counts its calls and their wall seconds."""

    def __init__(self, loaded, cfg):
        from types import SimpleNamespace as NS

        self.loaded, self.wnorm = loaded, cfg.wnorm
        self._meta = NS(custom_metadata_map={k: str(v) for k, v in loaded.meta.items()})
        self._inputs = [NS(name="spec", shape=[1, 1, cfg.freq_bins, 2]),
                        NS(name="state", shape=[int(loaded.meta["state_size"])])]
        self._outputs = [NS(name="spec_e"), NS(name="state_out")]
        self.calls, self.seconds = 0, 0.0

    def get_modelmeta(self):
        return self._meta

    def get_inputs(self):
        return self._inputs

    def get_outputs(self):
        return self._outputs

    def run(self, out_names, feed):
        t0 = time.perf_counter()
        spec = torch.from_numpy(feed["spec"] * self.wnorm).cuda()
        flat = torch.from_numpy(feed["state"]).reshape(1, -1).cuda()
        out, st = self.loaded.call(spec, flat)
        res = [out.cpu().numpy() / self.wnorm, st.reshape(-1).cpu().numpy()]
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return res


def onnx_gate_phase(cfg, params, eng, gk, smi):
    """Phase 21: the reference-ONNX quality gate on the card through the
    port's exported step (module docstring, item 21)."""
    import csv
    import importlib.util

    from dpdfnet_tpu_torch import metrics, quality
    from dpdfnet_tpu_torch import export as ex
    from dpdfnet_tpu_torch.audio_io import write_wav
    from dpdfnet_tpu_torch.quality import speechlike_test_signal

    t_phase = time.perf_counter()
    sr, win = cfg.sample_rate, cfg.win_len
    with model_dir(params) as d:
        t0 = time.perf_counter()
        path = str(ex.export_stream(params, cfg, d / f"{MODEL}.stream.pt2",
                                    precision=eng.precision, device=eng.device))
        sess = StepSession(ex.load_exported(path), cfg)
        t_exp = time.perf_counter() - t0
        sess.run(None, {"spec": np.zeros((1, 1, cfg.freq_bins, 2), np.float32),
                        "state": np.zeros(int(sess.loaded.meta["state_size"]), np.float32)})
        sess.calls, sess.seconds = 0, 0.0                               # the warm-up
        quality._ONNX_SESSIONS[path] = sess
        try:
            # ---- (a) the reference pipeline on the exported step against the engine ----
            x = speechlike_test_signal(2.0, sr, seed=21)[0]
            frames = (x.size + win) // cfg.hop + 1
            torch.cuda.synchronize()
            gk.reset_launch_counts()
            got = quality.enhance_reference_onnx(x, sr, path, sr)
            torch.cuda.synchronize()
            counts = gk.launch_counts()
            want = eng.enhance_waveforms(x)
            per_call = {"dprnn_intra_block": 2 * cfg.dprnn_blocks,
                        "dprnn_inter_block": 2 * cfg.dprnn_blocks, "gru_scan": 5}
            dev = rel_rms(got[:-win], want[:-win])
            err = float(np.abs(got[:-win] - want[:-win]).max())
            # SI-SNR on both scaled to the engine's unit rms: metrics.si_snr's
            # eps (1e-8 on each energy) would floor it at this output level
            unit = float(np.sqrt(np.mean(want[:-win] ** 2)))
            sisnr = metrics.si_snr(want[:-win] / unit, got[:-win] / unit)
            log(f"21a enhance_reference_onnx {MODEL} 2 s at {sr} Hz through export_stream B=1 "
                f"({eng.precision}; {t_exp:.1f} s to export and load): {sess.calls} session "
                f"calls for {frames} frames, {sess.seconds * 1e3 / sess.calls:.3f} ms per call "
                f"(host copies in and out included); vs Engine.enhance_waveforms on all but the "
                f"last {win} samples rel_rms {dev:.3e} (tol {ONNX_REL_RMS:.0e}), max_abs "
                f"{err:.3e}, SI-SNR {sisnr:.2f} dB (both at the engine's unit rms), output rms "
                f"{float(np.sqrt(np.mean(want ** 2))):.3e}; the last {win} samples zeros "
                f"{not got[-win:].any()} (engine's last sample {float(want[-1]):.3e}); launches "
                f"{json.dumps(counts)} = {json.dumps(per_call)} per call | {smi}")
            if sess.calls != frames or got.shape != x.shape or not np.isfinite(got).all():
                raise AssertionError(f"21a: {sess.calls} session calls for {frames} frames, "
                                     f"output {got.shape}")
            expect_counts("21a reference pipeline", counts,
                          {k: frames * v for k, v in per_call.items()})
            if not dev <= ONNX_REL_RMS or got[-win:].any():
                raise AssertionError(f"21a: the reference pipeline deviates from the engine by "
                                     f"rel_rms {dev:.3e}, or its last {win} samples are not zeros")

            # ---- (b) validate_vs_onnx on a 2-clip corpus, the model resolved by name ----
            names = [f"clip{i}.wav" for i in range(2)]
            for i, name in enumerate(names):
                write_wav(d / name, speechlike_test_signal(1.5, sr, seed=30 + i)[0], sr)
            (d / "corpus.csv").write_text("noisy_path,clean_path\n"
                                          + "".join(f"{n},{n}\n" for n in names))
            sess.calls = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = quality.validate_vs_onnx(str(d / "corpus.csv"), path, model=MODEL,
                                              out_csv=str(d / "results.csv"), device=eng.device)
            t_gate = time.perf_counter() - t0
        finally:
            quality._ONNX_SESSIONS.pop(path, None)
        lines = buf.getvalue().splitlines()
        with open(d / "results.csv", newline="") as f:
            res = list(csv.DictReader(f))
    have_pesq = importlib.util.find_spec("pesq") is not None
    cols = {k: [float(r[k]) for r in res] for k in res[0] if k != "noisy_path"}
    log(f"21b validate_vs_onnx {MODEL}, 2 clips x 1.5 s at {sr} Hz (clean = noisy), "
        f"{t_gate:.1f} s wall (engine build included), {sess.calls} session calls: rc {rc}, "
        f"pesq importable {have_pesq}; per clip {json.dumps(cols)}; the gate's lines "
        f"{json.dumps(lines)} | {smi}")
    needed = [k for k in cols if have_pesq or not k.startswith("pesq_")]
    if len(res) != 2 or len(cols) != 6 or not all(np.isfinite(cols[k]).all() for k in needed):
        raise AssertionError(f"21b: the results CSV lacks finite metrics: {cols}")
    if not have_pesq and (rc != 1 or not lines[-1].startswith("FAIL: PESQ unavailable")):
        raise AssertionError(f"21b: without pesq the gate gave rc {rc}, {lines[-1:]}")
    if have_pesq and not ((rc, lines[-1]) == (0, "PASS")
                          or (rc == 1 and lines[-1].startswith("FAIL: |PESQ"))):
        raise AssertionError(f"21b: with pesq the gate gave rc {rc}, {lines[-1:]}")
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s wall")


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
    xrt, offline_counts = {}, {}
    for name, e, on in (("per-stage", eng, False), ("stack", eng_stack, True)):
        with set_env(STACK, on):
            e.enhance_waveforms(big)                                    # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            gk.reset_launch_counts()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = e.enhance_waveforms(big)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            offline_counts[name] = gk.launch_counts()
        if not np.isfinite(out).all():
            raise AssertionError(f"throughput output ({name}) is not finite")
        wall = statistics.median(times)
        segs = segments(e, big.shape[1])
        per_seg = ({"dprnn_stack": 2} if on else
                   {"dprnn_intra_block": 2 * cfg.dprnn_blocks,
                    "dprnn_inter_block": 2 * cfg.dprnn_blocks})
        per_seg["gru_scan"] = 5
        expect_counts(f"offline throughput {name}", offline_counts[name],
                      {k: 3 * segs * v for k, v in per_seg.items()})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        xrt[name] = B * secs / wall
        log(f"throughput {MODEL} {name} B={B} x {secs} s, f32: xRT {xrt[name]:.1f}, "
            f"median {wall * 1e3:.1f} ms per call (runs {[round(t * 1e3, 1) for t in times]}), "
            f"{wall * 1e3 / segs:.2f} ms per {e.seg_frames}-frame segment ({segs} segments), "
            f"peak memory {peak:.2f} GiB; launches over the 3 calls "
            f"{json.dumps(offline_counts[name])} | {smi}")

    # ---- phase 5: streaming, card vs CPU ----
    streaming_phase(cfg, eng, eng_stack, cpu_eng, gk, rng)

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

    # ---- phase 16: the package surface (API, CLI, streams by name, bench) ----
    with set_env(STACK, False):
        package_phase(cfg, params, eng, gk, smi, rng)

    # ---- phase 17: checkpoints in (the converter), training out ----
    t_phase = time.perf_counter()
    convert_phase(cfg, params, gk, wavs, lengths, y_gpu)
    train_phase(cfg, gk, smi)
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s wall")

    # ---- phase 18: the captured streaming programs and export ----
    t_phase = time.perf_counter()
    graph_phase(cfg, params, cpu_eng, cpu_params, gk, rng)
    graph_ab_phase(cfg, params, smi, rng)
    with set_env(STACK, False):
        export_phase(cfg, params, eng, gk, smi, rng)
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s wall")

    # ---- phase 19: the mesh, the mesh train step, the native library ----
    phase19(cfg, params, gk, smi)

    # ---- phase 20: the frequency-folded plane against the unfolded one ----
    with set_env(STACK, False), set_env(V2, False):
        fold_phase(cfg, params, cpu_params, eng, smi, rng, wavs, lengths)

    # ---- phase 21: the reference-ONNX quality gate through the exported step ----
    with set_env(STACK, False), set_env(V2, False):
        onnx_gate_phase(cfg, params, eng, gk, smi)

    # ---- phase 15: kernel list (printed last) ----
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
              f"{PALLAS}:1633", offline_counts["stack"]["dprnn_stack"]),
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
