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
   same function (a yardstick the port never calls), and the roofline bound;
3. the main path: ``Engine.enhance_waveforms`` on dpdfnet8_48khz_hr with
   random contracted weights, 3 utterances (1.3, 2.0, 3.1 s) with
   ``lengths``, on the card and on the CPU with the same weights; checks
   finiteness, the card-vs-CPU deviation and the kernels' launch counts;
4. throughput: B=64 x 4 s through ``enhance_waveforms``, median of 3 timed
   calls after a warm-up: xRT, ms per 112-frame segment, peak memory;
5. one JSON line listing the kernels, then the final JSON status line.

Needs one CUDA device; exits non-zero without one, and without the
``dpdfnet_tpu_torch`` package beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances (max-abs, float32 everywhere, TF32 off).
# Kernel vs plain version: the same f32 arithmetic summed in another order;
# over 112-step recurrences the rounding stays near 1e-6, so 1e-4 leaves
# two orders of headroom while still catching any wrong gate or index.
KERNEL_TOL = 1e-4
# Card engine vs CPU engine on the waveform: 16 DPRNN blocks and 5 GRU
# layers per segment, carried over 3-4 segments, then the iSTFT GEMM;
# every reduction differs in order between cuDNN/cuBLAS/kernels and the
# CPU, so the bound is looser than a single kernel's.
ENGINE_TOL = 5e-4

PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3

MODEL = "dpdfnet8_48khz_hr"
PALLAS = "dpdfnet_tpu/ops/pallas_gru.py"


def log(msg: str) -> None:
    print(msg, flush=True)


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


def bound(flops: float, nbytes: float):
    """(ms, what bounds it): the larger of FLOPs over peak and bytes over
    bandwidth."""
    t_f, t_b = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_f, "operations") if t_f >= t_b else (t_b, "bytes")


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


def kernel_phase(params, cfg, gk):
    """Each kernel against its plain version at the flagship shapes, B=8."""
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

    for Fq in (cfg.dprnn_erb_feat, cfg.dprnn_df_feat):
        # ---- intra: [B*T, Fq, C] ----
        x = randn(B * T, Fq, C)
        err = check(f"dprnn_intra_block Fq={Fq}", gk.dprnn_intra_block(x, *ia),
                    gk.dprnn_intra_block_plain(x, *ia))
        ms = cuda_ms(lambda: gk.dprnn_intra_block(x, *ia))
        plain_ms = cuda_ms(lambda: gk.dprnn_intra_block_plain(x, *ia), 3)
        lib = gru_module(intra["fw"]["wi"], intra["fw"]["bi"], intra["fw"]["wh"],
                         intra["fw"]["bh"], bidir=intra["bw"])

        def lib_intra():
            ys, _ = lib(x)
            return x + torch.nn.functional.layer_norm(
                torch.nn.functional.linear(ys, intra["fc"]["w"].T, intra["fc"]["b"]),
                (C,), intra["ln"]["g"], intra["ln"]["b"], 1e-5)

        lib_err = (lib_intra() - gk.dprnn_intra_block_plain(x, *ia)).abs().max().item()
        lib_ms = cuda_ms(lib_intra)
        n = B * T * Fq
        b_ms, b_by = bound(28 * C * C * n, 2 * C * 4 * n + w_bytes(ia))
        rows[("dprnn_intra_block", Fq)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                              library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"kernel dprnn_intra_block x[{B * T},{Fq},{C}]: max_abs {err:.3e} "
            f"(tol {KERNEL_TOL:.0e}; cuDNN yardstick differs by {lib_err:.1e}) "
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
            f"bound_ms {b_ms:.4f} ({b_by})")

        # ---- inter: [B, T, Fq, C] with a random carried h0 ----
        x = randn(B, T, Fq, C)
        h0 = randn(B, Fq, C, scale=0.5)
        err = check(f"dprnn_inter_block Fq={Fq}", gk.dprnn_inter_block(x, h0, *ea),
                    gk.dprnn_inter_block_plain(x, h0, *ea))
        ms = cuda_ms(lambda: gk.dprnn_inter_block(x, h0, *ea))
        plain_ms = cuda_ms(lambda: gk.dprnn_inter_block_plain(x, h0, *ea), 3)
        lib = gru_module(gw["wi"], gw["bi"], gw["wh"], gw["bh"])

        def lib_inter():
            xt = x.transpose(1, 2).reshape(B * Fq, T, C)
            ys, hl = lib(xt, h0.reshape(1, B * Fq, C))
            y = torch.nn.functional.layer_norm(
                torch.nn.functional.linear(ys, inter["fc"]["w"].T, inter["fc"]["b"]),
                (C,), inter["ln"]["g"], inter["ln"]["b"], 1e-5)
            return x + y.reshape(B, Fq, T, C).transpose(1, 2), hl

        lib_ms = cuda_ms(lib_inter)
        n = B * Fq * T
        b_ms, b_by = bound(14 * C * C * n, 2 * C * 4 * n + 2 * B * Fq * C * 4 + w_bytes(ea))
        rows[("dprnn_inter_block", Fq)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                              library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"kernel dprnn_inter_block x[{B},{T},{Fq},{C}] h0 random: max_abs {err:.3e} "
            f"(tol {KERNEL_TOL:.0e}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {lib_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")

    # ---- gru_scan: [B, T, I=H] from h0, forward and reverse ----
    gp = params["erb_dec"]["emb_gru"]["grus"][0]
    ga = (gp["wi"], gp["bi"], gp["wh"], gp["bh"])
    I = gp["wi"].shape[0]
    x = randn(B, T, I)
    h0 = randn(B, H, scale=0.5)
    for reverse in (False, True):
        err = check(f"gru_scan reverse={reverse}", gk.gru_scan(x, h0, *ga, reverse=reverse),
                    gk.gru_scan_plain(x, h0, *ga, reverse=reverse))
        ms = cuda_ms(lambda: gk.gru_scan(x, h0, *ga, reverse=reverse))
        plain_ms = cuda_ms(lambda: gk.gru_scan_plain(x, h0, *ga, reverse=reverse), 3)
        lib = gru_module(*ga)
        xin = x.flip(1) if reverse else x
        lib_ms = cuda_ms(lambda: lib(xin, h0[None]))
        n = B * T
        b_ms, b_by = bound(6 * H * (I + H) * n,
                           (I + H) * 4 * n + 2 * B * H * 4 + w_bytes(ga))
        rows[("gru_scan", reverse)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"kernel gru_scan x[{B},{T},{I}] H={H} reverse={reverse}: max_abs {err:.3e} "
            f"(tol {KERNEL_TOL:.0e}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {lib_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
    torch.cuda.synchronize()
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

    # ---- phase 2: kernels vs plain versions ----
    kernel_rows = kernel_phase(prepare_inference_params(params, cfg), cfg, gk)

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
    eng = Engine(cfg, params, device="cuda")
    eng.enhance_waveforms(wavs[:, : sr // 2])              # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    gk.reset_launch_counts()
    y_gpu = eng.enhance_waveforms(wavs, lengths=lengths)
    torch.cuda.synchronize()
    counts = gk.launch_counts()
    n_seg = segments(eng, S)
    cpu_params = tree_map(lambda _, x: x.cpu(), params)
    t_cpu = time.perf_counter()
    y_cpu = Engine(cfg, cpu_params, device="cpu").enhance_waveforms(wavs, lengths=lengths)
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
    for k, v in counts.items():
        if v <= 0 or v != n_seg * per_seg[k]:
            raise AssertionError(f"kernel {k} launched {v} times on the main path, "
                                 f"expected {n_seg * per_seg[k]}")

    # ---- phase 4: throughput ----
    B, secs = 64, 4.0
    big = (0.1 * rng.standard_normal((B, int(secs * sr)))).astype(np.float32)
    eng.enhance_waveforms(big)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = eng.enhance_waveforms(big)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not np.isfinite(out).all():
        raise AssertionError("throughput output is not finite")
    wall = statistics.median(times)
    segs = segments(eng, big.shape[1])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"throughput {MODEL} B={B} x {secs} s, f32: xRT {B * secs / wall:.1f}, "
        f"median {wall * 1e3:.1f} ms per call (runs {[round(t * 1e3, 1) for t in times]}), "
        f"{wall * 1e3 / segs:.2f} ms per {eng.seg_frames}-frame segment ({segs} segments), "
        f"peak memory {peak:.2f} GiB | {smi}")

    # ---- phase 5: kernel list ----
    def entry(name, key, source, replaces):
        r = kernel_rows[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[name], "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    df = cfg.dprnn_df_feat
    kernels = [
        entry("dprnn_intra_block", ("dprnn_intra_block", df),
              "dpdfnet_tpu_torch/csrc/dprnn_intra.cu", f"{PALLAS}:598"),
        entry("dprnn_inter_block", ("dprnn_inter_block", df),
              "dpdfnet_tpu_torch/csrc/dprnn_inter.cu", f"{PALLAS}:226"),
        entry("gru_scan", ("gru_scan", False),
              "dpdfnet_tpu_torch/csrc/gru_scan.cu", f"{PALLAS}:433"),
    ]
    for name in ("dprnn_intra_block", "dprnn_inter_block"):
        k = next(e for e in kernels if e["name"] == name)
        k["max_abs_err"] = max(kernel_rows[(name, f)]["err"]
                               for f in (cfg.dprnn_erb_feat, df))
    kernels[2]["max_abs_err"] = max(kernel_rows[("gru_scan", r)]["err"] for r in (False, True))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
