"""Where the engine's device time goes, per kernel family.

    python3 -m dpdfnet_tpu_torch.runtime.profile [--model M] [--batch B] [--seconds S]
    python3 -m dpdfnet_tpu_torch.runtime.profile --stream [--batch B] [--hops N] [--stack]
    ... [--quality highest|high|fast|turbo] [--v2] [--fm on|off] [--relayout]

Offline (default): runs ``Engine.enhance_waveforms`` once as a warm-up,
then once under ``torch.profiler``.  ``--stream``: exact streaming of
``--batch`` streams, one ``process_frames`` call per hop as a real-time
server makes them, through the engine's captured CUDA graph; 8 warm-up
hops, then ``--hops`` hops under the profiler.  ``--stack`` sets
``DPDFNET_TPU_STACK=1`` (the DPRNN stack kernel) before the engine is built; ``--quality`` picks the tier
(``engine_from_quality``, default ``high``) and ``--v2`` sets
``DPDFNET_TPU_PALLAS_V2=1`` (the inter v2 kernel under ``fast`` /
``turbo``).  ``--fm on|off`` sets ``DPDFNET_TPU_INTRA_TM`` (the freq-major
DPRNN chain at batches of 32 and more) and ``--relayout``
``DPDFNET_TPU_ENTRY_RELAYOUT=1`` (its entry permute as the ``relayout_fm``
kernel).

Prints one JSON object: the wall ms of the profiled span (and ms per hop
when streaming), the summed device ms per kernel family (the port's CUDA
kernels, convolutions, GEMMs, FFTs, everything else), the device's busy
share of the wall time, the kernel launches counted by the wrappers
(launches they made themselves), the engine's graph replays, the port's
kernels the device ran by kernel symbol (``kernel_launches``: the trace
counts what a replayed graph launches), the number of device operations
(kernels and copies) the span ran, and the top kernels by device time.  Needs a CUDA device; random contracted
weights (``init_params`` + ``contract_params``, seed 0); the tier sets its
own cuBLAS / cuDNN math mode for each engine call.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

FAMILIES = (
    ("dprnn_inter_v2", ("dprnn_inter_v2",)),
    ("dprnn_intra", ("dprnn_intra",)),
    ("dprnn_inter", ("dprnn_inter",)),
    ("dprnn_stack", ("dprnn_stack",)),
    ("relayout_fm", ("relayout_fm",)),
    ("gru_bidir", ("gru_bidir",)),
    ("gru_scan", ("gru_recur",)),
    ("proj_gemm", ("proj_gemm",)),
    ("conv", ("conv", "cudnn", "implicit_convolve", "winograd", "fft2d", "xmma_fprop")),
    ("gemm", ("gemm", "sgemm", "cutlass", "cublas", "matmul", "splitk", "nvjet")),
    ("fft", ("fft",)),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


# the port's kernels by symbol: one per wrapper launch (gru_scan's wrapper
# also launches proj_gemm_kernel; the v1 and v2 intra wrappers and the
# intra step ablation are all instances of dprnn_intra_kernel)
KERNEL_SYMBOLS = ("dprnn_intra_kernel", "dprnn_inter_kernel", "dprnn_inter_v2_kernel",
                  "dprnn_stack_kernel", "gru_recur_cluster_kernel", "gru_bidir_kernel",
                  "relayout_fm_kernel")


def kernel_launches(names) -> dict:
    """How many of the device events ``names`` ran each of the port's
    kernels (``KERNEL_SYMBOLS``); the kernels that did not run are left out."""
    counts = defaultdict(int)
    for name in names:
        hit = [s for s in KERNEL_SYMBOLS if re.search(rf"\b{s}\b", name)]
        if hit:
            counts[hit[0]] += 1
    return dict(counts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="dpdfnet8_48khz_hr")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--stream", action="store_true",
                    help="profile exact streaming, one process_frames call per hop")
    ap.add_argument("--hops", type=int, default=20)
    ap.add_argument("--stack", action="store_true",
                    help="build the engine with DPDFNET_TPU_STACK=1")
    ap.add_argument("--quality", default="high", choices=("highest", "high", "fast", "turbo"),
                    help="quality tier (engine_from_quality)")
    ap.add_argument("--v2", action="store_true",
                    help="build the engine with DPDFNET_TPU_PALLAS_V2=1")
    ap.add_argument("--fm", choices=("on", "off"), default=None,
                    help="set DPDFNET_TPU_INTRA_TM (the freq-major DPRNN chain)")
    ap.add_argument("--relayout", action="store_true",
                    help="set DPDFNET_TPU_ENTRY_RELAYOUT=1 (the chain's entry relayout kernel)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    torch.set_grad_enabled(False)
    if args.stack:
        os.environ["DPDFNET_TPU_STACK"] = "1"
    if args.v2:
        os.environ["DPDFNET_TPU_PALLAS_V2"] = "1"
    if args.fm is not None:
        os.environ["DPDFNET_TPU_INTRA_TM"] = "1" if args.fm == "on" else "0"
    if args.relayout:
        os.environ["DPDFNET_TPU_ENTRY_RELAYOUT"] = "1"
    from torch.profiler import ProfilerActivity, profile

    from ..config import get_config
    from ..models.params import contract_params, init_params
    from ..ops import gru_kernels
    from .engine import engine_from_quality

    cfg = get_config(args.model)
    eng = engine_from_quality(cfg, contract_params(init_params(cfg, seed=0, device="cuda")),
                              args.quality)
    rng = np.random.default_rng(0)
    if args.stream:
        frames = (0.1 * rng.standard_normal(
            (args.batch, args.hops + 8, cfg.win_len))).astype(np.float32)
        st = eng.init_stream_state(batch=args.batch)
        for i in range(8):
            _, st = eng.process_frames(frames[:, i:i + 1], st)

        def run():
            nonlocal st
            for i in range(8, 8 + args.hops):
                _, st = eng.process_frames(frames[:, i:i + 1], st)
    else:
        wavs = (0.1 * rng.standard_normal(
            (args.batch, int(args.seconds * cfg.sample_rate)))).astype(np.float32)

        def run():
            eng.enhance_waveforms(wavs)

        run()
    torch.cuda.synchronize()
    gru_kernels.reset_launch_counts()
    replays = eng.graph_replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = gru_kernels.launch_counts()
    replays = eng.graph_replays - replays

    per_kernel = defaultdict(float)
    device_names = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] += ev.device_time_total / 1e3
            device_names.append(ev.name)
    n_device_ops = len(device_names)
    fams = defaultdict(float)
    for name, ms in per_kernel.items():
        fams[family(name)] += ms
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    span = ({"mode": "stream-exact", "hops": args.hops, "ms_per_hop": wall_ms / args.hops}
            if args.stream else {"mode": "offline", "seconds": args.seconds})
    print(json.dumps({
        "model": args.model, "batch": args.batch, **span, "stack": args.stack,
        "quality": args.quality, "v2": args.v2,
        "fm": gru_kernels.intra_tm_enabled(),
        "relayout": args.relayout,
        "card": smi, "wall_ms_profiled": wall_ms, "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms, "launches": launches,
        "graph_replays": replays, "kernel_launches": kernel_launches(device_names),
        "device_ops": n_device_ops,
        "family_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[n[:90], ms] for n, ms in top],
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
