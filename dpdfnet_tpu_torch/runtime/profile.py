"""Where the engine's device time goes, per kernel family.

    python3 -m dpdfnet_tpu_torch.runtime.profile [--model M] [--batch B] [--seconds S]
    python3 -m dpdfnet_tpu_torch.runtime.profile --stream [--batch B] [--hops N] [--stack]
    ... [--quality highest|high|fast|turbo] [--v2]

Offline (default): runs ``Engine.enhance_waveforms`` once as a warm-up,
then once under ``torch.profiler``.  ``--stream``: exact streaming of
``--batch`` streams, one ``process_frames`` call per hop as a real-time
server makes them, through the engine's captured CUDA graph; 8 warm-up
hops, then ``--hops`` hops under the profiler.  ``--stack`` sets
``DPDFNET_TPU_STACK=1`` (the DPRNN stack kernel) before the engine is built; ``--quality`` picks the tier
(``engine_from_quality``, default ``high``) and ``--v2`` sets
``DPDFNET_TPU_PALLAS_V2=1`` (the inter v2 kernel under ``fast`` /
``turbo``).

Prints one JSON object: the wall ms of the profiled run (and ms per hop
when streaming), the summed device ms per kernel family (the port's CUDA
kernels, convolutions, GEMMs, FFTs, everything else), the device's busy
time (the union of its operations' intervals, so that operations that
overlap count once) and its share of the wall time, the kernel launches
counted by the wrappers (launches they made themselves), the engine's
graph replays, the port's kernels the device ran by kernel symbol
(``kernel_launches``: the trace counts what a replayed graph launches),
the number of device operations (kernels and copies) the run made, and
the top kernels by device time.  From the program's own spans
(``runtime.telemetry``, which record while the profiler does): the host's
self ms per span (``host_ms``), the device's idle ms by the innermost
span the host was in at each idle gap's middle (``idle_ms``; ``outside
spans`` where none), the graphs captured (``captures``), the bytes
copied to and from the card and the offline row-segments run and in the
full rectangle (``counters``), and the share of those that ran
(``row_segment_share``; 1.0 here, where no call passes ``lengths``).  Needs a CUDA device; random
contracted weights (``init_params`` + ``contract_params``, seed 0); the
tier sets its own cuBLAS / cuDNN math mode for each engine call.
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


# the profiled run's own range, the window that busy and idle time cover
RUN = "profile.run"
OUTSIDE = "outside spans"


def _union(intervals):
    """The covered runs of ``intervals``, merged, in order."""
    runs = []
    for a, b in sorted(intervals):
        if runs and a <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], b)
        else:
            runs.append([a, b])
    return runs


def _is_op(ev, ranges) -> bool:
    """Whether ``ev`` is a device operation: on a card, and not the
    device's mirror of a host range."""
    return (ev.device_type == torch.autograd.DeviceType.CUDA and ev.name not in ranges
            and not getattr(ev, "is_user_annotation", False))


def device_view(events, span_names) -> dict:
    """From ``profile.events()``: each card's busy us (the union of its
    operations' intervals inside the host range ``RUN``) and the idle us,
    summed over the cards, by the innermost program span (``span_names``)
    open on the host at each idle gap's middle.  The device's mirrors of
    host ranges are not operations.  ``{"busy_us": {card: us}, "idle_us":
    {span: us}}``; empty without the ``RUN`` range."""
    ranges = set(span_names) | {RUN}
    window, host, ops = None, [], defaultdict(list)
    for ev in events:
        a, b = ev.time_range.start, ev.time_range.end
        if _is_op(ev, ranges):
            ops[int(ev.device_index)].append((a, b))
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            continue
        elif ev.name == RUN:
            window = (a, b)
        elif ev.name in span_names:
            host.append((a, b, ev.name))
    if window is None:
        return {"busy_us": {}, "idle_us": {}}
    w0, w1 = window
    busy, gaps = {}, []
    for card, ivs in sorted(ops.items()):
        runs = _union([(max(a, w0), min(b, w1)) for a, b in ivs if b > w0 and a < w1])
        busy[card] = sum(b - a for a, b in runs)
        edges = [w0] + [x for r in runs for x in r] + [w1]
        gaps += [(0.5 * (a + b), b - a) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps.sort()
    idle = defaultdict(float)
    for (_, us), name in zip(gaps, _innermost(sorted(host), [t for t, _ in gaps])):
        idle[name] += us
    return {"busy_us": busy, "idle_us": dict(idle)}


def _innermost(host, times) -> list:
    """For each of the ascending host ``times``, the program span around it
    that began last (spans nest, so the innermost), or ``OUTSIDE``;
    ``host`` holds ``(start, end, name)`` in order of start."""
    out, around, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            around.append(host[i])
            i += 1
        around = [h for h in around if h[1] >= t]
        out.append(around[-1][2] if around else OUTSIDE)
    return out


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    torch.set_grad_enabled(False)
    if args.stack:
        os.environ["DPDFNET_TPU_STACK"] = "1"
    if args.v2:
        os.environ["DPDFNET_TPU_PALLAS_V2"] = "1"
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..config import get_config
    from ..models.params import contract_params, init_params
    from ..ops import gru_kernels
    from . import telemetry
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
    telemetry.reset()
    replays = eng.graph_replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(RUN):
            run()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = gru_kernels.launch_counts()
    replays = eng.graph_replays - replays
    snap = telemetry.snapshot()
    telemetry.reset()
    events = prof.events()
    view = device_view(events, snap["spans"])

    per_kernel = defaultdict(float)
    device_names = []
    ranges = set(snap["spans"]) | {RUN}
    for ev in events:
        if _is_op(ev, ranges):
            per_kernel[ev.name] += ev.device_time_total / 1e3
            device_names.append(ev.name)
    n_device_ops = len(device_names)
    fams = defaultdict(float)
    for name, ms in per_kernel.items():
        fams[family(name)] += ms
    busy = sum(view["busy_us"].values()) / 1e3 / max(1, len(view["busy_us"]))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    span = ({"mode": "stream-exact", "hops": args.hops, "ms_per_hop": wall_ms / args.hops}
            if args.stream else {"mode": "offline", "seconds": args.seconds})
    print(json.dumps({
        "model": args.model, "batch": args.batch, **span, "stack": args.stack,
        "quality": args.quality, "v2": args.v2,
        "card": smi, "wall_ms_profiled": wall_ms, "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms, "launches": launches,
        "graph_replays": replays, "kernel_launches": kernel_launches(device_names),
        "device_ops": n_device_ops,
        "family_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[n[:90], ms] for n, ms in top],
        "host_ms": {n: row["self_ns"] / 1e6 for n, row in snap["spans"].items()},
        "idle_ms": {n: us / 1e3 for n, us in
                    sorted(view["idle_us"].items(), key=lambda kv: -kv[1])},
        "captures": snap["spans"].get("engine.capture", {}).get("count", 0),
        "counters": snap["counters"],
        "row_segment_share": (snap["counters"].get("engine.row_segments", 0)
                              / snap["counters"]["engine.row_segments_full"]
                              if snap["counters"].get("engine.row_segments_full") else None),
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
