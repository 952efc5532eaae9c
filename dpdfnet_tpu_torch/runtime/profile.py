"""Where the offline engine's device time goes, per kernel family.

    python3 -m dpdfnet_tpu_torch.runtime.profile [--model M] [--batch B] [--seconds S]

Runs ``Engine.enhance_waveforms`` once as a warm-up, then once under
``torch.profiler`` (CPU + CUDA activities), and prints one JSON object:
the call's wall ms, the summed device ms per kernel family (the port's
three CUDA kernels, convolutions, GEMMs, everything else), the device's
busy share of the wall time, and the top kernels by device time.  Needs a
CUDA device; random contracted weights (``init_params`` +
``contract_params``, seed 0), float32 with TF32 off.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

FAMILIES = (
    ("dprnn_intra", ("dprnn_intra",)),
    ("dprnn_inter", ("dprnn_inter",)),
    ("gru_scan", ("gru_proj", "gru_recur")),
    ("conv", ("conv", "cudnn", "implicit_convolve", "winograd", "fft2d", "xmma_fprop")),
    ("gemm", ("gemm", "sgemm", "cutlass", "cublas", "matmul", "splitk")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="dpdfnet8_48khz_hr")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    torch.set_grad_enabled(False)
    from torch.profiler import ProfilerActivity, profile

    from ..config import get_config
    from ..models.params import contract_params, init_params
    from .engine import Engine

    cfg = get_config(args.model)
    eng = Engine(cfg, contract_params(init_params(cfg, seed=0, device="cuda")))
    rng = np.random.default_rng(0)
    wavs = (0.1 * rng.standard_normal(
        (args.batch, int(args.seconds * cfg.sample_rate)))).astype(np.float32)
    eng.enhance_waveforms(wavs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.enhance_waveforms(wavs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    per_kernel = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] += ev.device_time_total / 1e3
    fams = defaultdict(float)
    for name, ms in per_kernel.items():
        fams[family(name)] += ms
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({
        "model": args.model, "batch": args.batch, "seconds": args.seconds,
        "card": smi, "wall_ms_profiled": wall_ms, "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms,
        "family_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[n[:90], ms] for n, ms in top],
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
