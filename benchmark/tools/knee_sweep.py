#!/usr/bin/env python3
"""Find a live mix's knee: the most streams the card serves at real time.

    python3 benchmark/tools/knee_sweep.py --config dpdfnet8_48khz_hr \
        --streams 64,128,192,256 [--seconds 6] [--seed 7] [--base live_n112]

One engine of the configuration on one card; for each stream count, a
pool of that capacity driven by the driver of ``kinds/live.py`` with the
base mix's parameters at that count (warm-up, then ``--seconds`` of the
open loop).  Prints one JSON line per count: ``hop_ms`` p50 / p95 / max,
the most hops one call had to catch up (``backlog_max_hops``), and the
mean lateness over the window's first and last fifths, whose growth
marks a backlog.  The knee is the largest count whose p95 stays under
the hop (10 ms) with no growing backlog; a cell runs at 4/5 of it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import benchmark.run as run  # noqa: E402  (sets the build directory)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--streams", required=True, help="comma-separated stream counts")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--base", default="live_n112", help="the live mix whose parameters to use")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from benchmark.harness import weights
    from benchmark.harness.spans import Spans
    from benchmark.harness.cells import Spec
    from dpdfnet_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("knee_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    _build.build(run.LIBRARIES)
    spec = Spec(ROOT)
    cfg_doc = spec.config(args.config)
    dev = torch.device("cuda", 0)
    engine = run.build_engine(cfg_doc, weights.make(cfg_doc, args.seed, dev), [dev])
    card = torch.cuda.get_device_name(0)
    live = spec.kind("live")
    for n in (int(s) for s in args.streams.split(",")):
        mix = dict(spec.traffic(args.base), streams=n)
        inputs = live.generate(mix, cfg_doc, args.seed, dev)
        driver = live.Driver(engine, inputs, Spans())
        t = time.perf_counter()
        driver.warmup()
        warm = time.perf_counter() - t
        driver.window(args.seconds)
        lat = np.asarray(driver.lat) * 1e3
        fifth = max(1, len(lat) // 5)
        print(json.dumps({
            "config": args.config, "streams": n, "seconds": args.seconds, "card": card,
            "hops": int(len(lat)), "calls": len(driver.log),
            "hop_ms.p50": float(np.percentile(lat, 50)),
            "hop_ms.p95": float(np.percentile(lat, 95)), "hop_ms.max": float(lat.max()),
            "late_first_fifth_ms": float(lat[:fifth].mean()),
            "late_last_fifth_ms": float(lat[-fifth:].mean()),
            "backlog_max_hops": driver.backlog_max, "warmup_s": warm,
            "pool_host_ms": 1e3 * sum(c["t1"] - c["t0"] - c["engine_s"]
                                      for c in driver.log) / len(driver.log),
            "engine_ms": 1e3 * sum(c["engine_s"] for c in driver.log) / len(driver.log),
        }), flush=True)
        driver.release()
        del driver
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
