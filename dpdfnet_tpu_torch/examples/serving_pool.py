"""Serving example: many concurrent real-time streams on one card
(counterpart of the repository's ``examples/serving_pool.py``).

    python -m dpdfnet_tpu_torch.examples.serving_pool [--model dpdfnet2]
        [--streams 16] [--seconds 2] [--mode exact|throughput]
        [--hops-per-call H] [--device cuda|cpu]

Simulates ``--streams`` live connections sending 10 ms chunks (H hops per
call) into one ``MultiStreamEnhancer`` on random weights (``init_params``,
seed 0; the time does not depend on their values) and prints the
per-call latency, median and 99th percentile after two warm-up calls,
against the real-time budget of H hops.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="dpdfnet2")
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--mode", default="exact", choices=["exact", "throughput"],
                    help="'exact': the bit-invariant per-frame program; 'throughput': "
                         "time-vectorised (pair with --hops-per-call > 1)")
    ap.add_argument("--hops-per-call", type=int, default=1, metavar="H",
                    help="hops of audio buffered per process_many call (adds H x 10 ms "
                         "of latency)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..config import get_config
    from ..models.params import init_params
    from ..runtime.engine import Engine
    from ..serving import MultiStreamEnhancer
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = get_config(args.model)
    engine = Engine(cfg, init_params(cfg, seed=0, device=dev), device=dev)
    pool = MultiStreamEnhancer(capacity=args.streams, engine=engine, mode=args.mode)
    sids = [pool.open() for _ in range(args.streams)]

    sr, hop = cfg.sample_rate, cfg.hop
    h = max(1, args.hops_per_call)
    rng = np.random.default_rng(0)
    n_calls = max(3, int(args.seconds * sr / hop) // h)
    budget_ms = 1000.0 * hop * h / sr
    lat = []
    for _ in range(n_calls):
        chunks = {sid: (0.1 * rng.normal(size=hop * h)).astype(np.float32) for sid in sids}
        t0 = time.perf_counter()
        pool.process_many(chunks)
        lat.append((time.perf_counter() - t0) * 1e3)
    for sid in sids:
        pool.flush(sid)
        pool.close(sid)
    lat = np.asarray(lat[2:])                         # the first two warm up
    print(f"{args.streams} streams on {dev}: call latency p50 {np.median(lat):.2f} ms "
          f"p99 {np.quantile(lat, 0.99):.2f} ms (budget {budget_ms:.1f} ms for {h} hops)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
