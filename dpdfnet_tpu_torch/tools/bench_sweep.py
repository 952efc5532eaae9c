"""Sweep the offline benchmark over batch and segment length (counterpart
of the repository's ``tools/bench_sweep.py``).

    python -m dpdfnet_tpu_torch.tools.bench_sweep [--model dpdfnet8_48khz_hr]
        --points b32:s112 b64:s112 b64:s224 [--precision high|turbo|...]
        [--seconds 10] [--reps 5] [--device cuda|cpu]

A point is ``b<batch>:s<segment frames>``.  Each point is one
``runtime.bench.run_bench`` call, the harness of ``python -m
dpdfnet_tpu_torch bench`` (tier names, warm-up, median of ``--reps``
calls), so a sweep's numbers compare directly with the bench lines.
Prints one JSON line per point.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Tuple


def parse_point(point: str) -> Tuple[int, int]:
    """``b<batch>:s<segment frames>`` -> (batch, segment frames)."""
    batch = seg = None
    for tok in point.split(":"):
        if tok[:1] == "b" and tok[1:].isdigit():
            batch = int(tok[1:])
        elif tok[:1] == "s" and tok[1:].isdigit():
            seg = int(tok[1:])
        else:
            raise ValueError(f"point {point!r}: unknown token {tok!r}")
    if not batch or not seg:
        raise ValueError(f"point {point!r} needs b<batch> and s<segment frames>")
    return batch, seg


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="dpdfnet8_48khz_hr")
    ap.add_argument("--points", nargs="+", default=["b64:s112"])
    ap.add_argument("--precision", default="high",
                    help="a quality tier (highest/high/fast/turbo) or a matmul precision")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..runtime.bench import run_bench

    points = [(p, parse_point(p)) for p in args.points]
    for point, (batch, seg) in points:
        result = json.loads(run_bench(model=args.model, batch=batch, seconds=args.seconds,
                                      reps=args.reps, precision=args.precision,
                                      seg_frames=seg, device=args.device))
        print(json.dumps({"point": point, "model": args.model, "precision": args.precision,
                          "xrt": result["value"], "device": result["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
