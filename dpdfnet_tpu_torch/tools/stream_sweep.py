"""Sweep the streaming benchmark over mode, streams, hops per call and tier
(counterpart of the repository's ``tools/stream_sweep.py``).

    python -m dpdfnet_tpu_torch.tools.stream_sweep [--model dpdfnet8_48khz_hr]
        --points exact:s64:high exact:s128:turbo thr:s256:h4:turbo
        [--seconds 2] [--device cuda|cpu]

Point grammar: ``<mode>:s<streams>[:h<hops per call>]:<tier>``, mode
``exact`` or ``thr`` (throughput).  Each point is one
``runtime.bench.run_stream_bench`` call; prints its JSON line per point
with the point added.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def parse_point(point: str) -> dict:
    """The point grammar above -> ``run_stream_bench`` arguments."""
    out = {"mode": "exact", "streams": 64, "hops_per_call": 0, "precision": "high"}
    for tok in point.split(":"):
        if tok in ("exact", "thr", "throughput"):
            out["mode"] = "exact" if tok == "exact" else "throughput"
        elif tok[:1] == "s" and tok[1:].isdigit():
            out["streams"] = int(tok[1:])
        elif tok[:1] == "h" and tok[1:].isdigit():
            out["hops_per_call"] = int(tok[1:])
        else:
            out["precision"] = tok
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="dpdfnet8_48khz_hr")
    ap.add_argument("--points", nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..runtime.bench import run_stream_bench

    for point in args.points:
        result = json.loads(run_stream_bench(model=args.model, seconds=args.seconds,
                                             device=args.device, **parse_point(point)))
        result["point"] = point
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
