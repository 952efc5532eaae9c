#!/usr/bin/env python3
"""The control of ``correct``: the reference in the program's place, in the
next precision below the configuration's (TF32 matmuls and convolutions
for float32 with TF32 off), at the cell's own size.

    python3 benchmark/tools/control.py --workload hr8.offline --seeds 1,2,3 [--seconds 20]

For each seed: the weights and the mix of a run of that seed; the answers
a window of ``--seconds`` compares (the kind's ``planned``: offline, the
compared rows of every batch; live, the compared streams over the
warm-up's and the window's hops), computed by the reference with TF32 on and held against
the reference with TF32 off by the numbers of ``harness/check.py``.
Prints one JSON line per seed; a limit must fail every one of them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import benchmark.run  # noqa: E402,F401  (sets the build directory)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window a live run measures (default: BENCHMARK.json's run_seconds)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import check, weights
    from benchmark.harness.cells import Spec

    torch.set_grad_enabled(False)
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    cfg_doc = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    kind = spec.kind(mix["kind"])
    seconds = args.seconds if args.seconds is not None else spec.doc["run_seconds"]
    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        params = weights.make(cfg_doc, seed, dev)
        inputs = kind.generate(mix, cfg_doc, seed, dev)
        due = kind.planned(inputs, seconds)
        want = kind.references(params, cfg_doc, inputs, due, dev)
        got = kind.references(params, cfg_doc, inputs, due, dev, tf32=True)
        nums = check.numbers(got, want)
        ok, table = check.verdict(nums, spec.limits(cell["name"]))
        print(json.dumps({"workload": cell["name"], "seed": seed, "control": "tf32",
                          "numbers": nums, "passes_limits": ok,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
