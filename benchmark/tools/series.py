#!/usr/bin/env python3
"""Run cells of the benchmark one after another, each run a process of its
own, as a benchmark run is, and keep every result.

    python3 benchmark/tools/series.py --out runs/series.jsonl \
        hr8.offline:101:20:0 hr8.offline:102:20:1 ...

Each argument is ``workload:seed:seconds:trace``.  Appends one JSON line
per run to ``--out``: the run's arguments, its exit code, wall seconds,
the result line (or null) and the end of its standard error.  Prints the
card's name and power limit first, and a one-line summary per run;
``--stop`` ends the series at the first run that fails or is not correct.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1300.0)
    ap.add_argument("--stop", action="store_true",
                    help="stop at the first run that fails or is not correct")
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print("card:", smi.replace("\n", " | "), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rc_all = 0
    for item in args.runs:
        w, seed, secs, tr = item.split(":")
        cmd = [sys.executable, "benchmark/run.py", "--workload", w, "--seed", seed,
               "--seconds", secs, "--trace", tr]
        t = time.perf_counter()
        try:
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=args.timeout)
            rc, so, se = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as exc:
            rc, so, se = 124, exc.stdout or "", exc.stderr or ""
            so = so.decode() if isinstance(so, bytes) else so
            se = se.decode() if isinstance(se, bytes) else se
        wall = time.perf_counter() - t
        lines = so.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            res = None
        rec = {"workload": w, "seed": int(seed), "seconds": float(secs), "trace": int(tr),
               "rc": rc, "wall_s": wall, "card": smi, "result": res, "stderr": se[-3000:]}
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        m = {k: v["value"] for k, v in (res or {}).get("metrics", {}).items()}
        print(f"{w} seed={seed} trace={tr} rc={rc} wall={wall:.1f}s "
              f"correct={None if res is None else res['correct']} {json.dumps(m)} "
              f"check={json.dumps((res or {}).get('check'))}", flush=True)
        if res is None:
            print(se[-1500:], flush=True)
        rc_all = rc_all or rc
        if args.stop and (rc != 0 or res is None or not res["correct"]):
            print("stopping: that run failed", flush=True)
            return rc_all or 1
    return rc_all


if __name__ == "__main__":
    raise SystemExit(main())
