"""Precision-tier accuracy table, the air-gapped quality gate (counterpart
of the repository's ``tools/tier_accuracy.py``).

Each tier's output deviation from the ``highest`` tier on speech-shaped
input (``quality.tier_deviation``), in both weight regimes:

- contractive weights (spectral norm <= ``--contract`` per layer), the
  stable, non-amplifying dynamics of a trained checkpoint;
- raw random weights, the adversarial case.

    python -m dpdfnet_tpu_torch.tools.tier_accuracy [--model dpdfnet8_48khz_hr]
        [--seconds 4] [--batch 2] [--contract 0.7] [--seed 0] [--json]
        [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given; the CPU's numbers are
no card figure (``fast`` falls back to float32 there, ``turbo`` keeps its
bfloat16 activations).
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

REGIMES = ("contractive", "raw")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="dpdfnet8_48khz_hr")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--contract", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..quality import tier_deviation
    from ..runtime.bench import _device_name
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    results = {regime: tier_deviation(args.model, seconds=args.seconds, batch=args.batch,
                                      seed=args.seed, device=dev,
                                      contract=args.contract if regime == "contractive" else None)
               for regime in REGIMES}
    if args.json:
        print(json.dumps({"model": args.model, "device": _device_name(dev),
                          "seconds": args.seconds, "batch": args.batch,
                          "contract": args.contract, "results": results}))
        return 0
    print(f"model={args.model} device={_device_name(dev)} "
          f"({args.seconds}s x b{args.batch}, contract={args.contract})")
    print(f"{'tier':8} {'regime':12} {'rel_rms_dev':>12} {'max_abs_dev':>12} "
          f"{'vs_input_db':>12} {'stoi':>7} {'sisnr_db':>9}")
    for regime, tiers in results.items():
        for tier, d in tiers.items():
            if tier.startswith("_"):
                continue
            print(f"{tier:8} {regime:12} {d['rel_rms']:>12.3e} {d['max_abs']:>12.3e} "
                  f"{d['rms_vs_input_db']:>12.1f} {d['stoi_vs_highest']:>7.4f} "
                  f"{d['sisnr_vs_highest_db']:>9.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
