"""Quality validation against the reference ONNX runtime (counterpart of the
repository's ``tools/validate_quality.py``; a thin wrapper of
``quality.validate_vs_onnx``, also ``python -m dpdfnet_tpu_torch eval
--vs-onnx``): the BASELINE.md gate, PESQ delta <= 0.01 against the
reference on a noisy / clean corpus.

    python -m dpdfnet_tpu_torch.tools.validate_quality corpus.csv \\
        --onnx /path/to/dpdfnet8_48khz_hr.onnx [--model dpdfnet8_48khz_hr] \\
        [--out results.csv] [--pesq-tolerance 0.01] [--device cuda|cpu]

Needs this package's weights for ``--model`` (``dpdfnet-tpu-torch
download``), the reference's ``.onnx`` graph, ``onnxruntime`` and, for the
verdict, ``pesq``, and a CSV with ``noisy_path,clean_path`` columns (for
example the DPDFNet_EvalSet).  Runs this package's arm on the card unless
``--device cpu`` is given.  Exit code: 0 pass, 1 fail.

For the air-gapped substitute gate (precision-tier deviation on
contractive weights) see ``tools/tier_accuracy.py``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csv")
    ap.add_argument("--model", default="dpdfnet8_48khz_hr")
    ap.add_argument("--onnx", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--pesq-tolerance", type=float, default=0.01)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..quality import validate_vs_onnx

    return validate_vs_onnx(
        args.csv, args.onnx, model=args.model, out_csv=args.out,
        pesq_tolerance=args.pesq_tolerance, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
