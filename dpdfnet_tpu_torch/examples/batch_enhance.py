"""Bulk enhancement of a directory in device batches (counterpart of the
repository's ``examples/batch_enhance.py``).

    python -m dpdfnet_tpu_torch.examples.batch_enhance in_dir/ out_dir/
        [--model dpdfnet8_48khz_hr] [--batch-size 64] [--quality high]
        [--attn-limit-db DB] [--random-weights] [--device cuda|cpu]

Reads every supported audio file, resamples it to the model rate, sorts
the utterances by length so each batch pads little, and runs them
through ``Engine.enhance_waveforms`` with their ``lengths``; writes
one 16-bit wav per input.  The weights come from the zoo by model name,
or are random (``init_params``, seed 0) with ``--random-weights``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("in_dir", type=Path)
    ap.add_argument("out_dir", type=Path)
    ap.add_argument("--model", default="dpdfnet8_48khz_hr")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--quality", default="high", choices=["highest", "high", "fast", "turbo"])
    ap.add_argument("--attn-limit-db", type=float, default=None)
    ap.add_argument("--random-weights", action="store_true",
                    help="random weights (seed 0) instead of the zoo's")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..audio import ensure_sample_rate, to_mono
    from ..audio_io import SUPPORTED_EXTENSIONS, read_audio, write_wav
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.random_weights:
        from ..config import get_config
        from ..models.params import init_params
        from ..runtime.engine import engine_from_quality

        cfg = get_config(args.model)
        engine = engine_from_quality(cfg, init_params(cfg, seed=0, device=dev), args.quality,
                                     device=dev)
    else:
        from ..api import _get_engine

        engine = _get_engine(args.model, quality=args.quality, device=dev)
    cfg = engine.cfg

    files = sorted(p for p in args.in_dir.iterdir() if p.suffix.lower() in SUPPORTED_EXTENSIONS)
    if not files:
        print(f"no audio files under {args.in_dir}", file=sys.stderr)
        return 1
    args.out_dir.mkdir(parents=True, exist_ok=True)
    loaded = []
    for p in files:
        audio, sr = read_audio(p)
        loaded.append((p, ensure_sample_rate(to_mono(audio), sr, cfg.sample_rate)))
    loaded.sort(key=lambda t: len(t[1]))

    t0 = time.perf_counter()
    total_s = 0.0
    for i in range(0, len(loaded), args.batch_size):
        chunk = loaded[i: i + args.batch_size]
        lengths = np.array([len(w) for _, w in chunk])
        batch = np.zeros((len(chunk), int(lengths.max())), np.float32)
        for j, (_, w) in enumerate(chunk):
            batch[j, : len(w)] = w
        outs = engine.enhance_waveforms(batch, args.attn_limit_db, lengths=lengths)
        for (p, _), out, n in zip(chunk, np.atleast_2d(outs), lengths):
            write_wav(args.out_dir / (p.stem + ".wav"), out[:n], cfg.sample_rate)
        total_s += float(lengths.sum()) / cfg.sample_rate
    wall = time.perf_counter() - t0
    print(f"[OK] {len(files)} files, {total_s:.1f} s audio in {wall:.2f} s "
          f"-> {total_s / wall:.0f}x real-time on {dev}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
