"""Command-line interface (counterpart of ``dpdfnet_tpu.cli``): models /
enhance / enhance-dir / download / bench / eval / demo.

    python -m dpdfnet_tpu_torch enhance in.wav out.wav --model dpdfnet8_48khz_hr
    python -m dpdfnet_tpu_torch bench [--streaming | --serving] [--device cuda]

The subcommands, flags, exit codes and model table are the JAX CLI's,
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
``enhance-dir`` groups utterances into padded batches, one engine call per
batch from the main thread; ``--workers`` threads decode and encode files
only.  ``enhance-dir --distributed`` (a ``torch.distributed`` process
group, e.g. under ``torchrun``) or ``--num-hosts N --host-id K`` processes
only this host's shard of the file list (``parallel/multihost.py``).
``eval --vs-onnx model.onnx`` runs the reference-ONNX quality gate
(``quality.validate_vs_onnx``; ``--device`` runs this package's arm).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

from . import __version__
from .banner import print_banner
from .zoo import DEFAULT_MODEL, get_cache_model_dir, get_model_info, supported_models


def _add_model_resolution_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--model", default=DEFAULT_MODEL, choices=supported_models(),
        help="Model name to run.")
    parser.add_argument(
        "-v", "--verbose", action="store_true",
        help="Enable verbose model-resolution/download logs.")
    _add_device_arg(parser)


def _add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="Torch device to run on (default: cuda; 'cpu' runs the plain "
             "PyTorch path).")


def _add_quality_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--quality", default="high",
        choices=["highest", "high", "fast", "turbo"],
        help="Speed/precision tier: highest/high are float32, fast runs "
             "TF32 GEMMs and convs, turbo bfloat16 activations.")


def _add_attn_limit_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--attn-limit-db", "--attn_limit_db", dest="attn_limit_db",
        type=float, default=None,
        help="Offline-only attenuation limit in dB. Higher values allow "
             "stronger denoising.")


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m dpdfnet_tpu_torch",
        description="DPDFNet speech enhancement toolkit (PyTorch + CUDA).")
    parser.add_argument("--version", action="version",
                        version=f"dpdfnet_tpu_torch {__version__}")
    sub = parser.add_subparsers(dest="command")

    sub.add_parser("models", help="List supported models and local availability.")

    p_enh = sub.add_parser("enhance", help="Enhance a single audio file.")
    p_enh.add_argument("input", type=Path, help="Input audio file (.wav, ...).")
    p_enh.add_argument("output", type=Path, help="Output wav file path.")
    _add_attn_limit_arg(p_enh)
    _add_quality_arg(p_enh)
    _add_model_resolution_args(p_enh)

    p_dir = sub.add_parser(
        "enhance-dir",
        help="Enhance all supported audio files from one directory "
             "(non-recursive), batched on the device.")
    p_dir.add_argument("input_dir", type=Path)
    p_dir.add_argument("output_dir", type=Path)
    p_dir.add_argument(
        "--workers", type=int, default=None, metavar="N",
        help="Parallel file-IO workers (default: CPU count).")
    p_dir.add_argument(
        "--batch-size", type=int, default=8, metavar="B",
        help="Utterances per device batch (default: 8).")
    p_dir.add_argument(
        "--distributed", action="store_true",
        help="Multi-host mode: bring up torch.distributed (torchrun's "
             "MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK) and process only "
             "this host's deterministic shard of the file list.")
    p_dir.add_argument(
        "--num-hosts", type=int, default=None, metavar="N",
        help="Manual multi-machine fan-out without torch.distributed: total "
             "hosts (same file shards as --distributed).")
    p_dir.add_argument(
        "--host-id", type=int, default=None, metavar="K",
        help="This host's index in 0..N-1 for --num-hosts.")
    _add_attn_limit_arg(p_dir)
    _add_quality_arg(p_dir)
    _add_model_resolution_args(p_dir)

    p_dl = sub.add_parser(
        "download",
        help="Download all models by default, or a single model if provided.")
    p_dl.add_argument("model", nargs="?", choices=supported_models(), default=None)
    p_dl.add_argument("--model", dest="model_flag", choices=supported_models(),
                      default=None, help=argparse.SUPPRESS)
    p_dl.add_argument("--force", "--refresh", action="store_true",
                      help="Force re-download even if files are already cached.")
    g = p_dl.add_mutually_exclusive_group()
    g.add_argument("-q", "--quiet", action="store_true")
    g.add_argument("-v", "--verbose", action="store_true")

    p_eval = sub.add_parser(
        "eval",
        help="Score enhanced vs clean audio (SI-SNR/STOI/WB-PESQ) from a CSV "
             "with enhanced_path,clean_path columns.")
    p_eval.add_argument("csv", type=Path)
    p_eval.add_argument("--out", default=None,
                        help="Output CSV (default: results.csv next to input)")
    p_eval.add_argument(
        "--vs-onnx", type=Path, default=None, metavar="ONNX",
        help="Run the BASELINE quality gate instead: enhance the corpus with "
             "this package AND the reference's exported .onnx graph "
             "(requires onnxruntime), score both vs clean, and fail if "
             "|PESQ delta| exceeds --pesq-tolerance.  The CSV must have "
             "noisy_path,clean_path columns.")
    p_eval.add_argument("--pesq-tolerance", type=float, default=0.01)
    p_eval.add_argument("--model", default="dpdfnet8_48khz_hr",
                        choices=supported_models(),
                        help="Model to evaluate with --vs-onnx.")
    _add_device_arg(p_eval)

    p_demo = sub.add_parser(
        "demo",
        help="Stream a file (or microphone, if sounddevice is installed) "
             "through the real-time enhancer.")
    p_demo.add_argument("--input", type=Path, default=None,
                        help="Input wav to stream; omit for live microphone.")
    p_demo.add_argument("--output", type=Path, default=None,
                        help="Optional output wav for the enhanced stream.")
    p_demo.add_argument("--mix", type=float, default=1.0,
                        help="Dry/wet mix: 0 = passthrough noisy, 1 = enhanced.")
    p_demo.add_argument("--chunk-ms", type=float, default=10.0,
                        help="Streaming chunk size in milliseconds.")
    p_demo.add_argument("--spectrogram", action="store_true",
                        help="Render scrolling noisy|enhanced spectrograms "
                             "as ANSI text.")
    _add_model_resolution_args(p_demo)

    p_bench = sub.add_parser("bench", help="Measure offline throughput (xRT).")
    p_bench.add_argument("--model", default="dpdfnet8_48khz_hr",
                         choices=supported_models())
    # defaults: the card cell of PERF.md, B=64 utterances of 4 s
    p_bench.add_argument("--batch", type=int, default=64,
                         help="Utterance batch (default: 64).")
    p_bench.add_argument("--seconds", type=float, default=4.0,
                         help="Seconds per utterance (offline; default: 4).")
    p_bench.add_argument("--reps", type=int, default=5)
    p_bench.add_argument("--precision", default="turbo",
                         choices=["default", "high", "highest",
                                  "fast", "turbo"],
                         help="Matmul precision or quality-tier name "
                              "(fast/turbo map through QUALITY_TIERS).")
    p_bench.add_argument("--random-weights", action="store_true",
                         help="Use random weights (seed 0, no download); "
                              "--streaming and --serving always do.")
    p_bench.add_argument("--streaming", action="store_true",
                         help="Benchmark streaming hop latency / capacity "
                              "instead of offline throughput.")
    p_bench.add_argument("--streams", type=int, default=64,
                         help="Concurrent streams for --streaming/--serving.")
    p_bench.add_argument("--serving", action="store_true",
                         help="Benchmark the full serving layer "
                              "(MultiStreamEnhancer.process_many: state "
                              "gather/scatter + dispatch + OLA) instead of "
                              "the bare streaming program.")
    p_bench.add_argument("--hops-per-call", type=int, default=None,
                         help="Hops of audio per call (default: 2 for "
                              "--serving, 1 for --streaming).")
    p_bench.add_argument("--mode", default="exact",
                         choices=["exact", "throughput"],
                         help="Streaming mode: 'exact' (bit-invariant "
                              "per-frame program) or 'throughput' "
                              "(power-of-two frame buckets).")
    p_bench.add_argument("--profile", type=Path, default=None, metavar="DIR",
                         help="Write a torch.profiler Chrome trace of the "
                              "benchmark into DIR (chrome://tracing, Perfetto).")
    _add_device_arg(p_bench)

    return parser


def _print_model_table() -> int:
    from .api import available_models

    rows = available_models()
    headers = ["Model", "Sample Rate", "Ready", "Cached", "Description"]
    col_keys = ["name", "sample_rate", "ready", "cached", "description"]

    def fmt(row: dict, key: str) -> str:
        v = row[key]
        if key == "sample_rate":
            return f"{v // 1000} kHz"
        if isinstance(v, bool):
            return "yes" if v else "no"
        return str(v)

    table = [[fmt(r, k) for k in col_keys] for r in rows]
    widths = [max(len(h), *(len(r[i]) for r in table)) for i, h in enumerate(headers)]
    sep = "+-" + "-+-".join("-" * w for w in widths) + "-+"
    print(f"\n  Cache dir: {get_cache_model_dir().resolve()}\n")
    print(sep)
    print("| " + " | ".join(h.ljust(widths[i]) for i, h in enumerate(headers)) + " |")
    print(sep)
    for r in table:
        print("| " + " | ".join(r[i].ljust(widths[i]) for i in range(len(headers))) + " |")
    print(sep)
    print()
    return 0


def _banner(args: argparse.Namespace) -> None:
    info = get_model_info(args.model)
    print_banner(model_name=info.name, sample_rate=info.sample_rate,
                 description=info.description, version=__version__,
                 device=args.device)


def _run_enhance(args: argparse.Namespace) -> int:
    from . import api

    _banner(args)
    t0 = time.perf_counter()
    out = api.enhance_file(
        input_path=args.input, output_path=args.output, model=args.model,
        attn_limit_db=args.attn_limit_db, quality=args.quality,
        verbose=args.verbose, device=args.device)
    dt = time.perf_counter() - t0
    print(f"Wrote enhanced audio: {out}  ({dt:.2f}s)")
    return 0


def _run_enhance_dir(args: argparse.Namespace) -> int:
    from .api import enhance_batch
    from .audio import pcm16_safe
    from .audio_io import SUPPORTED_EXTENSIONS, write_wav

    _banner(args)

    input_dir = Path(args.input_dir).expanduser().resolve()
    output_dir = Path(args.output_dir).expanduser().resolve()
    if not input_dir.is_dir():
        raise FileNotFoundError(f"Input directory not found: {input_dir}")
    audio_files = sorted(
        (p for p in input_dir.iterdir()
         if p.is_file() and p.suffix.lower() in SUPPORTED_EXTENSIONS),
        key=lambda p: (p.stat().st_size, p.name))
    # size-sorted so each device batch groups similar durations (less padding)
    if not audio_files:
        supported = ", ".join(sorted(SUPPORTED_EXTENSIONS))
        raise FileNotFoundError(
            f"No supported audio files found in {input_dir}\n"
            f"Supported extensions: {supported}")

    # multi-host: only this host's shard of the (identically sorted) list
    if args.distributed or args.num_hosts is not None \
            or "DPDFNET_TPU_NUM_HOSTS" in os.environ:
        from .parallel import multihost

        if args.distributed:
            multihost.initialize()
        n_all = len(audio_files)
        audio_files = multihost.shard_files_for_host(
            audio_files, host_id=args.host_id, num_hosts=args.num_hosts)
        hid, nh = multihost.host_info(args.host_id, args.num_hosts)
        print(f"[INFO] host {hid}/{nh}: processing {len(audio_files)} of "
              f"{n_all} files")
        if not audio_files:
            return 0

    output_dir.mkdir(parents=True, exist_ok=True)
    B = max(1, args.batch_size)
    n_workers = (max(1, args.workers) if args.workers is not None
                 else (os.cpu_count() or 4))
    errors: List[tuple] = []
    t0 = time.perf_counter()
    total_audio_s = 0.0

    # Output names: '<stem>_enhanced.wav'; when two inputs share a stem
    # (a.wav + a.flac) keep the source extension in the name so they don't
    # silently overwrite each other.
    stem_counts: Dict[str, int] = {}
    for p in audio_files:
        stem_counts[p.stem] = stem_counts.get(p.stem, 0) + 1
    dests = {
        p: output_dir / (
            f"{p.stem}_enhanced.wav" if stem_counts[p.stem] == 1
            else f"{p.stem}_{p.suffix.lstrip('.')}_enhanced.wav")
        for p in audio_files
    }

    with ThreadPoolExecutor(max_workers=n_workers) as io_pool:
        pending = [io_pool.submit(_safe_read, p) for p in audio_files[:B]]
        writes: List[tuple] = []
        for i in range(0, len(audio_files), B):
            futs = pending
            # prefetch the next batch's decodes so they overlap this
            # batch's device compute; the engine runs on this thread only
            pending = [io_pool.submit(_safe_read, p)
                       for p in audio_files[i + B: i + 2 * B]]
            loaded = [f.result() for f in futs]
            good = [(p, a, sr) for p, a, sr in loaded if a is not None]
            errors.extend((p, e) for p, a, e in loaded if a is None)
            if not good:
                continue
            outs = enhance_batch(
                [a for _, a, _ in good], [sr for _, _, sr in good],
                model=args.model, attn_limit_db=args.attn_limit_db,
                quality=args.quality, verbose=args.verbose, device=args.device)
            total_audio_s += sum(a.shape[0] / sr for _, a, sr in good)
            for (p, _a, sr), out in zip(good, outs):
                writes.append((p, io_pool.submit(
                    write_wav, dests[p], pcm16_safe(out), int(sr),
                    subtype="PCM_16")))
            done = min(i + B, len(audio_files))
            print(f"  [{done}/{len(audio_files)}] processed", file=sys.stderr)
        # writes are only joined here, after the last batch dispatched —
        # encode IO overlaps compute throughout
        for p, w in writes:
            try:
                w.result()
            except Exception as exc:  # noqa: BLE001 - reported per file
                errors.append((p, exc))

    dt = time.perf_counter() - t0
    if total_audio_s > 0:
        print(f"Processed {total_audio_s:.1f}s of audio in {dt:.2f}s "
              f"(xRT {total_audio_s / dt:.1f})")
    if errors:
        msgs = "\n".join(f"  {p}: {e}" for p, e in errors)
        raise RuntimeError(f"Errors during processing:\n{msgs}")
    return 0


def _safe_read(path: Path):
    from .audio_io import read_audio

    try:
        audio, sr = read_audio(path)
        return path, audio, sr
    except Exception as exc:  # noqa: BLE001 - reported per file at the end
        # third slot carries the actual cause ('soundfile required for
        # .flac', decode stderr, PermissionError...) for the error report
        return path, None, exc


def _run_download(args: argparse.Namespace) -> int:
    from .api import download

    if (args.model is not None and args.model_flag is not None
            and args.model != args.model_flag):
        raise ValueError(
            "Conflicting model names provided in positional argument and --model.")
    model = args.model if args.model is not None else args.model_flag
    destination = download(model=model, force=args.force, quiet=args.quiet,
                           verbose=args.verbose)
    if isinstance(destination, dict):
        print("Downloaded models:")
        for model_name, model_path in destination.items():
            print(f"- {model_name}: {model_path}")
    else:
        print(f"Downloaded '{model if model else '<unknown>'}' to: {destination}")
    return 0


def _run_bench(args: argparse.Namespace) -> int:
    from .runtime.bench import run_bench, run_serving_bench, run_stream_bench

    import contextlib

    profile_cm = contextlib.nullcontext()
    if args.profile is not None:
        from torch.profiler import ProfilerActivity, profile

        args.profile.mkdir(parents=True, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if args.device.startswith("cuda"):
            activities.append(ProfilerActivity.CUDA)
        profile_cm = profile(activities=activities)
    with profile_cm as prof:
        hops = args.hops_per_call
        if args.serving:
            result = run_serving_bench(
                model=args.model, streams=args.streams,
                hops_per_call=2 if hops is None else hops,
                precision=args.precision, mode=args.mode, device=args.device)
        elif args.streaming:
            result = run_stream_bench(
                model=args.model, streams=args.streams,
                precision=args.precision, mode=args.mode,
                hops_per_call=0 if hops is None else hops, device=args.device)
        else:
            result = run_bench(model=args.model, batch=args.batch,
                               seconds=args.seconds, reps=args.reps,
                               random_weights=args.random_weights,
                               precision=args.precision, device=args.device)
    print(result)
    if args.profile is not None:
        trace = args.profile / "trace.json"
        prof.export_chrome_trace(str(trace))
        print(f"profiler trace written to: {trace}", file=sys.stderr)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 0
    try:
        if args.command == "models":
            return _print_model_table()
        if args.command == "enhance":
            return _run_enhance(args)
        if args.command == "enhance-dir":
            return _run_enhance_dir(args)
        if args.command == "download":
            return _run_download(args)
        if args.command == "eval":
            if args.vs_onnx is not None:
                from .quality import validate_vs_onnx

                return validate_vs_onnx(
                    str(args.csv), str(args.vs_onnx), model=args.model,
                    out_csv=args.out, pesq_tolerance=args.pesq_tolerance,
                    device=args.device)
            from .metrics import evaluate_csv

            out = evaluate_csv(str(args.csv), args.out)
            print(f"Wrote results to: {out}")
            return 0
        if args.command == "demo":
            from .demo import run_demo

            return run_demo(
                model=args.model, input_path=args.input,
                output_path=args.output, mix=args.mix,
                chunk_ms=args.chunk_ms, verbose=args.verbose,
                spectrogram=args.spectrogram, device=args.device)
        if args.command == "bench":
            return _run_bench(args)
    except Exception as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 2
    parser.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
