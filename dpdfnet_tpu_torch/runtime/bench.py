"""Benchmark runner (counterpart of ``dpdfnet_tpu.runtime.bench``): each
function returns one JSON line ``{"metric", "value", "unit",
"vs_baseline", ...}`` with the metric names of the JAX package, so the two
packages' lines are easy to match, and the device it ran on.

- ``run_bench``: offline throughput, seconds of audio enhanced per wall
  second (xRT), for the engine's offline pipeline (STFT, the 112-frame
  segments of ``forward_spec``, iSTFT) on a batch resident on the device,
  exactly ``seconds`` long (no length bucket); the median of ``reps``
  calls after one warm-up call (which also builds the kernels), each
  call ending in a tiny device-to-host copy.
- ``run_stream_bench``: streaming ms per hop for a batch of streams, one
  ``Engine.process_frames`` call per hop (or per ``hops_per_call`` hops);
  each call ends in the copy of its output to the host, so the time is
  the wall a real-time server sees, host work included (the JAX function
  timed the device program alone).
- ``run_serving_bench``: the serving layer, ``MultiStreamEnhancer.
  process_many`` (buffering, state gather / scatter, the engine call,
  overlap-add), wall ms per hop.

Weights: ``init_params(cfg, seed=0)`` on the device (throughput does not
depend on their values), or the zoo's for ``random_weights=False``.
Every function takes ``device=None`` (cuda; ``"cpu"`` for the plain
path, whose numbers are no card figure).
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

# The offline xRT that ``vs_baseline`` divides by: the port's first card
# figure, Engine.enhance_waveforms on dpdfnet8_48khz_hr, B=64 x 4 s,
# float32 (TF32 off), chip_smoke.py phase 4 on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md, Findings).  Not the TPU target of BASELINE.md.  That
# figure is timed through enhance_waveforms, host copies included (the
# NumPy pad, the upload, the download); the runner's xRT that
# ``vs_baseline`` divides by it is ``Engine._offline`` on a batch already
# on the device, with no host copies, so the ratio is not a gain of the
# device path alone.
CARD_BASELINE_XRT = 362.4


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def _engine(model: str, precision: str, dev: torch.device, params=None, **kwargs):
    """An engine for a quality-tier name or a raw matmul precision, on
    random weights (seed 0) unless ``params`` are given."""
    from ..config import get_config
    from ..models.params import init_params
    from .engine import QUALITY_TIERS, Engine, engine_from_quality

    cfg = get_config(model)
    if params is None:
        params = init_params(cfg, seed=0, device=dev)
    if precision in QUALITY_TIERS:
        return engine_from_quality(cfg, params, quality=precision, device=dev, **kwargs)
    return Engine(cfg, params, precision=precision, device=dev, **kwargs)


def run_stream_bench(
    model: str = "dpdfnet8_48khz_hr",
    streams: int = 64,
    seconds: float = 2.0,
    precision: str = "high",
    mode: str = "exact",
    hops_per_call: int = 0,
    device: DeviceLike = None,
) -> str:
    """Streaming ms per hop for ``streams`` live streams and the implied
    number of streams at real time.

    ``hops_per_call`` 0 (or 1): one ``process_frames`` call per hop, the
    cadence of a real-time server; N > 1: calls of N hops each, which adds
    N hops of buffering latency.  ``mode``: ``"exact"`` or
    ``"throughput"`` (``Engine.process_frames``).  One warm-up pass of 16
    hops, then the median of 3 passes over ``seconds`` of audio."""
    dev = resolve_device(device)
    engine = _engine(model, precision, dev)
    cfg = engine.cfg
    per_call = max(1, int(hops_per_call))
    hop_s = cfg.hop / cfg.sample_rate
    n_calls = max(16, int(seconds / hop_s)) // per_call
    rng = np.random.default_rng(0)
    frames = (0.05 * rng.normal(size=(streams, n_calls * per_call, cfg.win_len))
              ).astype(np.float32)

    def run(n: int) -> None:
        st = engine.init_stream_state(batch=streams)
        for i in range(n):
            _, st = engine.process_frames(frames[:, i * per_call:(i + 1) * per_call], st,
                                          mode=mode)

    # warm-up; every call ends in the copy of its output to the host, so the
    # device is idle when each timed pass starts
    run(max(1, 16 // per_call))
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(n_calls)
        lat.append((time.perf_counter() - t0) / (n_calls * per_call))
    per_hop = float(np.median(lat)) * 1e3
    budget_ms = hop_s * 1e3
    extra, tag = {}, ""
    if hops_per_call:
        extra = {"hops_per_call": per_call,
                 "buffering_latency_ms": round(per_call * hop_s * 1e3, 1),
                 "n_calls": n_calls}
        tag = f"_h{per_call}"
    result = {
        "metric": f"stream_hop_device_ms_{model}_s{streams}{tag}_{mode}_{precision}",
        "value": round(per_hop, 3),
        "unit": "ms_per_hop",
        "vs_baseline": round(budget_ms / per_hop, 3),
        "realtime_stream_capacity_est": int(streams * budget_ms / per_hop) if per_hop > 0 else 0,
        **extra,
        "device": _device_name(dev),
    }
    return json.dumps(result)


def run_serving_bench(
    model: str = "dpdfnet8_48khz_hr",
    streams: int = 256,
    hops_per_call: int = 2,
    calls: int = 12,
    precision: str = "high",
    mode: str = "exact",
    device: DeviceLike = None,
) -> str:
    """Serving-layer benchmark through ``MultiStreamEnhancer.process_many``:
    per-slot input buffering, the state gather / scatter around the
    batched engine call, the engine call and the overlap-add, as a
    frontend aggregating ``hops_per_call`` hops per connection sees them.
    Reports wall ms per hop and the implied streams at real time."""
    from ..serving import MultiStreamEnhancer

    dev = resolve_device(device)
    engine = _engine(model, precision, dev)
    cfg = engine.cfg
    pool = MultiStreamEnhancer(streams, engine=engine, mode=mode)
    sids = [pool.open() for _ in range(streams)]
    rng = np.random.default_rng(0)
    chunk_len = cfg.hop * hops_per_call
    hop_ms = cfg.hop / cfg.sample_rate * 1e3

    def feed():
        chunks = {sid: (0.05 * rng.normal(size=chunk_len)).astype(np.float32)
                  for sid in sids}
        return pool.process_many(chunks)

    # prime past the one-window buffering latency (and the warm-up)
    feed()
    feed()
    lat = []
    for _ in range(calls):
        t0 = time.perf_counter()
        feed()
        lat.append(time.perf_counter() - t0)
    per_call = float(np.median(lat)) * 1e3
    per_hop = per_call / hops_per_call
    budget_ms = hop_ms * hops_per_call
    result = {
        "metric": (f"serving_wall_ms_per_hop_{model}_s{streams}"
                   f"_h{hops_per_call}_{mode}_{precision}"),
        "value": round(per_hop, 3),
        "unit": "ms_per_hop_wall",
        "vs_baseline": round(budget_ms / per_call, 3),
        "per_call_ms": round(per_call, 3),
        "added_latency_ms": round(per_call, 3),
        "realtime_stream_capacity_est": int(streams * budget_ms / per_call) if per_call > 0 else 0,
        "device": _device_name(dev),
    }
    return json.dumps(result)


def run_bench(
    model: str = "dpdfnet8_48khz_hr",
    batch: int = 64,
    seconds: float = 4.0,
    reps: int = 5,
    random_weights: bool = True,
    precision: str = "high",
    baseline_xrt: float = CARD_BASELINE_XRT,
    compute_dtype: Optional[torch.dtype] = None,
    label: Optional[str] = None,
    seg_frames: Optional[int] = None,
    device: DeviceLike = None,
) -> str:
    """Offline xRT; returns one JSON line {"metric", "value", "unit",
    "vs_baseline", "device"}.  ``precision`` is a quality-tier name
    (``highest`` / ``high`` / ``fast`` / ``turbo``) or a raw matmul
    precision (``default`` / ``high`` / ``highest``, float32 unless
    ``compute_dtype`` says otherwise)."""
    from .engine import _math_mode

    dev = resolve_device(device)
    params = None
    if not random_weights:
        from ..zoo import load_model_params, resolve_model

        params = load_model_params(resolve_model(model=model), device=dev)
    kwargs = {}
    if compute_dtype is not None:
        kwargs["compute_dtype"] = compute_dtype
    if seg_frames is not None:
        kwargs["seg_frames"] = int(seg_frames)
    engine = _engine(model, precision, dev, params=params, **kwargs)
    cfg = engine.cfg
    S = int(seconds * cfg.sample_rate)
    rng = np.random.default_rng(0)
    wav = torch.from_numpy((rng.normal(size=(batch, S)) * 0.05).astype(np.float32)).to(dev)

    def once() -> float:
        with _math_mode(engine.precision):
            y = engine._offline(wav, 0.0)
        return float(y[:, :: max(1, S // 64)].sum().item())       # tiny D2H sync

    once()                                                        # warm-up, kernel build
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    xrt = batch * seconds / float(np.median(times))
    result = {
        "metric": f"xRT_per_chip_{model}_offline_b{batch}_{label or precision}",
        "value": round(xrt, 2),
        "unit": "x_realtime",
        "vs_baseline": round(xrt / baseline_xrt, 4),
        "device": _device_name(dev),
    }
    return json.dumps(result)
