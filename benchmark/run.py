#!/usr/bin/env python3
"""The benchmark of ``dpdfnet_tpu_torch``, one cell per run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  One run:

1. finds the cell in ``BENCHMARK.json`` and its configuration, mix, kind
   of traffic, limits and metric readers under ``benchmark/`` by name;
2. builds the program's kernel libraries into ``benchmark/.build/``
   (``DPDFNET_TPU_COMPILE_CACHE``; the first run in a checkout compiles,
   later runs load);
3. makes the raw weights and the inputs on the card from ``--seed``;
4. builds the engine (``engine_from_quality`` at the configuration's
   tier, over every card the cell asks for) and warms up the cell's own
   shapes; all of that is ``setup_s``;
5. measures for ``--seconds`` (``--trace 1``: under ``torch.profiler``,
   for at most ``TRACE_SECONDS``, and reports the per-layer metrics);
6. checks that no JAX module was loaded, reads the peak memory, frees the
   program, compares the sampled answers with the plain reference, prints
   each compared number beside its limit on standard error and, as the
   last line of standard output, the result as one JSON object.

It needs ``torch.cuda`` with as many cards as the cell asks for, and exits
2 without a result otherwise; it exits 3 without a result if a module of
``jax``, ``jaxlib``, ``flax`` or ``dpdfnet_tpu`` was loaded, and 4 if a
metric that ``BENCHMARK.json`` lists for the cell read nothing.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BUILD = BENCH / ".build"

# every build and kernel cache of the program inside the checkout, at fixed paths
os.environ["DPDFNET_TPU_COMPILE_CACHE"] = str(BUILD)
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TRACE_SECONDS = 5.0
FORBIDDEN = ("jax", "jaxlib", "flax", "dpdfnet_tpu")
# the kernel libraries the float32 tiers run
LIBRARIES = ("dprnn_intra", "dprnn_inter", "gru_scan")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _devices(device: str, chips: int) -> list:
    import torch

    if device == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [torch.device(device)] * chips


def build_engine(cfg_doc: dict, params, devices):
    """The program's engine for the configuration, at its tier, over the
    cell's cards."""
    import dataclasses

    from dpdfnet_tpu_torch.config import ModelConfig
    from dpdfnet_tpu_torch.parallel.mesh import make_mesh
    from dpdfnet_tpu_torch.runtime.engine import engine_from_quality

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg_doc.items() if k in fields}
    cfg = ModelConfig(**kw)
    if len(devices) > 1:
        return engine_from_quality(cfg, params, cfg_doc["quality"], mesh=make_mesh(devices))
    return engine_from_quality(cfg, params, cfg_doc["quality"], device=devices[0])


def run_cell(spec, cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = None, mix_override: dict = None) -> dict:
    """One run of ``cell``; returns the result object (``correct`` and the
    compared numbers included).  ``device="cpu"`` runs the program's plain
    paths (the harness's own tests); ``mix_override`` replaces keys of the
    mix."""
    import torch

    from benchmark.harness import check, weights
    from benchmark.harness import trace as trace_lib
    from benchmark.harness.spans import Spans

    t_start = time.perf_counter() if t_start is None else t_start
    torch.set_grad_enabled(False)
    cfg_doc = spec.config(cell["config"])
    mix = dict(spec.traffic(cell["traffic"]), **(mix_override or {}))
    kind = spec.kind(mix["kind"])
    limits = spec.limits(cell["name"])
    chips = int(cell["chips"])
    devs = _devices(device, chips)
    dev0 = devs[0]
    phases = {}

    def mark(name):
        phases[name] = time.perf_counter() - t_start - sum(phases.values())

    mark("imports")
    if dev0.type == "cuda":
        from dpdfnet_tpu_torch.ops import _build

        _build.build(LIBRARIES)
    mark("build")
    params = weights.make(cfg_doc, seed, dev0)
    mark("weights")
    inputs = kind.generate(mix, cfg_doc, seed, dev0)
    mark("inputs")
    engine = build_engine(cfg_doc, weights.clone(params), devs)
    spans = Spans()
    driver = kind.Driver(engine, inputs, spans)
    mark("engine")
    driver.warmup()
    cards = sorted({d.index for d in devs if d.type == "cuda"})
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats(c)
    gc.collect()
    mark("warmup")
    setup_s = time.perf_counter() - t_start

    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards else [])
        spans.tracing = True
        with profile(activities=acts) as prof:
            with record_function(trace_lib.WINDOW):
                driver.window(min(seconds, TRACE_SECONDS))
        spans.tracing = False
        tr = trace_lib.reduce(prof.events(), cards, set(kind.SPANS))
        del prof
    else:
        driver.window(seconds)

    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    peak = max((torch.cuda.max_memory_allocated(c) for c in cards), default=0)

    if trace:
        ctx = {"cell": cell, "config": cfg_doc, "mix": mix, "chips": chips, "t0": driver.t0,
               "log": driver.log, "trace": tr, "peaks": peaks_for(dev0)}
        metrics = read_per_layer(spec, cell, ctx, strict=bool(cards))
    else:
        metrics = read_end_to_end(spec, cell, dict(driver.end_to_end(), setup_s=setup_s),
                                  strict=bool(cards))

    # the program's answers, then the program freed before the reference runs
    got, due = driver.answers(), driver.due()
    attempted, failed = driver.attempted, driver.failed
    extra = {"backlog_max_hops": getattr(driver, "backlog_max", None)}
    driver.release()
    del driver, engine
    gc.collect()
    if cards:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = kind.references(params, cfg_doc, inputs, due, dev0)
    nums = check.numbers(got, want)
    correct, table = check.verdict(nums, limits)

    dev = {"platform": "gpu" if cards else dev0.type,
           "kind": torch.cuda.get_device_name(cards[0]) if cards else dev0.type,
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": dev}
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_mean_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = trace_lib.breakdown(tr)
    out["run"] = {"workload": cell["name"], "seed": seed, "seconds": seconds,
                  "trace": bool(trace), "compared": nums["compared"], "setup_phases_s": phases,
                  "reference_s": time.perf_counter() - t_ref, **extra}
    out["check"] = table
    return out


def read_end_to_end(spec, cell: dict, values: dict, strict: bool) -> dict:
    """The cell's end-to-end metrics from the driver's ``values``, each
    under its name or its name less the last dotted part.  ``strict`` (a
    run on cards): a listed metric with no value is a fault of the run;
    else (a CPU run too short to complete a call) it is left out."""
    from benchmark.harness.cells import lookup

    metrics = {}
    for m in spec.metrics_of(cell, trace=False):
        key = lookup(m["name"], values)
        if key is None and strict:
            raise MissingMetric(m["name"])
        if key is not None:
            metrics[m["name"]] = {"value": float(values[key]), "unit": m["unit"]}
    return metrics


def read_per_layer(spec, cell: dict, ctx: dict, strict: bool) -> dict:
    """The cell's per-layer metrics from their readers.  ``strict`` (a run
    on cards): a listed metric that reads nothing is a fault of the run;
    else (the CPU, where the device's readers find no trace) it is left
    out."""
    metrics = {}
    for m in spec.metrics_of(cell, trace=True):
        v = spec.reader(m["name"])(ctx)
        if v is None and strict:
            raise MissingMetric(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return metrics


def peaks_for(device) -> dict:
    """The published peaks of the card (``harness/peaks.json``), or
    ``None`` for a card the table does not hold."""
    import torch

    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    with open(BENCH / "harness" / "peaks.json") as f:
        table = json.load(f)["cards"]
    for entry in table:
        if all(k in name for k in entry["match"]):
            return entry
    return None


class ForbiddenModules(RuntimeError):
    pass


class MissingMetric(RuntimeError):
    """A metric that BENCHMARK.json lists for the cell read nothing."""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness.cells import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{n} visible", file=sys.stderr)
        return 2
    try:
        out = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                       t_start=T_START)
    except ForbiddenModules as exc:
        print(f"benchmark: modules loaded that the port must not load: {exc.args[0]}",
              file=sys.stderr)
        return 3
    except MissingMetric as exc:
        print(f"benchmark: {args.workload} lists the metric {exc.args[0]!r}, which read "
              f"nothing in this run", file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules loaded that the port must not load: {bad}", file=sys.stderr)
        return 3
    for name, v in out["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
