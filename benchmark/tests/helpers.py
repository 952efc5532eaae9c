"""Shared pieces of the benchmark's tests: a tiny run of a cell on the CPU."""

import importlib.util
from pathlib import Path

import benchmark.harness.cells  # noqa: F401  (the repository's harness, before any copy's)

ROOT = Path(__file__).resolve().parents[2]

# tiny forms of the mixes, so that a run fits a CPU test
TINY = {
    "offline": {"utterances": 4, "batch": 2, "median_s": 0.4, "min_s": 0.3, "max_s": 0.5},
    "live": {"streams": 2, "warmup_hops": 3, "compare_streams": 2, "loop_s": 0.5},
}
SEED = 2 ** 31 + 12345


def run_module(root: Path = ROOT):
    """``benchmark/run.py`` of the checkout at ``root``, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"bench_run_{abs(hash(root))}",
                                                  root / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_run(workload: str, *, seconds: float = 0.5, trace: bool = False, root: Path = ROOT,
             chips: int = None, seed: int = SEED):
    from benchmark.harness.cells import Spec

    run = run_module(root)
    spec = Spec(root)
    cell = dict(spec.cell(workload))
    if chips is not None:
        cell["chips"] = chips
    kind = spec.traffic(cell["traffic"])["kind"]
    return run.run_cell(spec, cell, seed, seconds, trace, device="cpu", mix_override=TINY[kind])
