"""Timing tools of the port: the DPRNN step ablations
(``python -m dpdfnet_tpu_torch.tools.intra_step_ablation`` and
``... .inter_step_ablation``), counterparts of the JAX package's
``tools/intra_step_ablation.py`` and ``tools/inter_step_ablation.py``.

Shared here: timing a kernel wrapper with CUDA events, the report both
tools print (ms per call, ns per step, deltas against ``full``) and the
tolerance of their ``--check``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

# A specialization's kernel against its plain version: max-abs beyond one
# bfloat16 ulp of the plain value (``gru_kernels.err_beyond_bf16_ulp``).
CHECK_TOL = 1e-4


def check_failures(errs: Dict[str, float], log=print) -> int:
    """Log every specialization whose error exceeds ``CHECK_TOL``; returns
    their number (a CLI's exit code: 0 when every one matched)."""
    bad = {k: v for k, v in errs.items() if not v <= CHECK_TOL}
    for k, v in bad.items():
        log(f"FAILED: specialization {k} is {v:.3e} beyond one bf16 ulp of its plain "
            f"version (tolerance {CHECK_TOL:.0e})")
    return len(bad)


def cuda_ms_per_call(fn: Callable[[], object], reps: int) -> float:
    """Device ms per call of ``fn``: one warm-up call, then ``reps`` calls
    between two CUDA events, the best of three such runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / reps)
    return best


def report(results: Dict[str, Tuple[str, float, float]], log=print) -> None:
    """Print each variant's ms per call and ns per step, then its delta
    against ``full`` (``results``: variant -> (specialization, ms, ns))."""
    for name, (spec, ms, ns) in results.items():
        log(f"{name:>16}: {ms:8.4f} ms/call {ns:10.1f} ns/step  (specialization {spec})")
    if "full" in results:
        base = results["full"][1]
        log("\ndeltas vs full:")
        for name, (_, ms, _) in results.items():
            log(f"{name:>16}: {ms - base:+8.4f} ms ({100 * (ms - base) / base:+6.1f}%)")
