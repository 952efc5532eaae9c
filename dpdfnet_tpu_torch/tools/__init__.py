"""Timing tools of the port: the DPRNN step ablations
(``python -m dpdfnet_tpu_torch.tools.intra_step_ablation`` and
``... .inter_step_ablation``), counterparts of the JAX package's
``tools/intra_step_ablation.py`` and ``tools/inter_step_ablation.py``.

Shared here: timing a kernel wrapper with CUDA events, the report both
tools print (ms per call, ns per step, deltas against ``full``), the
tolerance of their ``--check`` and its verdict on ``full`` against the
production kernel, and the FFMA and spill instructions of each kernel in
a built library (``chip_smoke.py`` prints the step ablations').
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path
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


def production_failures(same: Dict[str, bool], log=print) -> int:
    """Log every layout in which ``full`` is not bit for bit the production
    kernel's output; returns their number."""
    bad = [k for k, v in same.items() if not v]
    for k in bad:
        log(f"FAILED: full differs from the production kernel ({k} layout)")
    return len(bad)


def sass_counts(lib_name: str, opcodes=("FFMA", "LDL", "STL")) -> Dict[str, Dict[str, int]]:
    """Demangled kernel name -> how many instructions of each opcode its
    SASS holds (FFMA: the float32 FMAs; LDL / STL: local-memory loads and
    stores, the spills), for the built library ``lib_name``
    (``cuobjdump -sass`` and ``cu++filt`` beside ``nvcc``).  Builds the
    library if needed."""
    from ..ops import _build

    _build.load(lib_name)
    bindir = Path(_build.nvcc_path()).parent
    sass = subprocess.run([str(bindir / "cuobjdump"), "-sass", str(_build._lib_path(lib_name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts: Dict[str, Dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(opcodes, 0)
        elif name is not None:
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
            if m and m.group(1) in counts[name]:
                counts[name][m.group(1)] += 1
    names = list(counts)
    plain = subprocess.run([str(bindir / "cu++filt")], input="\n".join(names),
                           capture_output=True, text=True, check=True, timeout=60).stdout
    # template arguments as written: <2, float, ...>, not <(int)2, float, ...>
    plain = re.sub(r"\((?:unsigned )?int\)", "", plain)
    return dict(zip(plain.splitlines(), (counts[n] for n in names)))


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
