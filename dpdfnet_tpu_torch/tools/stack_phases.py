"""Where the DPRNN stack kernel's time goes, phase by phase, on the card.

    python3 dpdfnet_tpu_torch/tools/stack_phases.py [--B 64] [--T 1] [--Fq 48] [--K 8]
        [--calls 20]

Builds ``csrc/dprnn_stack.cu`` with ``DPDF_STACK_PHASES`` (clock64 stamps at
its phase boundaries, summed by thread 0 of CTA 0; the production build
compiles them out) into the package's build directory, runs it on random
weights in both of its modes (one CTA per stream, a two-CTA cluster per
stream), checks that each gives the production kernel's bits, and prints
per mode the ms per call and, per (t, k), the cycles of each phase and the
SM clock they imply.  Prints a JSON object as its last line.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
PHASES = ("frame load, top barrier", "intra xp, walk weights", "walk (direction 0)",
          "partials barrier", "intra LayerNorm", "inter x.Wi (+ h.Wh, CL=1)", "inter gates",
          "inter fc", "inter LayerNorm")


def build(gk) -> ctypes.CDLL:
    """The stack with its phase stamps, built beside the production
    libraries (rebuilt when the source changes)."""
    from dpdfnet_tpu_torch.ops import _build

    lib = _build._lib_path("dprnn_stack")
    out = lib.with_name(lib.stem + "-phases.so")
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DDPDF_STACK_PHASES", "-o", str(out),
               str(_build.CSRC / "dprnn_stack.cu")]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    so = ctypes.CDLL(str(out))
    so.dprnn_stack_launch.argtypes = gk._ARGTYPES["dprnn_stack_launch"]
    so.dprnn_stack_launch.restype = ctypes.c_int
    so.dprnn_stack_phases_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    so.dprnn_stack_phases_read.restype = ctypes.c_int
    return so


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--T", type=int, default=1)
    ap.add_argument("--Fq", type=int, default=48)
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("stack_phases: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    from dpdfnet_tpu_torch.ops import gru_kernels as gk
    from dpdfnet_tpu_torch.tools.kernel_ab import _stack_args

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    so = build(gk)
    B, T, Fq, K = args.B, args.T, args.Fq, args.K
    st, _, _ = _stack_args(gk, np.random.default_rng(0), K)
    ws = [st[k] for k in gk._stack_shapes(K, 64)]
    x = torch.randn(B, T, Fq, 64, device="cuda")
    h0 = torch.randn(K, B, Fq, 64, device="cuda") * 0.5
    ref = gk.dprnn_stack(x, h0, st)
    buf = (ctypes.c_ulonglong * 9)()
    result = {"card": smi, "shape": [B, T, Fq, 64], "K": K, "modes": {}}
    for cl in (1, 2):
        out, hl = torch.empty_like(x), torch.empty_like(h0)

        def call():
            rc = so.dprnn_stack_launch(x.data_ptr(), out.data_ptr(), h0.data_ptr(), hl.data_ptr(),
                                       *(w.data_ptr() for w in ws), B, T, Fq, K, cl * B, 256, 0,
                                       torch.cuda.current_stream().cuda_stream)
            gk._check_rc(rc, "dprnn_stack (phases)")

        call()
        torch.cuda.synchronize()
        gk._check_rc(so.dprnn_stack_phases_read(buf, 1), "dprnn_stack_phases_read")
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.calls):
            call()
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / args.calls
        gk._check_rc(so.dprnn_stack_phases_read(buf, 1), "dprnn_stack_phases_read")
        same = bool(torch.equal(out, ref[0]) and torch.equal(hl, ref[1]))
        per = args.calls * T * K
        cycles = [buf[i] / per for i in range(9)]
        total = sum(cycles)
        ghz = total * per / (ms * 1e-3 * args.calls) / 1e9
        result["modes"][f"CL={cl}"] = dict(ms=ms, cycles_per_tk=cycles, ghz=ghz,
                                           bits_equal_production=same)
        print(f"stack x[{B},{T},{Fq},64] K={K} CL={cl}: {ms:.4f} ms per call, {total:.0f} cycles "
              f"per (t, k) at {ghz:.2f} GHz implied; bits equal to the production build: {same} "
              f"| {smi}")
        for name, c in zip(PHASES, cycles):
            walk = f", {c / (Fq + 1):.0f} per walk step" if name.startswith("walk") else ""
            print(f"  {name:34s} {c:9.0f} cycles ({100 * c / total:5.1f}%){walk}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
