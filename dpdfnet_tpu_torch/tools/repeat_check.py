"""Run-to-run repeatability of the walk kernels on fixed inputs.

    python3 dpdfnet_tpu_torch/tools/repeat_check.py [--root DIR] [--repeats N]
        [--cases NAME,...] [--after-tests] [--out FILE]

Each case of :data:`CASES` builds its inputs once with numpy from a seed and
calls the kernel's wrapper ``--repeats`` times on them, in one process.
Every other call first leaves the card "dirty": a NaN-filled block is
allocated and freed (so the output buffers come back from PyTorch's
caching allocator holding NaN) and another walk kernel runs (so shared
memory holds another kernel's values).  A kernel that reads a buffer it
never wrote, or that races, gives outputs that differ between calls; one
that does neither gives the same bits every time.  Per case it prints the
number of distinct output digests (SHA-256 of the raw bytes), the largest
max-abs between any call and the first, and the largest max-abs of any
call against the plain version on the CPU.

``--after-tests`` first runs ``tests/test_torch_cuda.py`` of the checkout in
the same process (with ``--noconftest``), so the loop runs on a card and
allocator in the state that whole file leaves.  ``--root`` (default: the
checkout holding this file) decides which ``dpdfnet_tpu_torch`` is
imported, as in ``mode_off_digest.py``: the script can check an earlier
commit unpacked under a ``.gitignore``d directory.  Exits 1 if any case
gave more than one digest or left the plain version by more than 1e-4.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np

C = 64
TOL = 1e-4
# case -> (kernel, seed, shape); the inputs are drawn in the order of the
# card tests of tests/test_torch_cuda.py with the same seed, so the first
# case is test_cuda_inter_fm_modes[plane0-False-False] (f32 plane,
# fm_batch = B, h_bm and defer off)
CASES = {
    "inter fm f32 B=6 T=4 Fq=16": ("inter_fm", 32, (6, 4, 16)),
    "inter f32 B=3 T=10 Fq=40": ("inter", 7, (3, 10, 40)),
    "intra f32 N=30 Fq=40": ("intra", 6, (30, 40)),
    "gru_bidir f32 N=30 L=40": ("bidir", 9, (30, 40)),
    "stack f32 B=5 T=3 Fq=40 K=3": ("stack", 45, (5, 3, 40, 3)),
}


def _inputs(kernel: str, seed: int, shape: tuple, dev):
    """(call, plain): the wrapper on the card and the plain version on the
    CPU, each a function of nothing returning a tuple of tensors."""
    import torch

    from dpdfnet_tpu_torch.ops import gru_kernels as gk

    rng = np.random.default_rng(seed)

    def t(s, scale):
        return torch.tensor(rng.normal(size=s) * scale, dtype=torch.float32)

    def gru():
        return (t((C, 3 * C), 0.3), t((3 * C,), 0.1), t((C, 3 * C), 0.3), t((3 * C,), 0.1))

    def on(args):
        return tuple(a.to(dev) for a in args)

    if kernel in ("inter", "inter_fm"):
        wi, bi, wh, bh = gru()
        args = (wi, bi, wh, bh, t((C, C), 0.3), t((C,), 0.1), 1.0 + t((C,), 0.5), t((C,), 0.1))
        if kernel == "inter_fm":
            B, T, Fq = shape
            x4, h4 = t((B, T, Fq, C), 1.0), t((B, Fq, C), 0.2)
            x = x4.permute(1, 2, 0, 3).reshape(T, Fq * B, C).contiguous()
            h0 = h4.transpose(0, 1).reshape(Fq * B, C).contiguous()
            kw = dict(fm_batch=B, h_bm=False, defer=False)
        else:
            B, T, Fq = shape
            x, h0 = t((B, T, Fq, C), 1.0), t((B, Fq, C), 0.2)
            kw = dict(defer=False)
        xd, hd, ad = x.to(dev), h0.to(dev), on(args)
        return (lambda: gk.dprnn_inter_block(xd, hd, *ad, **kw),
                lambda: gk.dprnn_inter_block(x, h0, *args, **kw))
    if kernel == "stack":
        from dpdfnet_tpu_torch.models.fuse import pack_stack

        B, T, Fq, K = shape
        blocks = []
        for _ in range(K):
            wi2, wh2, b2 = gk._pack_bidir(dict(zip(("wi", "bi", "wh", "bh"), gru())),
                                          dict(zip(("wi", "bi", "wh", "bh"), gru())))
            wi, bi, wh, bh = gru()
            blocks.append({
                "intra": {"packed": {"wi2": wi2, "wh2": wh2, "b2": b2},
                          "fc": {"w": t((2 * C, C), 0.3), "b": t((C,), 0.1)},
                          "ln": {"g": 1.0 + t((C,), 0.5), "b": t((C,), 0.1)}},
                "inter": {"gru": {"wi": wi, "bi": bi, "wh": wh, "bh": bh},
                          "fc": {"w": t((C, C), 0.3), "b": t((C,), 0.1)},
                          "ln": {"g": 1.0 + t((C,), 0.5), "b": t((C,), 0.1)}}})
        stacked = pack_stack(blocks)
        x, h0 = t((B, T, Fq, C), 1.0), t((K, B, Fq, C), 0.2)
        xd, hd = x.to(dev), h0.to(dev)
        sd = {k: v.to(dev) for k, v in stacked.items()}
        return (lambda: gk.dprnn_stack(xd, hd, sd),
                lambda: gk.dprnn_stack(x, h0, stacked))
    N, L = shape
    wi2, wh2, b2 = gk._pack_bidir(dict(zip(("wi", "bi", "wh", "bh"), gru())),
                                  dict(zip(("wi", "bi", "wh", "bh"), gru())))
    if kernel == "intra":
        args = (wi2, wh2, b2, t((2 * C, C), 0.3), t((C,), 0.1), 1.0 + t((C,), 0.5),
                t((C,), 0.1))
        x = t((N, L, C), 1.0)
        xd, ad = x.to(dev), on(args)
        return (lambda: (gk.dprnn_intra_block(xd, *ad),),
                lambda: (gk.dprnn_intra_block(x, *args),))
    args = (wi2, wh2, b2)
    x = t((N, L, C), 1.0)
    xd, ad = x.to(dev), on(args)
    return lambda: gk.gru_bidir(xd, *ad), lambda: gk.gru_bidir(x, *args)


def _dirty(dev, other):
    """NaN through the caching allocator's free blocks, another kernel
    through shared memory."""
    import torch

    junk = torch.full((1 << 22,), float("nan"), device=dev)
    del junk
    other()


def check_case(name: str, repeats: int, dev, log=print) -> dict:
    import torch

    kernel, seed, shape = CASES[name]
    call, plain = _inputs(kernel, seed, shape, dev)
    ref = plain()
    other, _ = _inputs("intra", 99, (50, 48), dev)
    digests, first = {}, None
    worst_rep = worst_ref = 0.0
    for i in range(repeats):
        if i % 2:
            _dirty(dev, other)
        got = call()
        torch.cuda.synchronize()
        got = tuple(g.cpu() for g in got)
        h = hashlib.sha256()
        for g in got:
            h.update(g.contiguous().view(torch.uint8).numpy().tobytes())
        digests[h.hexdigest()] = digests.get(h.hexdigest(), 0) + 1
        if first is None:
            first = got
        worst_rep = max(worst_rep, max((a.float() - b.float()).abs().max().item()
                                       for a, b in zip(got, first)))
        worst_ref = max(worst_ref, max((a.float() - b.float()).abs().max().item()
                                       for a, b in zip(got, ref)))
    res = dict(case=name, repeats=repeats, distinct_digests=len(digests),
               max_abs_vs_first=worst_rep, max_abs_vs_plain=worst_ref)
    log(f"repeat {name}: {repeats} calls, {len(digests)} distinct output digest(s), max-abs "
        f"vs the first call {worst_rep:.3e}, vs the CPU plain version {worst_ref:.3e} "
        f"(tol {TOL:.0e})")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose dpdfnet_tpu_torch is imported")
    ap.add_argument("--repeats", type=int, default=1000)
    ap.add_argument("--cases", default=",".join(CASES), help="comma-separated case names")
    ap.add_argument("--after-tests", action="store_true",
                    help="first run the checkout's tests/test_torch_cuda.py in this process")
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("repeat_check: needs a CUDA device", file=sys.stderr)
        return 2
    from dpdfnet_tpu_torch.ops import gru_kernels as gk

    if not os.path.abspath(gk.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {gk.__file__}, not the package under {root}")
    tests_rc = None
    if args.after_tests:
        import pytest

        here = os.getcwd()
        os.chdir(root)
        tests_rc = int(pytest.main(["tests/test_torch_cuda.py", "-q", "--noconftest",
                                    "-p", "no:cacheprovider"]))
        os.chdir(here)
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    results = [check_case(n, args.repeats, dev) for n in args.cases.split(",")]
    out = {"root": root, "after_tests_rc": tests_rc, "cases": results}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    bad = [r for r in results if r["distinct_digests"] != 1 or not r["max_abs_vs_plain"] <= TOL]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
