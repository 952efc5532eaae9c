"""Digests of the DPRNN and GRU kernels' outputs with every layout mode off.

    python3 dpdfnet_tpu_torch/tools/mode_off_digest.py [--root DIR] [--write FILE]
        [--against FILE]

Every DPRNN and GRU kernel (DPRNN intra and inter, their v2 forms,
gru_scan, gru_bidir, the DPRNN stack) runs once per case of :data:`CASES` on fixed inputs drawn with numpy from
a seed (a hash of the case's name), through its wrapper's row-major call
(no ``fm_batch``, ``h_bm`` or ``defer``), and so does every specialization
of the two step-ablation kernels (``tools/*_step_ablation.py``, inputs from
the tools' own ``make_inputs`` with a seed from the case's name); each
case's outputs are hashed with SHA-256 (their raw bytes, in order).  Equal
digests mean bit-identical outputs (max-abs 0).

``mode_off_digests.json`` beside this file holds the digests taken on
one H100 by running this script against an unpacked copy of a commit
(``--root``); its ``note`` says which commit each case comes from: the
kernels as they were before the freq-major layout modes were added
(commit edaa86f), except the cases of the kernels whose arithmetic was
redesigned since, which were retaken on the commit of that redesign.
``chip_smoke.py`` and the card tests hold the current kernels to it.  The
record names the ``nvcc`` release and the card it was taken with: a build
by another compiler may round differently, and the comparison then says
so.  A change that means to alter a kernel's arithmetic rewrites that
kernel's cases and leaves every other case as it was.

The script is run by path, not with ``-m``, so that ``--root`` (default:
the checkout holding it) decides which copy of ``dpdfnet_tpu_torch`` is
imported.  ``--against FILE`` exits 1 unless every digest equals the
record's.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict

import numpy as np

RECORD = Path(__file__).resolve().parent / "mode_off_digests.json"
C = 64

# case -> (kernel, plane dtype, shape, extra); shapes as each wrapper takes
# them.  Row counts cover the main path's B=8 and B=64 plans of each walk
# and T == 1 (streaming).
CASES = {
    "dprnn_intra f32 x[896,48,64]": ("intra", "f32", (896, 48), {}),
    "dprnn_intra f32 x[7168,40,64]": ("intra", "f32", (7168, 40), {}),
    "dprnn_intra bf16 x[7168,48,64]": ("intra", "bf16", (7168, 48), {}),
    "dprnn_inter f32 x[8,112,48,64]": ("inter", "f32", (8, 112, 48), {}),
    "dprnn_inter f32 x[64,112,40,64]": ("inter", "f32", (64, 112, 40), {}),
    "dprnn_inter bf16 x[64,112,48,64]": ("inter", "bf16", (64, 112, 48), {}),
    "dprnn_inter f32 x[64,1,48,64]": ("inter", "f32", (64, 1, 48), {}),
    "gru_scan f32 x[8,112,256]": ("scan", "f32", (8, 112, 256), {"reverse": False}),
    "gru_scan f32 x[8,112,256] reverse": ("scan", "f32", (8, 112, 256), {"reverse": True}),
    "gru_scan bf16 x[64,112,256]": ("scan", "bf16", (64, 112, 256), {"reverse": False}),
    "gru_scan f32 x[64,1,256]": ("scan", "f32", (64, 1, 256), {"reverse": False}),
    "gru_bidir f32 x[896,48,64]": ("bidir", "f32", (896, 48), {}),
    "gru_bidir bf16 x[896,48,64]": ("bidir", "bf16", (896, 48), {}),
    "dprnn_stack f32 x[64,1,48,64] K=2": ("stack", "f32", (64, 1, 48, 2), {}),
    "dprnn_stack bf16 x[2,8,40,64] K=2": ("stack", "bf16", (2, 8, 40, 2), {}),
    "dprnn_intra_v2 f32 x[896,48,64] bf16 xp": ("intra_v2", "f32", (896, 48), {"xp_bf16": True}),
    "dprnn_intra_v2 f32 x[896,48,64] f32 xp": ("intra_v2", "f32", (896, 48), {"xp_bf16": False}),
    "dprnn_inter_v2 f32 x[8,112,48,64] bf16 xp": ("inter_v2", "f32", (8, 112, 48), {}),
    "dprnn_inter_v2 bf16 x[64,112,40,64] bf16 xp": ("inter_v2", "bf16", (64, 112, 40), {}),
}
# the step-ablation kernels: every specialization at the tools' check shapes
_INTRA_ABL = ("full", "hlast", "dots", "indep", "gates", "floor", "floor_fb", "floor_fb_bf16")
_INTER_ABL = ("full", "floor", "dot", "gru", "nogates", "noln", "ln1pass", "ln_bf16")
CASES.update({f"intra_step_ablation {spec}{' tm' if tm else ''} bf16 x[40,16,64]":
              ("intra_abl", "bf16", (40, 16), {"spec": spec, "tm": tm})
              for spec in _INTRA_ABL for tm in (False, True)})
CASES.update({f"inter_step_ablation {spec} bf16 x[9,40,64]":
              ("inter_abl", "bf16", (40, 9), {"spec": spec}) for spec in _INTER_ABL})


def _case_outputs(gk, kernel: str, plane: str, shape: tuple, extra: dict, rng, device):
    """The kernel's outputs for one case (through its wrapper)."""
    import torch

    dt = torch.bfloat16 if plane == "bf16" else torch.float32

    def w(*s, scale=C ** -0.5):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(device)

    def ln():
        return 1.0 + w(C, scale=0.2), w(C, scale=0.1)

    def gru(I=C, H=C):
        return {"wi": w(I, 3 * H, scale=I ** -0.5), "bi": w(3 * H, scale=0.1),
                "wh": w(H, 3 * H, scale=H ** -0.5), "bh": w(3 * H, scale=0.1)}

    def plane_of(*s):
        return w(*s, scale=1.0).to(dt)

    if kernel in ("intra", "bidir", "intra_v2"):
        N, Fq = shape
        wi2, wh2, b2 = gk._pack_bidir(gru(), gru())
        wfc, bfc = w(2 * C, C), w(C, scale=0.1)
        g, bln = ln()
        x = plane_of(N, Fq, C)
        if kernel == "intra":
            return (gk.dprnn_intra_block(x, wi2, wh2, b2, wfc, bfc, g, bln),)
        if kernel == "bidir":
            return gk.gru_bidir(x, wi2, wh2, b2)
        wi_cat, wh_big = gk.pack_intra_v2(wi2, wh2, wfc)
        return (gk.dprnn_intra_block_v2(x, wi_cat, wh_big, b2, bfc, g, bln, **extra),)
    if kernel in ("inter", "inter_v2"):
        B, T, Fq = shape
        p = gru()
        wfc, bfc = w(C, C), w(C, scale=0.1)
        g, bln = ln()
        x = plane_of(B, T, Fq, C)
        h0 = w(B, Fq, C, scale=0.5)
        if kernel == "inter":
            return gk.dprnn_inter_block(x, h0, p["wi"], p["bi"], p["wh"], p["bh"], wfc, bfc,
                                        g, bln)
        xp = (x.float() @ p["wi"] + p["bi"]).to(torch.bfloat16)
        whfc = torch.cat([p["wh"], wfc], dim=1)
        return gk.dprnn_inter_block_v2(xp, x, h0, whfc, p["bh"], bfc, g, bln)
    if kernel == "scan":
        N, T, H = shape
        p = gru(H, H)
        return gk.gru_scan(plane_of(N, T, H), w(N, H, scale=0.5), p["wi"], p["bi"], p["wh"],
                           p["bh"], **extra)
    if kernel == "intra_abl":
        from dpdfnet_tpu_torch.tools import intra_step_ablation as abl

        rows, T = shape
        x, ws = abl.make_inputs(rows, T, C, device, dtype=dt, seed=int(rng.integers(1 << 31)))
        xin = x.transpose(0, 1).contiguous() if extra["tm"] else x
        return (abl.run_intra(extra["spec"], xin, *ws, tm=extra["tm"]),)
    if kernel == "inter_abl":
        from dpdfnet_tpu_torch.tools import inter_step_ablation as abl

        rows, T = shape
        x, h0, wp, bp, tail = abl.make_inputs(rows, T, C, device, dtype=dt,
                                              seed=int(rng.integers(1 << 31)))
        return abl.run_inter(extra["spec"], x, h0, *abl.unpack_wp(wp, bp), *tail)
    if kernel == "stack":
        B, T, Fq, K = shape
        stacked = {k: w(*s) for k, s in gk._stack_shapes(K, C).items()}
        for k in ("g_i", "g_t"):
            stacked[k] = stacked[k] + 1.0
        return gk.dprnn_stack(plane_of(B, T, Fq, C), w(K, B, Fq, C, scale=0.5), stacked)
    raise ValueError(f"unknown kernel {kernel!r}")


def kernel_digests(gk, device: str = "cuda") -> Dict[str, str]:
    """case -> SHA-256 of the case's outputs, for the ``gru_kernels``
    module ``gk`` (the current one, or an earlier checkout's)."""
    import torch

    out = {}
    for name, (kernel, plane, shape, extra) in CASES.items():
        rng = np.random.default_rng(int.from_bytes(hashlib.sha256(name.encode()).digest()[:8],
                                                   "little"))
        h = hashlib.sha256()
        for t in _case_outputs(gk, kernel, plane, shape, extra, rng, device):
            h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
        out[name] = h.hexdigest()
    return out


def toolchain() -> Dict[str, object]:
    """What the digests depend on besides the sources: the nvcc release
    and the card (its SM count picks the walk's rows per block)."""
    import torch

    from dpdfnet_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    props = torch.cuda.get_device_properties(0)
    return {"nvcc": nvcc, "device": props.name, "sms": props.multi_processor_count}


def compare(got: Dict[str, str], record: dict, here: Dict[str, object]) -> list:
    """Cases whose digest differs from the record (or is missing), each
    with the reason; empty when every case is bit-identical."""
    bad = [f"{k}: digest differs" for k in record["digests"] if got.get(k) != record["digests"][k]]
    bad += [f"{k}: not in the record" for k in got if k not in record["digests"]]
    if bad and here != record["toolchain"]:
        bad.append(f"the record was taken with {record['toolchain']}, this run with {here}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose dpdfnet_tpu_torch is imported")
    ap.add_argument("--write", help="write the digests and the toolchain to this JSON file")
    ap.add_argument("--against", help="exit 1 unless the digests equal this record's")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("mode_off_digest: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    from dpdfnet_tpu_torch.ops import gru_kernels as gk

    if not os.path.abspath(gk.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {gk.__file__}, not the package under {root}")
    here = toolchain()
    digests = kernel_digests(gk)
    print(json.dumps({"root": root, "toolchain": here, "digests": digests}, indent=1))
    if args.write:
        Path(args.write).write_text(json.dumps({"toolchain": here, "digests": digests},
                                               indent=1) + "\n")
    if args.against:
        bad = compare(digests, json.loads(Path(args.against).read_text()), here)
        for line in bad:
            print(f"DIFFERS: {line}")
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
