"""The comparison that decides ``correct``.

Once the window has closed, the answers the program gave for the sampled
inputs (a kind's ``Driver.answers``, for what its ``Driver.due`` says was
due; drawn from the seed) are held against the plain reference
(``benchmark/reference/dpdfnet_ref.py``), which the kind's
``references`` runs on the same raw weights and inputs, in float32 with
TF32 off, in blocks of ``BLOCK`` inputs.

Numbers, each worst over the compared answers:

- ``rel_rms``: RMS of the error over the RMS of the reference output;
- ``max_gap``: largest error of one sample over the RMS of the reference
  output;
- ``missing``: compared answers that never came or came short.

The control (``tools/control.py``) puts the reference computed with TF32
on in the program's place.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

from ..reference import dpdfnet_ref as ref

BLOCK = 8


@contextlib.contextmanager
def math_mode(tf32: bool):
    """cuBLAS and cuDNN matmul math for the reference: float32 (TF32 off),
    or TF32 for the control; the previous settings come back on exit."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32)
    m.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        m.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def blocks(keys: List, size: Dict) -> List[List]:
    """``keys`` by ``size``, in blocks of ``BLOCK`` for the reference."""
    order = sorted(keys, key=lambda k: size[k])
    return [order[i:i + BLOCK] for i in range(0, len(order), BLOCK)]


def numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """The compared numbers of ``got`` against ``want`` (key by key)."""
    rel, gap, missing = 0.0, 0.0, 0
    for k, w in want.items():
        g = got.get(k)
        if g is None or len(g) != len(w):
            missing += 1
            continue
        r, m = ref.gap(g, w)
        rel, gap = max(rel, r), max(gap, m)
    return {"rel_rms": rel, "max_gap": gap, "missing": float(missing),
            "compared": float(len(want) - missing)}


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """(correct, the numbers beside their limits); ``missing`` has the
    limit 0, and a cell with no compared answer is not correct."""
    table = {name: {"value": nums[name], "limit": limits.get(name, 0.0)}
             for name in ("rel_rms", "max_gap", "missing")}
    ok = nums["compared"] > 0 and all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
