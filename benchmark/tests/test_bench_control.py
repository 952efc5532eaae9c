"""The control of ``correct`` on the card, at a size a test run holds: the
reference with TF32 on, in the program's place, fails each live and
offline cell's limits, and the program on the card passes them.  Marked
``cuda``; skipped where no card is present (TF32 exists only there).

    python -m pytest benchmark/tests/test_bench_control.py -q
"""

import numpy as np
import pytest
import torch

from helpers import ROOT, SEED, TINY, run_module

from benchmark.harness import check, weights
from benchmark.harness.cells import Spec

CELLS = ("hr8.offline", "hr8.live", "dn2.live")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TF32 and the port's kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_tf32_control_fails_the_limits(workload):
    dev = _card()
    spec = Spec(ROOT)
    cell = spec.cell(workload)
    cfg = spec.config(cell["config"])
    mix = dict(spec.traffic(cell["traffic"]), **TINY[spec.traffic(cell["traffic"])["kind"]])
    if mix["kind"] == "offline":
        mix.update(median_s=2.0, min_s=1.5, max_s=3.0)
    params = weights.make(cfg, SEED, dev)
    kind = spec.kind(mix["kind"])
    inputs = kind.generate(mix, cfg, SEED, dev)
    due = kind.planned(inputs, 2.0)
    want = kind.references(params, cfg, inputs, due, dev)
    got = kind.references(params, cfg, inputs, due, dev, tf32=True)
    ok, table = check.verdict(check.numbers(got, want), spec.limits(workload))
    assert not ok, table


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_program_on_the_card_passes(workload):
    _card()
    spec = Spec(ROOT)
    cell = spec.cell(workload)
    kind = spec.traffic(cell["traffic"])["kind"]
    out = run_module().run_cell(spec, cell, SEED, 2.0, False, device="cuda",
                                mix_override=TINY[kind])
    assert out["correct"], out["check"]
    assert np.isfinite(list(out["metrics"].values())[0]["value"])
