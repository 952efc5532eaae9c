"""The port's tool plumbing that runs without a card: the ablation tools'
``--check`` verdict, the mode-off digest record and the kernel build's
list of sources."""

import json
import math
import re

import pytest
import torch

from dpdfnet_tpu_torch.ops import _build, gru_kernels
from dpdfnet_tpu_torch.tools import (CHECK_TOL, check_failures, mode_off_digest,
                                     production_failures)


@pytest.mark.parametrize("errs,want", [
    ({"full": 0.0, "hlast/tm": CHECK_TOL}, 0),
    ({"full": 0.0, "floor": 2 * CHECK_TOL}, 1),
    ({"full": math.nan, "dot": 1.0}, 2),
])
def test_check_failures_counts_specializations_beyond_tolerance(errs, want):
    lines = []
    assert check_failures(errs, log=lines.append) == want
    assert len(lines) == want


def test_mode_off_record_covers_every_case():
    record = json.loads(mode_off_digest.RECORD.read_text())
    assert set(record["digests"]) == set(mode_off_digest.CASES)
    assert all(len(d) == 64 and int(d, 16) >= 0 for d in record["digests"].values())
    assert set(record["toolchain"]) == {"nvcc", "device", "sms"}


@pytest.mark.parametrize("same,want", [
    ({"rows": True, "tm": True}, 0), ({"rows": True, "tm": False}, 1), ({"rows": False}, 1)])
def test_production_failures_counts_layouts_that_differ(same, want):
    lines = []
    assert production_failures(same, log=lines.append) == want
    assert len(lines) == want


def test_mode_off_ablation_case_names_are_unchanged():
    """The 24 step-ablation cases keep their names (the record's keys) while
    the kernels under them change."""
    intra = ("full", "hlast", "dots", "indep", "gates", "floor", "floor_fb", "floor_fb_bf16")
    inter = ("full", "floor", "dot", "gru", "nogates", "noln", "ln1pass", "ln_bf16")
    want = {f"intra_step_ablation {s}{' tm' if tm else ''} bf16 x[40,16,64]"
            for s in intra for tm in (False, True)}
    want |= {f"inter_step_ablation {s} bf16 x[9,40,64]" for s in inter}
    assert {k for k in mode_off_digest.CASES if "step_ablation" in k} == want
    assert len(mode_off_digest.CASES) == 19 + 24


@pytest.mark.parametrize("lib", sorted(_build.SOURCES))
def test_build_sources_name_every_included_header(lib):
    """A library's file name hashes its main source and the headers listed
    beside it, so an edited header rebuilds it: every header the source
    reaches through ``#include "..."`` is listed, and nothing else."""
    main, headers = _build.SOURCES[lib]
    seen, todo = set(), [main]
    while todo:
        text = (_build.CSRC / todo.pop()).read_text()
        for h in re.findall(r'^#include "([^"]+)"', text, flags=re.M):
            if h not in seen:
                seen.add(h)
                todo.append(h)
    assert seen == set(headers)


def test_mode_off_compare_names_each_difference():
    record = {"toolchain": {"nvcc": "a", "device": "b", "sms": 1},
              "digests": {"k1": "0" * 64, "k2": "1" * 64}}
    assert mode_off_digest.compare(dict(record["digests"]), record, record["toolchain"]) == []
    bad = mode_off_digest.compare({"k1": "0" * 64, "k2": "2" * 64, "k3": "3" * 64}, record,
                                  {"nvcc": "c", "device": "b", "sms": 1})
    assert bad[:2] == ["k2: digest differs", "k3: not in the record"]
    assert "taken with" in bad[2]


def test_mode_off_digests_repeat_on_the_cpu(monkeypatch):
    """On CPU tensors the wrappers run their plain versions: the digests
    are deterministic, and differ between cases (the inputs differ)."""
    small = {k: v for k, v in mode_off_digest.CASES.items() if "x[896" in k or "x[8,112,48" in k}
    monkeypatch.setattr(mode_off_digest, "CASES", small)
    torch.set_num_threads(1)
    a = mode_off_digest.kernel_digests(gru_kernels, device="cpu")
    b = mode_off_digest.kernel_digests(gru_kernels, device="cpu")
    assert a == b and len(set(a.values())) == len(small) >= 4


def test_ln_bf16_slack_covers_a_last_bit_change_upstream():
    """ln_bf16 rounds its statistics' terms to bfloat16: moving y by one
    float32 ulp (another summation order) moves the output beyond a bf16
    ulp, and ln_bf16_slack covers that move."""
    from dpdfnet_tpu_torch.tools import inter_step_ablation as tinter

    torch.set_num_threads(1)
    x, h0, wp, bp, tail = tinter.make_inputs(4096, 8, 64, "cpu", seed=0)
    w = tinter._weights(wp, bp, tail)
    wi, bi, wh, bh, wfc, bfc, g, bln = w
    h, ys = h0, []
    for t in range(x.shape[0]):
        h = gru_kernels.gru_cell({"wh": wh, "bh": bh}, x[t].float() @ wi + bi, h)
        ys.append(h @ wfc + bfc)
    y = torch.stack(ys)

    def ln_bf16(y):
        mu = y.to(torch.bfloat16).float().sum(-1, keepdim=True) / 64
        d = y - mu
        var = (d * d).to(torch.bfloat16).float().sum(-1, keepdim=True) / 64
        return (x.float() + d * torch.rsqrt(var + 1e-5) * g + bln).to(x.dtype)

    ref = ln_bf16(y)
    assert torch.equal(ref, tinter.inter_plain("ln_bf16", x, h0, *w)[0])
    away = torch.where(torch.rand(y.shape, generator=torch.Generator().manual_seed(1)) < 0.5,
                       -math.inf, math.inf)
    moved = ln_bf16(torch.nextafter(y, away))
    assert gru_kernels.err_beyond_bf16_ulp(moved, ref) > CHECK_TOL
    assert gru_kernels.err_beyond_bf16_ulp(moved, ref, tinter.ln_bf16_slack(x, h0, *w)) <= 0


def test_mode_off_ablation_cases_repeat_on_the_cpu(monkeypatch):
    """The step-ablation kernels' digest cases (every specialization, both
    intra layouts) run their tools' plain versions on CPU tensors:
    deterministic, and a distinct digest per case."""
    abl = {k: v for k, v in mode_off_digest.CASES.items() if "step_ablation" in k}
    assert len(abl) == 24
    monkeypatch.setattr(mode_off_digest, "CASES", abl)
    torch.set_num_threads(1)
    a = mode_off_digest.kernel_digests(gru_kernels, device="cpu")
    assert a == mode_off_digest.kernel_digests(gru_kernels, device="cpu")
    # rows and tm layouts of one intra specialization give one function
    assert len(set(a.values())) >= 16


@pytest.mark.parametrize("B,T,Fq,K", [(2, 3, 8, 2), (1, 1, 13, 3)])
def test_stack_chain_is_the_stacks_function(B, T, Fq, K):
    """kernel_ab's yardstick for the stack, K x (intra + inter) block by
    block over all T frames, computes the stack's function: on the CPU
    (plain versions) it agrees with dprnn_stack_plain, which runs frame by
    frame, to float32 reordering."""
    import numpy as np

    from dpdfnet_tpu_torch.models.fuse import pack_stack
    from dpdfnet_tpu_torch.tools import kernel_ab

    torch.set_num_threads(1)
    rng = np.random.default_rng(3)
    C = 64

    def t(*shape, scale):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32)

    def gru():
        return {"wi": t(C, 3 * C, scale=C ** -0.5), "bi": t(3 * C, scale=0.1),
                "wh": t(C, 3 * C, scale=C ** -0.5), "bh": t(3 * C, scale=0.1)}

    blocks, intra, inter = [], [], []
    for _ in range(K):
        wi2, wh2, b2 = gru_kernels._pack_bidir(gru(), gru())
        fc_i, ln_i = (t(2 * C, C, scale=0.1), t(C, scale=0.1)), (1 + t(C, scale=0.2), t(C, scale=0.1))
        g = gru()
        fc_t, ln_t = (t(C, C, scale=0.1), t(C, scale=0.1)), (1 + t(C, scale=0.2), t(C, scale=0.1))
        blocks.append({"intra": {"packed": {"wi2": wi2, "wh2": wh2, "b2": b2},
                                 "fc": {"w": fc_i[0], "b": fc_i[1]}, "ln": {"g": ln_i[0], "b": ln_i[1]}},
                       "inter": {"gru": g, "fc": {"w": fc_t[0], "b": fc_t[1]},
                                 "ln": {"g": ln_t[0], "b": ln_t[1]}}})
        intra.append((wi2, wh2, b2, *fc_i, *ln_i))
        inter.append((g["wi"], g["bi"], g["wh"], g["bh"], *fc_t, *ln_t))
    x, h0 = t(B, T, Fq, C, scale=1.0), t(K, B, Fq, C, scale=0.5)
    out, hs = kernel_ab.stack_chain(gru_kernels, x, h0, intra, inter)
    ref, hl = gru_kernels.dprnn_stack_plain(x, h0, pack_stack(blocks))
    assert (out - ref).abs().max().item() < 1e-5
    assert (torch.stack(hs) - hl).abs().max().item() < 1e-5
