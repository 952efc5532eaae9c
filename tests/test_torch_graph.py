"""The logic around the captured streaming programs that the CPU can check:
the graph cache key changes with every switch ``forward_spec`` and the
stream ends read per call (a graph captured under one setting must never
replay under another) and with none of the switches the port retired,
the launch counting around a capture and its replays, and the caller's
ownership of the state ``process_frames`` returns.  The graphs themselves need a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 18).
"""

import numpy as np
import pytest
import torch

from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.models.params import contract_params, init_params
from dpdfnet_tpu_torch.ops import gru_kernels
from dpdfnet_tpu_torch.runtime.engine import Engine, _StateSlot, stream_graph_key
from dpdfnet_tpu_torch.runtime.profile import kernel_launches
from dpdfnet_tpu_torch.utils.tree import tree_leaves

import torch_testing  # noqa: F401  (the thread budget)

# (variable, value, kind, T, precision) of each switch read per call
SWITCHES = {
    "stack": ("DPDFNET_TPU_STACK", "1", "exact", 1, "high"),
    "v2": ("DPDFNET_TPU_PALLAS_V2", "1", "exact", 1, "default"),
    "stream_dft_gemm": ("DPDFNET_TPU_STREAM_DFT_GEMM", "1", "exact", 1, "high"),
}

# (value, kind, T, precision) of each JAX switch the port does not read: the
# freq-major chain's and the bf16 planes', each where it would have engaged
RETIRED = {
    "DPDFNET_TPU_INTRA_TM": ("1", "exact", 1, "high"),
    "DPDFNET_TPU_ENTRY_RELAYOUT": ("1", "vec", 8, "high"),
    "DPDFNET_TPU_H_INGEST": ("1", "vec", 8, "high"),
    "DPDFNET_TPU_INTER_DEFER": ("1", "vec", 8, "high"),
    "DPDFNET_TPU_INTER_TS": ("1", "vec", 8, "high"),
    "DPDFNET_TPU_PLANE_IO": ("bf16", "exact", 1, "default"),
}


@pytest.fixture(scope="module")
def engine():
    cfg = get_config("dpdfnet2")
    return Engine(cfg, contract_params(init_params(cfg, seed=0, device="cpu")), device="cpu")


@pytest.fixture
def clean_env(monkeypatch):
    for var in [v[0] for v in SWITCHES.values()] + list(RETIRED):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.delenv("DPDFNET_TPU_STATE_F32H", raising=False)
    return monkeypatch


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_graph_key_changes_with_each_switch(engine, clean_env, switch):
    var, value, kind, T, precision = SWITCHES[switch]
    st = engine.init_stream_state(batch=2)
    off = stream_graph_key(kind, 2, T, precision, st)
    clean_env.setenv(var, value)
    on = stream_graph_key(kind, 2, T, precision, st)
    assert on != off
    n = 2 if kind == "exact" else 3
    assert on[:n] == off[:n]                    # the JAX key itself is the same


@pytest.mark.parametrize("var", list(RETIRED))
def test_graph_key_ignores_retired_variables(engine, clean_env, var):
    """The key holds only what the port reads; INTER_TS is set with
    INTER_DEFER on, where it would have turned the deferred tail off."""
    value, kind, T, precision = RETIRED[var]
    st = engine.init_stream_state(batch=2)
    if var == "DPDFNET_TPU_INTER_TS":
        clean_env.setenv("DPDFNET_TPU_INTER_DEFER", "1")
    before = stream_graph_key(kind, 2, T, precision, st)
    clean_env.setenv(var, value)
    assert stream_graph_key(kind, 2, T, precision, st) == before


def test_graph_key_changes_under_force_disabled_and_with_the_state_dtypes(engine, clean_env):
    st = engine.init_stream_state(batch=2)
    key = stream_graph_key("exact", 2, 1, "high", st)
    with gru_kernels.force_disabled():
        assert stream_graph_key("exact", 2, 1, "high", st) != key
    cfg = engine.cfg
    turbo = Engine(cfg, contract_params(init_params(cfg, seed=0, device="cpu")),
                   precision="default", compute_dtype=torch.bfloat16, device="cpu")
    f32h = stream_graph_key("exact", 2, 1, "default", turbo.init_stream_state(batch=2))
    clean_env.setenv("DPDFNET_TPU_STATE_F32H", "0")
    bf16h = stream_graph_key("exact", 2, 1, "default", turbo.init_stream_state(batch=2))
    assert f32h != bf16h
    assert key[:2] == (2, 1)
    assert stream_graph_key("vec", 2, 4, "high", st)[:3] == ("vec", 2, 4)
    assert stream_graph_key("spec", 3, 1, "high", st)[:3] == ("spec", 3, 1)


def test_replay_launch_arithmetic(monkeypatch):
    """A launch recorded into a graph under capture runs nothing and raises
    no counter; what the replays launch is counted from the device trace,
    by kernel symbol."""
    w = gru_kernels.dprnn_intra_block
    saved = w.launches
    try:
        w.launches = 3
        for capturing, want in ((False, 4), (True, 4), (False, 5)):
            monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
            gru_kernels._count_launch(w)
            assert w.launches == want
    finally:
        w.launches = saved
    hop = (["void dprnn_intra_kernel<2, float, ww::StepGru, 0, 0>(float const*, float*)"] * 16
           + ["void dprnn_inter_kernel<1, 1, 1, float>(float const*, float*)"] * 16
           + ["void proj_gemm_kernel<float, float>(float const*)",
              "void gru_recur_cluster_kernel<8, float>(float const*)"] * 5
           + ["Memcpy HtoD (Pageable -> Device)", "void at::native::elementwise_kernel<128>()"])
    assert kernel_launches(200 * hop) == {"dprnn_intra_kernel": 3200,
                                          "dprnn_inter_kernel": 3200,
                                          "gru_recur_cluster_kernel": 1000}
    v2 = ["void dprnn_inter_v2_kernel<2, __nv_bfloat16, float>()", "void dprnn_stack_kernel<2>()"]
    assert kernel_launches(v2) == {"dprnn_inter_v2_kernel": 1, "dprnn_stack_kernel": 1}


def test_process_frames_state_is_the_callers(engine):
    st = engine.init_stream_state(batch=2)
    frames = np.random.default_rng(0).normal(size=(2, 3, engine.cfg.win_len)).astype(np.float32)
    _, new = engine.process_frames(0.1 * frames, st)
    ptrs = {leaf.untyped_storage().data_ptr() for _, leaf in tree_leaves(st)}
    assert not any(leaf.untyped_storage().data_ptr() in ptrs for _, leaf in tree_leaves(new))


def test_state_slot_copies_in_and_out(engine):
    """The graphs' static state takes the caller's state by copy and hands
    out a copy, also when the state stored is the slot's own."""
    g = torch.Generator().manual_seed(0)
    st = engine.init_stream_state(batch=2)
    for _, leaf in tree_leaves(st):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    slot = _StateSlot(st)
    slot.store(st)
    slot.store(slot.state)
    out = slot.dump()
    slot_ptrs = {leaf.untyped_storage().data_ptr() for leaf in slot.leaves}
    for (k, a), (_, b) in zip(tree_leaves(out), tree_leaves(st)):
        assert torch.equal(a, b), k
        assert a.untyped_storage().data_ptr() not in slot_ptrs | {b.untyped_storage().data_ptr()}
