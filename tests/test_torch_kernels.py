"""The port's kernel modules against the JAX Pallas kernels.

Each wrapper of ``dpdfnet_tpu_torch.ops.gru_kernels`` runs its plain
PyTorch version for CPU tensors; here that is held against the JAX Pallas
kernel in interpret mode at ``precision="highest"`` (as
``tests/test_pallas_gru.py`` runs it), on the same numpy inputs.

Tolerance: atol 1e-5 in float32.  The two sides differ only in summation
order and in the gate sigmoid (the Pallas kernels use
``0.5 * (tanh(x/2) + 1)``, ~6e-8 from ``torch.sigmoid``), which stays
orders of magnitude below 1e-5 over these short recurrences.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against its plain version at the flagship shapes, and
``tests/test_torch_cuda.py`` does the same at small shapes.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dpdfnet_tpu.ops import nn as jax_nn
from dpdfnet_tpu.ops import pallas_gru
from dpdfnet_tpu_torch.models.fuse import _pack_bidir
from dpdfnet_tpu_torch.ops import gru_kernels
from dpdfnet_tpu_torch.ops import nn as tnn

import torch_testing  # noqa: F401  (the thread budget)

ATOL = 1e-5


def _gru_np(rng, I, H):
    return {
        "wi": rng.normal(size=(I, 3 * H)).astype(np.float32) * 0.3,
        "bi": rng.normal(size=(3 * H,)).astype(np.float32) * 0.1,
        "wh": rng.normal(size=(H, 3 * H)).astype(np.float32) * 0.3,
        "bh": rng.normal(size=(3 * H,)).astype(np.float32) * 0.1,
    }


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tp(p):
    return {k: _t(v) for k, v in p.items()}


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _epi_np(rng, cin, C):
    return (rng.normal(size=(cin, C)).astype(np.float32) * 0.3,
            rng.normal(size=(C,)).astype(np.float32) * 0.1,
            rng.normal(size=(C,)).astype(np.float32) * 0.5 + 1.0,
            rng.normal(size=(C,)).astype(np.float32) * 0.1)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,T,I,H", [(11, 13, 16, 16), (20, 5, 32, 16), (16, 8, 16, 32)])
def test_gru_scan_plain_matches_pallas(reverse, N, T, I, H):
    rng = np.random.default_rng(0)
    p = _gru_np(rng, I, H)
    x = rng.normal(size=(N, T, I)).astype(np.float32)
    h0 = rng.normal(size=(N, H)).astype(np.float32) * 0.2

    ys_ref, hl_ref = pallas_gru.gru_scan_tm(
        jnp.swapaxes(jnp.asarray(x), 0, 1), jnp.asarray(h0), *(jnp.asarray(p[k]) for k in
                                                               ("wi", "bi", "wh", "bh")),
        reverse=reverse, precision="highest", interpret=True)
    tp = _tp(p)
    ys, hl = gru_kernels.gru_scan(_t(x), _t(h0), tp["wi"], tp["bi"], tp["wh"], tp["bh"],
                                  reverse=reverse)
    assert ys.shape == (N, T, H) and hl.shape == (N, H)
    np.testing.assert_allclose(ys.numpy(), np.swapaxes(np.asarray(ys_ref), 0, 1), atol=ATOL)
    np.testing.assert_allclose(hl.numpy(), np.asarray(hl_ref), atol=ATOL)


def test_gru_bidir_plain_matches_jax():
    """The plain bidirectional GRU (the unpacked intra recurrence)."""
    rng = np.random.default_rng(2)
    p_fw, p_bw = _gru_np(rng, 16, 8), _gru_np(rng, 16, 8)
    x = rng.normal(size=(11, 7, 16)).astype(np.float32)
    ref = jax_nn.gru_bidir(_jp(p_fw), _jp(p_bw), jnp.asarray(x))
    got = tnn.gru_bidir(_tp(p_fw), _tp(p_bw), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("N,Fq,C", [(20, 13, 8), (11, 5, 16), (17, 8, 16)])
def test_dprnn_intra_plain_matches_pallas(N, Fq, C):
    rng = np.random.default_rng(3)
    p_fw, p_bw = _gru_np(rng, C, C), _gru_np(rng, C, C)
    wfc, bfc, g, bln = _epi_np(rng, 2 * C, C)
    x = rng.normal(size=(N, Fq, C)).astype(np.float32)

    wi2j, wh2j, b2j = pallas_gru._pack_bidir(_jp(p_fw), _jp(p_bw), jnp.float32)
    ref = pallas_gru.dprnn_intra_block(
        jnp.asarray(x), wi2j, wh2j, b2j, jnp.asarray(wfc), jnp.asarray(bfc),
        jnp.asarray(g), jnp.asarray(bln), precision="highest", interpret=True)

    wi2, wh2, b2 = _pack_bidir(_tp(p_fw), _tp(p_bw))
    np.testing.assert_array_equal(wi2.numpy(), np.asarray(wi2j))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(b2j))
    got = gru_kernels.dprnn_intra_block(_t(x), wi2, wh2, b2, _t(wfc), _t(bfc), _t(g), _t(bln))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("B,T,Fq,C", [(2, 13, 7, 8), (3, 6, 5, 16), (1, 9, 11, 16)])
def test_dprnn_inter_plain_matches_pallas(B, T, Fq, C):
    """Port plane [B, T, Fq, C] vs the TPU's time-major [T, B*Fq, C] rows,
    from a nonzero carried hidden; B*Fq is never a tile multiple here."""
    rng = np.random.default_rng(4)
    p = _gru_np(rng, C, C)
    wfc, bfc, g, bln = _epi_np(rng, C, C)
    x = rng.normal(size=(B, T, Fq, C)).astype(np.float32)
    h0 = rng.normal(size=(B, Fq, C)).astype(np.float32) * 0.2

    x_tm = np.transpose(x, (1, 0, 2, 3)).reshape(T, B * Fq, C)
    ref, hl_ref = pallas_gru.dprnn_inter_block(
        jnp.asarray(x_tm), jnp.asarray(h0.reshape(B * Fq, C)),
        *(jnp.asarray(p[k]) for k in ("wi", "bi", "wh", "bh")),
        jnp.asarray(wfc), jnp.asarray(bfc), jnp.asarray(g), jnp.asarray(bln),
        precision="highest", interpret=True)
    tp = _tp(p)
    out, hl = gru_kernels.dprnn_inter_block(
        _t(x), _t(h0), tp["wi"], tp["bi"], tp["wh"], tp["bh"],
        _t(wfc), _t(bfc), _t(g), _t(bln))
    ref4 = np.transpose(np.asarray(ref).reshape(T, B, Fq, C), (1, 0, 2, 3))
    np.testing.assert_allclose(out.numpy(), ref4, atol=ATOL)
    np.testing.assert_allclose(hl.numpy(), np.asarray(hl_ref).reshape(B, Fq, C), atol=ATOL)


def test_launch_counters_count_only_kernel_launches():
    """CPU tensors take the plain version: no launch is counted."""
    gru_kernels.reset_launch_counts()
    rng = np.random.default_rng(5)
    p = _tp(_gru_np(rng, 8, 8))
    gru_kernels.gru_scan(torch.zeros(2, 3, 8), torch.zeros(2, 8), p["wi"], p["bi"],
                         p["wh"], p["bh"])
    gru_kernels.gru_bidir(torch.zeros(2, 3, 8), *_pack_bidir(p, p))
    assert gru_kernels.launch_counts() == {
        "dprnn_intra_block": 0, "dprnn_inter_block": 0, "gru_scan": 0,
        "gru_bidir": 0, "dprnn_stack": 0, "dprnn_intra_block_v2": 0,
        "dprnn_inter_block_v2": 0, "relayout_fm": 0}


def test_wrappers_reject_non_cpu_non_cuda_devices():
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    plain fallback: the wrapper raises."""
    x = torch.zeros(2, 3, 8, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        gru_kernels.gru_scan(x, torch.zeros(2, 8, device="meta"), x, x, x, x)


@pytest.mark.parametrize("N,T,I,H", [(40, 13, 8, 8), (16, 24, 16, 8), (11, 7, 8, 8)])
def test_gru_bidir_plain_matches_pallas(N, T, I, H):
    """The bidirectional GRU's plain version against ``gru_bidir_tm`` at
    the shapes of ``tests/test_pallas_gru.py``; the port's layout is
    batch-major ``[N, L, I]``, the TPU's time-major."""
    rng = np.random.default_rng(2)
    p_fw, p_bw = _gru_np(rng, I, H), _gru_np(rng, I, H)
    x = rng.normal(size=(N, T, I)).astype(np.float32)

    wi2j, wh2j, b2j = pallas_gru._pack_bidir(_jp(p_fw), _jp(p_bw), jnp.float32)
    ys_f, ys_b = pallas_gru.gru_bidir_tm(jnp.swapaxes(jnp.asarray(x), 0, 1), wi2j, wh2j, b2j,
                                         precision="highest", interpret=True)
    got_f, got_b = gru_kernels.gru_bidir(_t(x), *_pack_bidir(_tp(p_fw), _tp(p_bw)))
    assert got_f.shape == (N, T, H) and got_b.shape == (N, T, H)
    np.testing.assert_allclose(got_f.numpy(), np.swapaxes(np.asarray(ys_f), 0, 1), atol=ATOL)
    np.testing.assert_allclose(got_b.numpy(), np.swapaxes(np.asarray(ys_b), 0, 1), atol=ATOL)


def _stack_blocks_np(rng, K, C):
    """K DPRNN block parameter dicts (numpy) in the JAX test's layout."""
    blocks = []
    for _ in range(K):
        wfc_i, bfc_i, g_i, bln_i = _epi_np(rng, 2 * C, C)
        wfc_t, bfc_t, g_t, bln_t = _epi_np(rng, C, C)
        blocks.append({
            "intra": {"fw": _gru_np(rng, C, C), "bw": _gru_np(rng, C, C),
                      "fc": {"w": wfc_i, "b": bfc_i}, "ln": {"g": g_i, "b": bln_i}},
            "inter": {"gru": _gru_np(rng, C, C),
                      "fc": {"w": wfc_t, "b": bfc_t}, "ln": {"g": g_t, "b": bln_t}},
        })
    return blocks


@pytest.mark.parametrize("B,T,Fq,C,K,kmax",
                         [(2, 5, 13, 8, 3, 2),     # K split on the TPU side
                          (3, 4, 16, 16, 2, 4)])   # single TPU call
def test_dprnn_stack_plain_matches_pallas(B, T, Fq, C, K, kmax):
    """``dprnn_stack_plain`` against ``pallas_gru.dprnn_stack`` at both
    parametrisations of ``tests/test_pallas_gru.py``; planes batch-major
    here, time-major there, from random carried hiddens.  atol 2e-5: the
    JAX package's own bound for the stack (K blocks of two recurrences)."""
    from dpdfnet_tpu_torch.models.fuse import pack_stack
    from dpdfnet_tpu_torch.utils.serialization import params_from_jax

    rng = np.random.default_rng(6)
    blocks_np = _stack_blocks_np(rng, K, C)
    x = rng.normal(size=(B, T, Fq, C)).astype(np.float32)
    hs = rng.normal(size=(K, B, Fq, C)).astype(np.float32) * 0.2

    blocks_j = jax.tree_util.tree_map(jnp.asarray, blocks_np)
    for b in blocks_j:
        b["intra"]["packed"] = dict(zip(("wi2", "wh2", "b2"), pallas_gru._pack_bidir(
            b["intra"]["fw"], b["intra"]["bw"], jnp.float32)))
    out_j, hl_j = pallas_gru.dprnn_stack(
        jnp.swapaxes(jnp.asarray(x), 0, 1), jnp.asarray(hs), pallas_gru.pack_stack(blocks_j),
        precision="highest", interpret=True, k_max=kmax)

    blocks_t = params_from_jax(blocks_np, device="cpu")
    for b in blocks_t:
        b["intra"]["packed"] = dict(zip(("wi2", "wh2", "b2"), _pack_bidir(
            b["intra"]["fw"], b["intra"]["bw"])))
    stacked = pack_stack(blocks_t)
    stacked_j = pallas_gru.pack_stack(blocks_j)
    assert stacked.keys() == stacked_j.keys()
    for k in stacked:
        np.testing.assert_array_equal(stacked[k].numpy(), np.asarray(stacked_j[k]), err_msg=k)
    out, hl = gru_kernels.dprnn_stack(_t(x), _t(hs), stacked)
    np.testing.assert_allclose(out.numpy(), np.swapaxes(np.asarray(out_j), 0, 1), atol=2e-5)
    np.testing.assert_allclose(hl.numpy(), np.asarray(hl_j), atol=2e-5)


def test_stacked_forward_spec_matches_jax(monkeypatch):
    """``forward_spec`` with each DPRNN stack as one ``dprnn_stack`` call
    against the JAX forward with its stack kernel (``DPDFNET_TPU_STACK``,
    Pallas in interpret mode, as ``tests/test_pallas_gru.py`` runs it):
    outputs and every state leaf, atol 3e-5."""
    from dpdfnet_tpu.config import get_config as jax_get_config
    from dpdfnet_tpu.models.dpdfnet import forward_spec as jax_forward_spec
    from dpdfnet_tpu.models.fuse import fuse_separable, pack_dprnn_bidir
    from dpdfnet_tpu.models.params import init_params as jax_init_params
    from dpdfnet_tpu.models.state import init_state as jax_init_state
    from dpdfnet_tpu_torch.config import get_config
    from dpdfnet_tpu_torch.models.dpdfnet import forward_spec
    from dpdfnet_tpu_torch.models.fuse import prepare_inference_params
    from dpdfnet_tpu_torch.models.state import init_state
    from dpdfnet_tpu_torch.utils.serialization import params_from_jax
    from dpdfnet_tpu_torch.utils.tree import tree_leaves

    monkeypatch.setenv("DPDFNET_TPU_STACK", "1")
    monkeypatch.setenv("DPDFNET_TPU_PALLAS", "1")
    monkeypatch.setenv("DPDFNET_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(5)
    cfg_j, cfg = jax_get_config("dpdfnet2"), get_config("dpdfnet2")
    p_np = jax.tree_util.tree_map(np.asarray, jax_init_params(cfg_j, seed=3))
    spec = rng.normal(size=(2, 6, cfg.freq_bins, 2)).astype(np.float32)

    fused_j = pack_dprnn_bidir(fuse_separable(p_np, cfg_j), cfg_j)
    assert "dprnn_df_stacked" in fused_j["enc"]
    fwd = jax.jit(jax_forward_spec, static_argnums=1)     # one compile, not per op
    with jax.default_matmul_precision("highest"):
        out_j, st_j, _ = fwd(fused_j, cfg_j, jnp.asarray(spec), jax_init_state(cfg_j, batch=2))

    params = prepare_inference_params(params_from_jax(p_np, device="cpu"), cfg)
    assert "dprnn_erb_stacked" in params["enc"] and "dprnn_df_stacked" in params["enc"]
    calls = []
    real = gru_kernels.dprnn_stack_plain
    monkeypatch.setattr(gru_kernels, "dprnn_stack_plain",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        out_t, st_t, _ = forward_spec(params, cfg, torch.from_numpy(spec),
                                      init_state(cfg, batch=2, device="cpu"))
    assert len(calls) == 2                        # one call per DPRNN branch
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=3e-5)
    lj = {k: np.asarray(v) for k, v in tree_leaves(st_j)}
    for k, v in tree_leaves(st_t):
        np.testing.assert_allclose(v.numpy(), lj[k], atol=3e-5, err_msg=k)


# --------------------------------------------------------------------------- #
# The v2 DPRNN kernels and the bfloat16-plane modes
# --------------------------------------------------------------------------- #

BF16 = torch.bfloat16


def _bf16_np(a):
    """float32 numpy values rounded to bfloat16 (still float32 numpy)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16).float().numpy()


def _assert_bf16_close(got, ref, atol=ATOL):
    """``got`` a bfloat16 tensor within ``atol`` of the bfloat16 JAX array
    ``ref`` under ``gru_kernels.err_beyond_bf16_ulp``."""
    ref = torch.from_numpy(np.asarray(ref.astype(jnp.float32))).to(BF16)
    assert gru_kernels.err_beyond_bf16_ulp(got, ref) < atol


@pytest.mark.parametrize("xp_bf16", [False, True])
@pytest.mark.parametrize("B,T,Fq,C", [(2, 9, 7, 8), (3, 4, 5, 16)])
def test_dprnn_inter_v2_plain_matches_pallas(B, T, Fq, C, xp_bf16):
    """``dprnn_inter_block_v2_plain`` against ``pallas_gru.dprnn_inter_block_v2``
    (interpret mode) on the same precomputed projections, float32 or
    rounded to bfloat16 as the model stores them: atol 1e-5, both sides
    consume identical xp values."""
    rng = np.random.default_rng(21)
    p = _gru_np(rng, C, C)
    wfc, bfc, g, bln = _epi_np(rng, C, C)
    whfc = np.concatenate([p["wh"], wfc], axis=1)
    x = rng.normal(size=(B, T, Fq, C)).astype(np.float32)
    h0 = rng.normal(size=(B, Fq, C)).astype(np.float32) * 0.2
    xp = x @ p["wi"] + p["bi"]
    if xp_bf16:
        xp = _bf16_np(xp)

    def tm(a):
        return jnp.asarray(np.transpose(a, (1, 0, 2, 3)).reshape(T, B * Fq, -1))

    ref, hl_ref = pallas_gru.dprnn_inter_block_v2(
        tm(xp).astype(jnp.bfloat16) if xp_bf16 else tm(xp), tm(x),
        jnp.asarray(h0.reshape(B * Fq, C)), jnp.asarray(whfc), jnp.asarray(p["bh"]),
        jnp.asarray(bfc), jnp.asarray(g), jnp.asarray(bln), precision="highest",
        interpret=True)
    got_xp = _t(xp).to(BF16) if xp_bf16 else _t(xp)
    out, hl = gru_kernels.dprnn_inter_block_v2(got_xp, _t(x), _t(h0), _t(whfc), _t(p["bh"]),
                                               _t(bfc), _t(g), _t(bln))
    ref4 = np.transpose(np.asarray(ref).reshape(T, B, Fq, C), (1, 0, 2, 3))
    np.testing.assert_allclose(out.numpy(), ref4, atol=ATOL)
    np.testing.assert_allclose(hl.numpy(), np.asarray(hl_ref).reshape(B, Fq, C), atol=ATOL)


@pytest.mark.parametrize("xp_bf16,atol", [(False, 1e-5), (True, 2e-3)])
@pytest.mark.parametrize("N,L,C", [(10, 13, 8), (6, 8, 16)])
def test_dprnn_intra_v2_plain_matches_pallas(N, L, C, xp_bf16, atol):
    """``dprnn_intra_block_v2_plain`` against ``pallas_gru.dprnn_intra_block_v2``
    (interpret mode), with ``pack_intra_v2`` equal on both sides.  f32
    projections: atol 1e-5.  bf16 projections: the two sides sum
    ``x . wi_cat`` in different orders before rounding to bfloat16, so a
    value near a rounding midpoint can land one bf16 ulp apart and move the
    recurrence; measured max-abs 4e-4 over these cases, bound 2e-3."""
    rng = np.random.default_rng(22)
    p_fw, p_bw = _gru_np(rng, C, C), _gru_np(rng, C, C)
    wfc, bfc, g, bln = _epi_np(rng, 2 * C, C)
    x = rng.normal(size=(N, L, C)).astype(np.float32)

    wi2j, wh2j, b2j = pallas_gru._pack_bidir(_jp(p_fw), _jp(p_bw), jnp.float32)
    wi_cat_j, wh_big_j = pallas_gru.pack_intra_v2({"wi2": wi2j, "wh2": wh2j}, jnp.asarray(wfc))
    ref = pallas_gru.dprnn_intra_block_v2(
        jnp.asarray(x), wi_cat_j, wh_big_j, b2j, jnp.asarray(bfc), jnp.asarray(g),
        jnp.asarray(bln), precision="highest", interpret=True, xp_bf16=xp_bf16)

    wi2, wh2, b2 = _pack_bidir(_tp(p_fw), _tp(p_bw))
    wi_cat, wh_big = gru_kernels.pack_intra_v2(wi2, wh2, _t(wfc))
    np.testing.assert_array_equal(wi_cat.numpy(), np.asarray(wi_cat_j))
    np.testing.assert_array_equal(wh_big.numpy(), np.asarray(wh_big_j))
    got = gru_kernels.dprnn_intra_block_v2(_t(x), wi_cat, wh_big, b2, _t(bfc), _t(g), _t(bln),
                                           xp_bf16=xp_bf16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)
    # without the xp rounding, v2 is v1's function
    v1 = gru_kernels.dprnn_intra_block(_t(x), wi2, wh2, b2, _t(wfc), _t(bfc), _t(g), _t(bln))
    if not xp_bf16:
        np.testing.assert_allclose(got.numpy(), v1.numpy(), atol=ATOL)


def test_bf16_plane_intra_inter_match_pallas():
    """bfloat16 planes into the v1 intra and inter kernels: the Pallas
    kernels and the plain versions both upcast, compute in float32 and round
    the plane once (h_last stays float32), so the bound is 1e-5 plus one
    bf16 ulp of the output."""
    rng = np.random.default_rng(23)
    C, N, Fq, B, T = 8, 12, 16, 2, 5
    p_fw, p_bw = _gru_np(rng, C, C), _gru_np(rng, C, C)
    wfc, bfc, g, bln = _epi_np(rng, 2 * C, C)
    x = _bf16_np(rng.normal(size=(N, Fq, C)).astype(np.float32))
    wi2j, wh2j, b2j = pallas_gru._pack_bidir(_jp(p_fw), _jp(p_bw), jnp.float32)
    ref = pallas_gru.dprnn_intra_block(
        jnp.asarray(x, jnp.bfloat16), wi2j, wh2j, b2j, jnp.asarray(wfc), jnp.asarray(bfc),
        jnp.asarray(g), jnp.asarray(bln), precision="highest", interpret=True)
    got = gru_kernels.dprnn_intra_block(_t(x).to(BF16), *_pack_bidir(_tp(p_fw), _tp(p_bw)),
                                        _t(wfc), _t(bfc), _t(g), _t(bln))
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    _assert_bf16_close(got, ref)

    p = _gru_np(rng, C, C)
    wfc, bfc, g, bln = _epi_np(rng, C, C)
    x = _bf16_np(rng.normal(size=(B, T, Fq, C)).astype(np.float32))
    h0 = rng.normal(size=(B, Fq, C)).astype(np.float32) * 0.2
    x_tm = np.transpose(x, (1, 0, 2, 3)).reshape(T, B * Fq, C)
    ref, hl_ref = pallas_gru.dprnn_inter_block(
        jnp.asarray(x_tm, jnp.bfloat16), jnp.asarray(h0.reshape(B * Fq, C)),
        *(jnp.asarray(p[k]) for k in ("wi", "bi", "wh", "bh")),
        jnp.asarray(wfc), jnp.asarray(bfc), jnp.asarray(g), jnp.asarray(bln),
        precision="highest", interpret=True)
    tp = _tp(p)
    out, hl = gru_kernels.dprnn_inter_block(_t(x).to(BF16), _t(h0), tp["wi"], tp["bi"],
                                            tp["wh"], tp["bh"], _t(wfc), _t(bfc), _t(g), _t(bln))
    assert out.dtype == BF16 and hl.dtype == torch.float32
    _assert_bf16_close(out, jnp.transpose(ref.reshape(T, B, Fq, C), (1, 0, 2, 3)))
    np.testing.assert_allclose(hl.numpy(), np.asarray(hl_ref).reshape(B, Fq, C), atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_bf16_plane_gru_scan_matches_pallas(reverse):
    """bfloat16 x into ``gru_scan``.  The Pallas kernel then runs in
    bfloat16 throughout (weights and the carried hidden rounded to bf16
    each step); the port keeps float32 weights and hidden and rounds only
    ys.  Measured max-abs 1.6e-2 on ys and h_last here; bound 4e-2."""
    rng = np.random.default_rng(24)
    N, T, I, H = 6, 12, 16, 16
    p = _gru_np(rng, I, H)
    x = _bf16_np(rng.normal(size=(N, T, I)).astype(np.float32))
    h0 = _bf16_np(rng.normal(size=(N, H)).astype(np.float32) * 0.2)
    ys_ref, hl_ref = pallas_gru.gru_scan_tm(
        jnp.swapaxes(jnp.asarray(x, jnp.bfloat16), 0, 1), jnp.asarray(h0, jnp.bfloat16),
        *(jnp.asarray(p[k]) for k in ("wi", "bi", "wh", "bh")),
        reverse=reverse, precision="highest", interpret=True)
    tp = _tp(p)
    ys, hl = gru_kernels.gru_scan(_t(x).to(BF16), _t(h0), tp["wi"], tp["bi"], tp["wh"],
                                  tp["bh"], reverse=reverse)
    assert ys.dtype == BF16 and hl.dtype == torch.float32
    ys_ref = np.swapaxes(np.asarray(ys_ref.astype(jnp.float32)), 0, 1)
    np.testing.assert_allclose(ys.float().numpy(), ys_ref, atol=4e-2)
    np.testing.assert_allclose(hl.numpy(), np.asarray(hl_ref.astype(jnp.float32)), atol=4e-2)


def test_bf16_planes_run_float32_math():
    """Every plain version takes a bfloat16 plane, computes on its float32
    upcast and rounds its plane output once; carried hiddens come back
    float32."""
    rng = np.random.default_rng(25)
    C = 8
    p = _tp(_gru_np(rng, C, C))
    x = torch.from_numpy(rng.normal(size=(2, 5, 3, C)).astype(np.float32)).to(BF16)
    h0 = torch.zeros(2, 3, C)
    epi = tuple(_t(a) for a in _epi_np(rng, C, C))
    out, hl = gru_kernels.dprnn_inter_block(x, h0, p["wi"], p["bi"], p["wh"], p["bh"], *epi)
    ref, hl_ref = gru_kernels.dprnn_inter_block(x.float(), h0, p["wi"], p["bi"], p["wh"],
                                                p["bh"], *epi)
    assert out.dtype == BF16 and hl.dtype == torch.float32
    assert torch.equal(out, ref.to(BF16)) and torch.equal(hl, hl_ref)
