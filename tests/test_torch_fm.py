"""The kernels' freq-major ("fm") layout modes against the JAX package,
and the port's one DPRNN route against every route of the JAX package's.

Each kernel mode's plain version (what a CPU tensor runs) against the
Pallas kernel in interpret mode at ``precision="highest"``, as
``tests/test_pallas_gru.py`` runs them, on the same numpy inputs: the
entry relayout (bit-exact), the intra stage's ``fm_batch`` mode and the
inter stage's ``fm_batch`` / ``h_bm`` / deferred-tail modes.  Then the
JAX package's fm exit contraction ``grouped_linear_fm`` against the
port's ``grouped_linear`` of the permuted plane, the port's ``_dprnn``
against the JAX ``_dprnn_fused`` under each of its switch settings, one
forward at B = 32, where the JAX fm chain engages, and a check that the
six JAX switches the port retired move nothing in it.

Tolerances: 1e-5 max-abs in float32 (the two sides differ in summation
order and in the gate sigmoid's form, ~6e-8); a bfloat16 plane adds one
bf16 ulp of the reference (``gru_kernels.err_beyond_bf16_ulp``: both
sides compute in float32 and round the plane once).  The forward: 1e-4,
the bound of ``tests/test_torch_engine.py``.
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

from torch_testing import jax_params_np

ATOL = 1e-5
BF16 = torch.bfloat16
# the JAX package's switches of its fm chain and bf16 planes, which the
# port does not read
FM_ENV = ("DPDFNET_TPU_INTRA_TM", "DPDFNET_TPU_ENTRY_RELAYOUT", "DPDFNET_TPU_H_INGEST",
          "DPDFNET_TPU_INTER_DEFER", "DPDFNET_TPU_INTER_TS", "DPDFNET_TPU_PLANE_IO")


@pytest.fixture(autouse=True)
def _fm_env(monkeypatch):
    """Each test starts from the JAX switches' defaults (DPDFNET_TPU_INTRA_TM
    on, the others off)."""
    for name in FM_ENV:
        monkeypatch.delenv(name, raising=False)


def _gru_np(rng, I, H):
    return {"wi": rng.normal(size=(I, 3 * H)).astype(np.float32) * 0.3,
            "bi": rng.normal(size=(3 * H,)).astype(np.float32) * 0.1,
            "wh": rng.normal(size=(H, 3 * H)).astype(np.float32) * 0.3,
            "bh": rng.normal(size=(3 * H,)).astype(np.float32) * 0.1}


def _epi_np(rng, cin, C):
    return (rng.normal(size=(cin, C)).astype(np.float32) * 0.3,
            rng.normal(size=(C,)).astype(np.float32) * 0.1,
            rng.normal(size=(C,)).astype(np.float32) * 0.5 + 1.0,
            rng.normal(size=(C,)).astype(np.float32) * 0.1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _bf16_np(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16).float().numpy()


@pytest.mark.parametrize("B,T,F,C,dt_out", [
    (32, 16, 40, 64, None),          # the JAX kernel path, dtype kept
    (8, 8, 48, 64, "bfloat16"),      # the JAX kernel path with the cast folded in
    (12, 16, 40, 64, None),          # B % 8 != 0: the JAX transpose fallback
    (32, 10, 40, 64, None),          # T % 8 != 0: the JAX transpose fallback
])
def test_relayout_fm_plain_matches_pallas(B, T, F, C, dt_out):
    """Bit-exact, on the four shapes of ``tests/test_pallas_gru.py``."""
    x = np.random.default_rng(5).normal(size=(B, T, F, C)).astype(np.float32)
    kw = {} if dt_out is None else {"out_dtype": jnp.dtype(dt_out)}
    ref = pallas_gru.relayout_fm(jnp.asarray(x), interpret=True, **kw)
    got = gru_kernels.relayout_fm(_t(x), out_dtype=None if dt_out is None else BF16)
    assert got.shape == (F, T, B, C) and got.is_contiguous()
    assert got.dtype == (torch.float32 if dt_out is None else BF16)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("Tt,B,Fq,C", [(5, 4, 16, 8), (3, 8, 13, 8)])
def test_intra_fm_plain_matches_pallas(Tt, B, Fq, C):
    """``fm_batch=B``: ``[Fq, T*B, C]`` in, ``[T, Fq, B, C]`` out; T, B and
    Fq all differ, so a swapped stride shows."""
    rng = np.random.default_rng(10)
    p_fw, p_bw = _gru_np(rng, C, C), _gru_np(rng, C, C)
    epi = _epi_np(rng, 2 * C, C)
    x = rng.normal(size=(Fq, Tt * B, C)).astype(np.float32)
    wi2j, wh2j, b2j = pallas_gru._pack_bidir(_j(p_fw), _j(p_bw), jnp.float32)
    ref = pallas_gru.dprnn_intra_block_tm(jnp.asarray(x), wi2j, wh2j, b2j,
                                          *map(jnp.asarray, epi), precision="highest",
                                          interpret=True, fm_batch=B)
    wi2, wh2, b2 = _pack_bidir({k: _t(v) for k, v in p_fw.items()},
                               {k: _t(v) for k, v in p_bw.items()})
    got = gru_kernels.dprnn_intra_block(_t(x), wi2, wh2, b2, *map(_t, epi), fm_batch=B)
    assert got.shape == (Tt, Fq, B, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def _inter_case(rng, Fq, B, T, C, h_bm, bf16=False):
    p = _gru_np(rng, C, C)
    epi = _epi_np(rng, C, C)
    x = rng.normal(size=(T, Fq * B, C)).astype(np.float32)
    if bf16:
        x = _bf16_np(x)
    h0 = rng.normal(size=(B, Fq, C) if h_bm else (Fq * B, C)).astype(np.float32) * 0.2
    return p, epi, x, h0


@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("h_bm", [False, True])
def test_inter_fm_plain_matches_pallas(monkeypatch, h_bm, defer):
    """``fm_batch=B`` with the hidden in the rows' order or the state's
    ``[B, Fq, C]`` (``h_bm``), with the fused tail or the deferred one
    (``defer=`` to the port, ``DPDFNET_TPU_INTER_DEFER`` to the JAX side;
    T = 6 gives the JAX kernel two steps per cell, so its defer engages)."""
    Fq, B, T, C = 12, 4, 6, 8
    monkeypatch.setenv("DPDFNET_TPU_INTER_DEFER", "1" if defer else "0")
    assert pallas_gru._inter_defer() == defer
    p, epi, x, h0 = _inter_case(np.random.default_rng(11), Fq, B, T, C, h_bm)
    ref, hl_ref = pallas_gru.dprnn_inter_block(
        jnp.asarray(x), jnp.asarray(h0), *(jnp.asarray(p[k]) for k in ("wi", "bi", "wh", "bh")),
        *map(jnp.asarray, epi), precision="highest", interpret=True, fm_batch=B, h_bm=h_bm)
    out, hl = gru_kernels.dprnn_inter_block(_t(x), _t(h0), *(_t(p[k]) for k in
                                                             ("wi", "bi", "wh", "bh")),
                                            *map(_t, epi), fm_batch=B, h_bm=h_bm, defer=defer)
    assert out.shape == (Fq, T, B, C) and hl.shape == h0.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(hl.numpy(), np.asarray(hl_ref), atol=ATOL)
    # the deferred plain form alone is the raw hidden sequence
    raw, _ = gru_kernels.dprnn_inter_block_plain(
        _t(x), _t(h0), *(_t(p[k]) for k in ("wi", "bi", "wh", "bh")), *map(_t, epi),
        fm_batch=B, h_bm=h_bm, defer=True)
    ys, _ = gru_kernels.gru_scan_plain(
        _t(x).reshape(T, Fq * B, C).transpose(0, 1),
        (_t(h0).transpose(0, 1).reshape(Fq * B, C) if h_bm else _t(h0)),
        *(_t(p[k]) for k in ("wi", "bi", "wh", "bh")))
    np.testing.assert_array_equal(raw.numpy(),
                                  ys.reshape(Fq, B, T, C).transpose(1, 2).numpy())


@pytest.mark.parametrize("defer,atol", [(False, ATOL), (True, 3e-2)])
def test_inter_fm_bf16_plane_matches_pallas(monkeypatch, defer, atol):
    """A bfloat16 plane through the fm inter stage; h_last stays float32.
    Fused tail: both sides compute in float32 and round the plane once, so
    1e-5 plus one bf16 ulp.  Deferred tail: both sides also round the raw
    hidden to bfloat16 before its fc (the JAX package's order), and a
    float32 difference of ~1e-7 can flip one such rounding, which the fc
    and LayerNorm carry to a few 1e-3 before the output rounds (measured
    1.4e-2 beyond one output ulp here): bound 3e-2 beyond one ulp.  That
    the port rounds the hidden at all is checked exactly below."""
    Fq, B, T, C = 8, 4, 4, 8
    monkeypatch.setenv("DPDFNET_TPU_INTER_DEFER", "1" if defer else "0")
    p, epi, x, h0 = _inter_case(np.random.default_rng(12), Fq, B, T, C, True, bf16=True)
    ref, hl_ref = pallas_gru.dprnn_inter_block(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(h0),
        *(jnp.asarray(p[k]) for k in ("wi", "bi", "wh", "bh")), *map(jnp.asarray, epi),
        precision="highest", interpret=True, fm_batch=B, h_bm=True)
    out, hl = gru_kernels.dprnn_inter_block(_t(x).to(BF16), _t(h0),
                                            *(_t(p[k]) for k in ("wi", "bi", "wh", "bh")),
                                            *map(_t, epi), fm_batch=B, h_bm=True, defer=defer)
    assert out.dtype == BF16 and hl.dtype == torch.float32
    ref_t = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(BF16)
    assert gru_kernels.err_beyond_bf16_ulp(out, ref_t) < atol
    np.testing.assert_allclose(hl.numpy(), np.asarray(hl_ref), atol=ATOL)
    if defer:
        w = tuple(_t(p[k]) for k in ("wi", "bi", "wh", "bh"))
        raw, _ = gru_kernels.dprnn_inter_block_plain(_t(x).to(BF16), _t(h0), *w, *map(_t, epi),
                                                     fm_batch=B, h_bm=True, defer=True)
        x_out = _t(x).to(BF16).reshape(T, Fq, B, C).transpose(0, 1)
        assert raw.dtype == BF16
        assert torch.equal(out, gru_kernels.inter_tail(raw, x_out, *map(_t, epi)))
        raw32, _ = gru_kernels.dprnn_inter_block_plain(_t(x), _t(h0), *w, *map(_t, epi),
                                                       fm_batch=B, h_bm=True, defer=True)
        assert not torch.equal(out, gru_kernels.inter_tail(raw32, x_out, *map(_t, epi)))


@pytest.mark.parametrize("F,T,B,C,G,OG", [
    (16, 3, 4, 8, 4, 6),     # whole-f groups (ig = 4*C)
    (6, 3, 4, 8, 4, 5),      # supergroups: ig = 12, C = 8 -> P = 3, Q = 2
    (8, 2, 5, 64, 16, 16),   # df_fc_emb's shape class: ig = 32 < C (P = 1, Q = 2)
])
def test_grouped_linear_fm_matches_jax(F, T, B, C, G, OG):
    """The JAX package's fm exit contraction of the ``[F, T, B, C]`` plane
    equals the port's ``grouped_linear`` of the same plane permuted to
    ``[B, T, F*C]``, the port's one route."""
    rng = np.random.default_rng(5)
    plane = rng.normal(size=(F, T, B, C)).astype(np.float32)
    p = {"w": rng.normal(size=(G, F * C // G, OG)).astype(np.float32) * 0.2,
         "b": rng.normal(size=(G * OG,)).astype(np.float32)}
    ref = jax_nn.grouped_linear_fm(_j(p), jnp.asarray(plane), act="relu")
    flat = _t(plane).permute(2, 1, 0, 3).reshape(B, T, F * C)
    got = tnn.grouped_linear({k: _t(v) for k, v in p.items()}, flat, act="relu")
    assert got.shape == (B, T, G * OG)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def _blocks_np(rng, K, C):
    """K DPRNN blocks; LayerNorm gains near 0.3, so the residual chain
    stays near unit scale and 1e-5 is a float32 bound there."""
    blocks = []
    for _ in range(K):
        wfc_i, bfc_i, g_i, bln_i = _epi_np(rng, 2 * C, C)
        wfc_t, bfc_t, g_t, bln_t = _epi_np(rng, C, C)
        g_i, g_t = 0.3 * g_i, 0.3 * g_t
        blocks.append({
            "intra": {"fw": _gru_np(rng, C, C), "bw": _gru_np(rng, C, C),
                      "fc": {"w": wfc_i, "b": bfc_i}, "ln": {"g": g_i, "b": bln_i}},
            "inter": {"gru": _gru_np(rng, C, C),
                      "fc": {"w": wfc_t, "b": bfc_t}, "ln": {"g": g_t, "b": bln_t}},
        })
    return blocks


@pytest.mark.parametrize("env", [
    {"DPDFNET_TPU_INTRA_TM": "1"},
    {"DPDFNET_TPU_INTRA_TM": "1", "DPDFNET_TPU_ENTRY_RELAYOUT": "1"},
    {"DPDFNET_TPU_INTRA_TM": "0"},
    {"DPDFNET_TPU_INTRA_TM": "0", "DPDFNET_TPU_ENTRY_RELAYOUT": "1"},
    {"DPDFNET_TPU_INTRA_TM": "1", "DPDFNET_TPU_H_INGEST": "1", "DPDFNET_TPU_INTER_DEFER": "1"},
], ids=["tm", "tm-relayout", "rowmajor", "rowmajor-relayout", "tm-hingest-defer"])
def test_dprnn_chain_matches_jax_fused(monkeypatch, env):
    """The port's one ``_dprnn`` route against the JAX ``_dprnn_fused``
    (Pallas in interpret mode) under each id's switches, at B = 32, where
    the JAX fm chain engages with ``DPDFNET_TPU_INTRA_TM=1``: the output
    (the JAX fm plane permuted to ``[B, T, Fq, C]``) and every new hidden,
    1e-5."""
    from dpdfnet_tpu.models import dpdfnet as jmd
    from dpdfnet_tpu_torch.models import dpdfnet as tmd
    from dpdfnet_tpu_torch.utils.serialization import params_from_jax

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DPDFNET_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(13)
    B, T, Fq, C, K = 32, 2, 16, 8, 2
    blocks_np = _blocks_np(rng, K, C)
    x = rng.normal(size=(B, T, Fq, C)).astype(np.float32) * 0.5
    hs = [rng.normal(size=(B, Fq, C)).astype(np.float32) * 0.2 for _ in range(K)]

    blocks_j = jax.tree_util.tree_map(jnp.asarray, blocks_np)
    for b in blocks_j:
        b["intra"]["packed"] = dict(zip(("wi2", "wh2", "b2"), pallas_gru._pack_bidir(
            b["intra"]["fw"], b["intra"]["bw"], jnp.float32)))
    with jax.default_matmul_precision("highest"):
        ref, hs_ref, layout_ref = jmd._dprnn_fused(blocks_j, jnp.asarray(x),
                                                   [jnp.asarray(h) for h in hs], out_fm=True)

    blocks_t = params_from_jax(blocks_np, device="cpu")
    for b in blocks_t:
        b["intra"]["packed"] = dict(zip(("wi2", "wh2", "b2"), _pack_bidir(
            b["intra"]["fw"], b["intra"]["bw"])))
    got, hs_got = tmd._dprnn(blocks_t, _t(x), [_t(h) for h in hs])
    assert layout_ref == ("fm" if env["DPDFNET_TPU_INTRA_TM"] == "1" else "bt")
    ref = np.asarray(ref)
    if layout_ref == "fm":
        ref = ref.transpose(2, 1, 0, 3)
    assert got.shape == ref.shape == (B, T, Fq, C)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    for a, b in zip(hs_got, hs_ref):
        assert a.dtype == torch.float32 and a.shape == (B, Fq, C)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_fm_forward_spec_matches_jax(monkeypatch):
    """The port's ``forward_spec`` at B = 32 on ``dpdfnet2_48khz_hr``
    against the JAX forward on its default route there (Fq 40 and 48, so
    both JAX DPRNN branches take the fm chain and its encoder contracts
    both fm planes with ``grouped_linear_fm``), its Pallas kernels in
    interpret mode: output and every state leaf, 1e-4."""
    from dpdfnet_tpu.config import get_config as jax_get_config
    from dpdfnet_tpu.models.dpdfnet import forward_spec as jax_forward_spec
    from dpdfnet_tpu.models.fuse import fuse_separable, pack_dprnn_bidir
    from dpdfnet_tpu.models.state import init_state as jax_init_state
    from dpdfnet_tpu_torch.config import get_config
    from dpdfnet_tpu_torch.models import dpdfnet as tmd
    from dpdfnet_tpu_torch.models.fuse import prepare_inference_params
    from dpdfnet_tpu_torch.models.state import init_state
    from dpdfnet_tpu_torch.utils.serialization import params_from_jax
    from dpdfnet_tpu_torch.utils.tree import tree_leaves

    monkeypatch.setenv("DPDFNET_TPU_PALLAS", "1")
    monkeypatch.setenv("DPDFNET_TPU_PALLAS_INTERPRET", "1")
    assert pallas_gru.intra_tm_enabled()                  # the JAX default route
    name, B, T = "dpdfnet2_48khz_hr", 32, 2
    cfg_j, cfg = jax_get_config(name), get_config(name)
    p_np = jax_params_np(name)
    spec = (0.3 * np.random.default_rng(6).normal(size=(B, T, cfg.freq_bins, 2))
            ).astype(np.float32)
    fwd = jax.jit(jax_forward_spec, static_argnums=1)     # one compile, not per op
    with jax.default_matmul_precision("highest"):
        out_j, st_j, _ = fwd(pack_dprnn_bidir(fuse_separable(p_np, cfg_j), cfg_j),
                             cfg_j, jnp.asarray(spec), jax_init_state(cfg_j, batch=B))

    params = prepare_inference_params(params_from_jax(p_np, device="cpu"), cfg)
    with torch.no_grad():
        out_t, st_t, _ = tmd.forward_spec(params, cfg, torch.from_numpy(spec),
                                          init_state(cfg, batch=B, device="cpu"))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4)
    lj = {k: np.asarray(v) for k, v in tree_leaves(st_j)}
    for k, v in tree_leaves(st_t):
        np.testing.assert_allclose(v.numpy(), lj[k], atol=1e-4, err_msg=k)


def test_port_has_one_dprnn_route(monkeypatch):
    """The six JAX switches of the fm chain and the bf16 planes move nothing
    in the port: at B = 32 under ``"default"`` (where both would have
    engaged), ``forward_spec`` with every one of them set is bit-equal to
    ``forward_spec`` without them, and no intra call takes a layout mode."""
    from dpdfnet_tpu_torch.config import get_config
    from dpdfnet_tpu_torch.models import dpdfnet as tmd
    from dpdfnet_tpu_torch.models.fuse import prepare_inference_params
    from dpdfnet_tpu_torch.models.state import init_state
    from dpdfnet_tpu_torch.utils.serialization import params_from_jax
    from dpdfnet_tpu_torch.utils.tree import tree_leaves

    name, B, T = "dpdfnet2_48khz_hr", 32, 2
    cfg = get_config(name)
    params = prepare_inference_params(params_from_jax(jax_params_np(name), device="cpu"), cfg)
    spec = torch.from_numpy((0.3 * np.random.default_rng(7).normal(
        size=(B, T, cfg.freq_bins, 2))).astype(np.float32))
    modes = []
    real = gru_kernels.dprnn_intra_block
    monkeypatch.setattr(gru_kernels, "dprnn_intra_block",
                        lambda *a, **kw: modes.append(kw.get("fm_batch")) or real(*a, **kw))

    def run():
        with torch.no_grad():
            return tmd.forward_spec(params, cfg, spec, init_state(cfg, batch=B, device="cpu"),
                                    precision="default")

    out, st, _ = run()
    for name_, value in zip(FM_ENV, ("1", "1", "1", "1", "2", "bf16")):
        monkeypatch.setenv(name_, value)
    out_set, st_set, _ = run()
    assert modes and not any(modes)
    assert torch.equal(out_set, out)
    for (k, a), (_, b) in zip(tree_leaves(st_set), tree_leaves(st)):
        assert torch.equal(a, b), k
