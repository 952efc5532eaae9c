"""The port's step-ablation tools against the JAX package's.

Each specialization's plain version (``dpdfnet_tpu_torch.tools.*``, what a
CPU tensor runs) against the JAX tool's ``build(variant, ...,
interpret=True)`` for the variants that map onto it, on the same numpy
inputs at tiny sizes.  The JAX tools are loaded by path (``tools/`` is not
a package).  Inputs follow the port tools' contract: packed
direction-blockdiag intra weights, and an inter gate matrix with the
production packing's zero blocks; the JAX tools draw those at random as
timing stand-ins, and on these inputs compute the same functions.

Tolerances: 1e-5 max-abs on float32 planes; a bfloat16 plane adds one bf16
ulp of the reference (``gru_kernels.err_beyond_bf16_ulp``).  Variants whose
JAX output holds no comparable value are listed in ``NOT_COMPARED`` with
the reason; their kernels are held against their plain versions on the
card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dpdfnet_tpu_torch.ops import gru_kernels
from dpdfnet_tpu_torch.tools import inter_step_ablation as tinter
from dpdfnet_tpu_torch.tools import intra_step_ablation as tintra

import torch_testing  # noqa: F401  (the thread budget)

ATOL = 1e-5
BF16 = torch.bfloat16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_INTRA = _load("intra_step_ablation")
JAX_INTER = _load("inter_step_ablation")

NOT_COMPARED = {
    "tm_pg": "TPU-only packed-gate dot on arbitrary slices of wi / wh (maps to full)",
    "tm_pg_ch16": "TPU-only packed-gate dot on arbitrary slices of wi / wh (maps to full)",
    "tm_pg_static": "TPU-only packed-gate dot on arbitrary slices of wi / wh (maps to full)",
    "tm_xp2dot_bf16": "TPU-only bfloat16 MXU operands: rounds Wi (maps to full)",
    "tm_minimal": "its output is uninitialised scratch (maps to floor_fb)",
    "tm_prex2": "stores each backward hidden at its step index instead of its position "
                "(scrb[base + k]), so its epilogue pairs h_fw(t) with h_bw(T-1-t): full's "
                "work with another pairing (maps to full)",
    "lnmxu1": "interpret mode runs its DEFAULT-precision dots in float32, so the JAX run "
              "has float32 statistics; the bf16 operands exist on the TPU only "
              "(ln_bf16 is held on the card)",
}


def _jax_variant_names(src_path, pattern):
    """Every variant name the JAX tool's source tests for."""
    with open(src_path) as f:
        src = f.read()
    return set(re.findall(pattern, src))


def test_every_jax_variant_maps_to_a_specialization():
    intra_names = _jax_variant_names(os.path.join(ROOT, "tools", "intra_step_ablation.py"),
                                     r'"((?:tm_|no_|dots_|gates_|indep_|minimal|full|twodot|'
                                     r'pair)[a-z0-9_]*)"')
    intra_names = {n for n in intra_names if not n.endswith("_")}    # prefix tests
    assert len(intra_names) >= 25
    for name in intra_names | {"pair", "pair2", "pair4"}:
        spec, layout = tintra.specialization(name)
        assert spec in tintra.SPECS and layout in ("rows", "tm"), name
    inter_names = {"full", "floor0", "floor", "dotonly", "dotgates", "noln", "fcfused",
                   "nofc", "nogates", "ln1pass", "lnmxu", "lnmxu1"}
    assert inter_names == set(tinter.VARIANTS)
    for name in inter_names:
        assert tinter.specialization(name) in tinter.SPECS
    with pytest.raises(ValueError):
        tintra.specialization("no_such_variant")


# --------------------------------------------------------------------------- #
# intra
# --------------------------------------------------------------------------- #

ROWS, TI, C, TILE = 8, 16, 8, 8


def _intra_inputs(dtype):
    x, w = tintra.make_inputs(ROWS, TI, C, "cpu", dtype=dtype, seed=3)
    wi2, wh2, b2, wfc, bfc, g, bln = w
    gen = torch.Generator().manual_seed(4)
    # a non-trivial LayerNorm (the tools draw gain 1, shift 0)
    g = 1.0 + 0.3 * torch.randn(C, generator=gen)
    bln = 0.1 * torch.randn(C, generator=gen)
    return x, (wi2, wh2, b2, wfc, bfc, g, bln)


def _jax_intra(variant, x, w, dtype):
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    _, layout = tintra.specialization(variant)
    xn = x.float().numpy()
    if variant in ("tm_minimal", "tm_prex2"):
        xtm = np.swapaxes(xn, 0, 1)
        xv = np.concatenate([xtm, xtm[::-1]], axis=-1)
    elif layout == "tm":
        xv = np.swapaxes(xn, 0, 1)
    else:
        xv = xn
    wi2, wh2, b2, wfc, bfc, g, bln = (t.numpy() for t in w)
    call = JAX_INTRA.build(variant, ROWS, TI, C, TILE, jdt, interpret=True)
    out = call(jnp.asarray(np.ascontiguousarray(xv), jdt), jnp.asarray(wi2), jnp.asarray(wh2),
               jnp.asarray(b2), jnp.asarray(wfc), jnp.asarray(bfc[None]), jnp.asarray(g[None]),
               jnp.asarray(bln[None]))
    return torch.from_numpy(np.array(out.astype(jnp.float32))).to(dtype)


def _close(got, ref):
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert gru_kernels.err_beyond_bf16_ulp(got, ref) < ATOL


INTRA_COMPARED = sorted(n for n in tintra.VARIANTS if n not in NOT_COMPARED) + ["pair2",
                                                                              "pair4"]


@pytest.mark.parametrize("variant", INTRA_COMPARED)
def test_intra_specialization_matches_jax_tool(variant):
    spec, layout = tintra.specialization(variant)
    x, w = _intra_inputs(torch.float32)
    ref = _jax_intra(variant, x, w, torch.float32)
    tm = layout == "tm"
    got = tintra.run_intra(spec, x.transpose(0, 1).contiguous() if tm else x, *w, tm=tm)
    if spec.startswith("floor_fb"):
        ref = ref[0]                  # the JAX tm floors write out[0] only
    elif variant.startswith("pair"):
        sub = TILE // (int(variant[4:]) if len(variant) > 4 else 2)
        keep = (torch.arange(ROWS) % TILE) < sub   # only the first tile/P rows of each tile
        ref, got = ref[keep], got[keep]
    _close(got, ref)


@pytest.mark.parametrize("variant", ["full", "tm_full", "no_ys_stores", "dots_only",
                                     "gates_only", "minimal", "tm_floor", "tm_floor_bf16"])
def test_intra_specialization_bf16_plane_matches_jax_tool(variant):
    spec, layout = tintra.specialization(variant)
    x, w = _intra_inputs(BF16)
    ref = _jax_intra(variant, x, w, BF16)
    tm = layout == "tm"
    got = tintra.run_intra(spec, x.transpose(0, 1).contiguous() if tm else x, *w, tm=tm)
    _close(got, ref[0] if spec.startswith("floor_fb") else ref)


def test_intra_launch_counter_counts_kernels_only():
    x, w = _intra_inputs(torch.float32)
    tintra.run_intra.launches = 0
    tintra.run_intra("full", x, *w)
    assert tintra.run_intra.launches == 0


# --------------------------------------------------------------------------- #
# inter
# --------------------------------------------------------------------------- #

RE, TE, H, TILE_E, TS = 8, 8, 8, 8, 4


def _inter_inputs(dtype):
    x, h0, wp, bp, (wfc, bfc, g, bln) = tinter.make_inputs(RE, TE, H, "cpu", dtype=dtype,
                                                           seed=5)
    gen = torch.Generator().manual_seed(6)
    g = 1.0 + 0.3 * torch.randn(H, generator=gen)
    bln = 0.1 * torch.randn(H, generator=gen)
    return x, h0, wp, bp, (wfc, bfc, g, bln)


def _jax_inter(variant, x, h0, wp, bp, tail, dtype):
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    wfc, bfc, g, bln = (t.numpy() for t in tail)
    jm = np.full((H, 128), 1.0 / H, np.float32)
    call = JAX_INTER.build(variant, RE, TE, H, TILE_E, TS, jdt, interpret=True)
    out, hl = call(jnp.asarray(h0.numpy()[None]), jnp.asarray(x.float().numpy(), jdt),
                   jnp.asarray(wp.numpy()), jnp.asarray(bp.numpy()[None]), jnp.asarray(wfc),
                   jnp.asarray(bfc[None]), jnp.asarray(g[None]), jnp.asarray(bln[None]),
                   jnp.asarray(jm))
    return (torch.from_numpy(np.array(out.astype(jnp.float32))).to(dtype),
            torch.from_numpy(np.array(hl[0])))


INTER_COMPARED = sorted(n for n in tinter.VARIANTS if n not in NOT_COMPARED)


@pytest.mark.parametrize("variant", INTER_COMPARED)
def test_inter_specialization_matches_jax_tool(variant):
    x, h0, wp, bp, tail = _inter_inputs(torch.float32)
    ref, hl_ref = _jax_inter(variant, x, h0, wp, bp, tail, torch.float32)
    out, hl = tinter.run_inter(tinter.specialization(variant), x, h0,
                               *tinter.unpack_wp(wp, bp), *tail)
    _close(out, ref)
    _close(hl, hl_ref)


@pytest.mark.parametrize("variant", ["full", "floor0", "dotonly", "nogates", "noln"])
def test_inter_specialization_bf16_plane_matches_jax_tool(variant):
    x, h0, wp, bp, tail = _inter_inputs(BF16)
    ref, hl_ref = _jax_inter(variant, x, h0, wp, bp, tail, BF16)
    out, hl = tinter.run_inter(tinter.specialization(variant), x, h0,
                               *tinter.unpack_wp(wp, bp), *tail)
    _close(out, ref)
    _close(hl, hl_ref)


def test_inter_ln_bf16_rounds_its_statistics():
    """``ln_bf16`` (the Hopper form of ``lnmxu1``) differs from ``full`` only
    through the bfloat16 rounding of its LayerNorm terms: by less than
    that rounding can move a normalised value, and not at all once the
    terms are bfloat16-exact."""
    x, h0, wp, bp, tail = _inter_inputs(torch.float32)
    w = tinter.unpack_wp(wp, bp)
    full, _ = tinter.inter_plain("full", x, h0, *w, *tail)
    lnb, _ = tinter.inter_plain("ln_bf16", x, h0, *w, *tail)
    d = (full - lnb).abs().max().item()
    assert 0 < d < 5e-2
    with pytest.raises(ValueError, match="must be zero"):
        bad = wp.clone()
        bad[H, 2 * H] = 1.0
        tinter.unpack_wp(bad, bp)
