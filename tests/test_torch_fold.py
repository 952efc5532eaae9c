"""The port's frequency fold of the 48 kHz plane (``models.fuse.fold_hr_tail``,
``ops.nn.subpixel_block(fold=True)``, the folded encoder and decoder
branches) and ``models.dpdfnet.step`` against the JAX package.

The port's ``prepare_inference_params`` leaves the fold out (the JAX
package's folds; ``PERF.md``), so the folded tree here is built as
the JAX function builds it: ``fuse_separable``, ``fold_hr_tail``,
``pack_dprnn_bidir``.

Weights and inputs are those of ``tests/test_torch_model.py`` (the JAX
package's ``init_params`` + ``contract_params``, seed 3; spectra from numpy
seeds), and its cached JAX run on the raw tree supplies the carried state
that the T=6 runs start from.  JAX runs on the CPU on its plain path; the
port on ``device="cpu"``.

Tolerances:
- the fold itself copies weights and writes zeros: array for array equal;
- ``subpixel_block(fold=True)``: 1e-6 (one conv, float32);
- the port's folded forward against the JAX folded forward: 3e-5 on the
  output and every state leaf, as ``test_torch_model.py``;
- the port's folded tree against its own unfolded tree: 1e-6 absolute plus
  1e-6 relative (the output differs by about 7e-9; the DPRNN hiddens, of
  magnitude about 1, by a few float32 ulps, since erb_conv1 sums its taps
  in another order).
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dpdfnet_tpu.config import get_config as jax_get_config
from dpdfnet_tpu.models import fuse as jax_fuse
from dpdfnet_tpu.models.dpdfnet import step as jax_step
from dpdfnet_tpu.models.dpdfnet import forward_spec as jax_forward_spec
from dpdfnet_tpu.ops import nn as jax_nn

from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.models import fuse
from dpdfnet_tpu_torch.models.dpdfnet import forward_spec, step
from dpdfnet_tpu_torch.ops import nn as onn
from dpdfnet_tpu_torch.utils.serialization import params_from_jax
from dpdfnet_tpu_torch.utils.tree import tree_leaves

from test_torch_model import _jax_reference, _leaves, _state_to_torch
from torch_testing import jax_params_np

HR = ["dpdfnet2_48khz_hr", "dpdfnet8_48khz_hr"]
FLAGSHIP = "dpdfnet8_48khz_hr"
FOLDED = {"enc": ("erb_conv0_folded", "erb_conv1_folded"),
          "erb_dec": ("conv0p_folded", "conv0_out_folded", "convt1_folded")}


def _structure(tree, path=""):
    """Every path of a tree with whether its leaf is ``None``."""
    if isinstance(tree, dict):
        return {q: n for k, v in tree.items() for q, n in _structure(v, f"{path}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {q: n for i, v in enumerate(tree) for q, n in _structure(v, f"{path}{i}/").items()}
    return {path[:-1]: tree is None}


@pytest.mark.parametrize("name", HR)
def test_fold_hr_tail_equals_jax_array_for_array(name):
    cfg_j, cfg = jax_get_config(name), get_config(name)
    fused_j = jax_fuse.fuse_separable(jax_params_np(name), cfg_j)
    folded_j = jax_fuse.fold_hr_tail(fused_j, cfg_j)
    folded_t = fuse.fold_hr_tail(params_from_jax(fused_j, device="cpu"), cfg)
    assert _structure(folded_t) == _structure(folded_j)
    for branch, keys in FOLDED.items():
        assert set(keys) <= set(folded_t[branch])
    assert folded_t["enc"]["erb_conv0_folded"]["w"].shape == (3, 3, 3, 192)
    assert folded_t["enc"]["erb_conv1_folded"]["w"].shape == (1, 2, 192, 64)
    assert folded_t["erb_dec"]["conv0p_folded"]["w"].shape == (1, 1, 1, 192)
    assert folded_t["erb_dec"]["conv0_out_folded"]["w"].shape == (1, 3, 192, 3)
    lj = dict(tree_leaves(folded_j))
    for k, v in tree_leaves(folded_t):
        np.testing.assert_array_equal(v.numpy(), np.asarray(lj[k]), err_msg=k)


@pytest.mark.parametrize("variant", ["dpdfnet2", "transpose"])
def test_fold_hr_tail_is_the_identity_where_jax_folds_nothing(variant):
    if variant == "dpdfnet2":
        cfg_j, cfg = jax_get_config("dpdfnet2"), get_config("dpdfnet2")
        src = "dpdfnet2"
    else:
        src = "dpdfnet2_48khz_hr"
        cfg_j = dataclasses.replace(jax_get_config(src), upsample="transpose")
        cfg = dataclasses.replace(get_config(src), upsample="transpose")
    p_np = jax_params_np(src)
    params = params_from_jax(p_np, device="cpu")
    assert fuse.fold_hr_tail(params, cfg) is params
    assert jax_fuse.fold_hr_tail(p_np, cfg_j) is p_np


def test_fold_hr_tail_raises_on_a_raw_tree():
    name = "dpdfnet2_48khz_hr"
    params = params_from_jax(jax_params_np(name), device="cpu")
    with pytest.raises(ValueError, match="fuse_separable"):
        fuse.fold_hr_tail(params, get_config(name))
    with pytest.raises(ValueError, match="fuse_separable"):
        jax_fuse.fold_hr_tail(jax_params_np(name), jax_get_config(name))


def test_subpixel_block_fold_matches_jax():
    name = FLAGSHIP
    cfg_j, cfg = jax_get_config(name), get_config(name)
    folded = jax_fuse.fold_hr_tail(jax_fuse.fuse_separable(jax_params_np(name), cfg_j), cfg_j)
    p_j = folded["erb_dec"]["convt1_folded"]
    x = np.random.default_rng(11).normal(size=(2, 3, 160, cfg.conv_ch)).astype(np.float32)
    _, kfc = cfg.conv_kernel
    ref = jax_nn.subpixel_block(p_j, jnp.asarray(x), kf=kfc, fstride=3, act="relu", fold=True)
    got = onn.subpixel_block(params_from_jax(p_j, device="cpu"), torch.from_numpy(x),
                             kf=kfc, fstride=3, act="relu", fold=True)
    assert got.shape == (2, 3, 160, 3 * cfg.conv_ch)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    unfolded = params_from_jax(folded["erb_dec"]["convt1"], device="cpu")
    with pytest.raises(ValueError, match="w_fm"):
        onn.subpixel_block({"w": unfolded["w_fm"]}, torch.from_numpy(x), kf=kfc,
                           fstride=3, fold=True)


@functools.lru_cache(maxsize=None)
def _jax_folded_runs():
    """The JAX folded tree (``prepare_inference_params``) on the inputs of
    ``test_torch_model``: ``step`` on the T=1 frame from the fresh state,
    ``forward_spec`` on the T=6 frames from the raw run's carried state."""
    cfg = jax_get_config(FLAGSHIP)
    p_np, runs = _jax_reference(FLAGSHIP)
    folded = jax_fuse.prepare_inference_params(p_np, cfg)
    assert "erb_conv0_folded" in folded["enc"]
    spec1, st0, _ = runs[1]
    spec6, st1, _ = runs[6]
    with jax.default_matmul_precision("highest"):
        o1, s1, l1 = jax.jit(jax_step, static_argnums=1)(folded, cfg, jnp.asarray(spec1[:, 0]), st0)
        o6, s6, l6 = jax.jit(jax_forward_spec, static_argnums=1)(folded, cfg,
                                                                 jnp.asarray(spec6), st1)
    return {1: (spec1, st0, (np.asarray(o1)[:, None], np.asarray(l1)[:, None], _leaves(s1))),
            6: (spec6, st1, (np.asarray(o6), np.asarray(l6), _leaves(s6)))}


def _folded(params, cfg):
    """The JAX package's ``prepare_inference_params`` order: fuse, fold, pack."""
    return fuse.pack_dprnn_bidir(fuse.fold_hr_tail(fuse.fuse_separable(params, cfg), cfg), cfg)


@functools.lru_cache(maxsize=None)
def _port_trees():
    """(folded, unfolded): the port's ``prepare_inference_params`` leaves the
    fold out, so its tree is the unfolded one."""
    cfg = get_config(FLAGSHIP)
    raw = params_from_jax(_jax_reference(FLAGSHIP)[0], device="cpu")
    return _folded(raw, cfg), fuse.prepare_inference_params(raw, cfg)


def _run(params, spec, st):
    with torch.no_grad():
        out, new, lsnr = forward_spec(params, get_config(FLAGSHIP), torch.from_numpy(spec),
                                      _state_to_torch(st))
    return out.numpy(), lsnr.numpy(), _leaves(new)


@pytest.mark.parametrize("T", [1, 6])
def test_folded_forward_spec_matches_jax_folded(T):
    folded, _ = _port_trees()
    assert "erb_conv0_folded" in folded["enc"] and "conv0_out_folded" in folded["erb_dec"]
    spec, st_in, (out_j, lsnr_j, leaves_j) = _jax_folded_runs()[T]
    out_t, lsnr_t, leaves_t = _run(folded, spec, st_in)
    np.testing.assert_allclose(out_t, out_j, atol=3e-5)
    np.testing.assert_allclose(lsnr_t, lsnr_j, atol=3e-5)
    assert leaves_t.keys() == leaves_j.keys()
    for k in leaves_j:
        np.testing.assert_allclose(leaves_t[k], leaves_j[k], atol=3e-5, err_msg=k)


@pytest.mark.parametrize("T", [1, 6])
def test_folded_forward_spec_matches_unfolded(T):
    folded, unfolded = _port_trees()
    assert "erb_conv0_folded" not in unfolded["enc"]
    spec, st_in, _ = _jax_reference(FLAGSHIP)[1][T]
    out_f, lsnr_f, leaves_f = _run(folded, spec, st_in)
    out_u, lsnr_u, leaves_u = _run(unfolded, spec, st_in)
    np.testing.assert_allclose(out_f, out_u, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(lsnr_f, lsnr_u, atol=1e-6, rtol=1e-6)
    for k in leaves_u:
        np.testing.assert_allclose(leaves_f[k], leaves_u[k], atol=1e-6, rtol=1e-6, err_msg=k)


def test_step_matches_jax_step():
    folded, _ = _port_trees()
    spec, st_in, (out_j, lsnr_j, leaves_j) = _jax_folded_runs()[1]
    with torch.no_grad():
        out_t, new_t, lsnr_t = step(folded, get_config(FLAGSHIP), torch.from_numpy(spec[:, 0]),
                                    _state_to_torch(st_in))
    assert out_t.shape == out_j[:, 0].shape and lsnr_t.shape == (2,)
    np.testing.assert_allclose(out_t.numpy(), out_j[:, 0], atol=3e-5)
    np.testing.assert_allclose(lsnr_t.numpy(), lsnr_j[:, 0], atol=3e-5)
    leaves_t = _leaves(new_t)
    for k in leaves_j:
        np.testing.assert_allclose(leaves_t[k], leaves_j[k], atol=3e-5, err_msg=k)


def test_folded_exact_streaming_is_bit_invariant_to_chunking():
    """Exact streaming on the folded plane (``dpdfnet2_48khz_hr``) gives the
    same bits however the frames are chunked, as on the unfolded plane."""
    from dpdfnet_tpu_torch.runtime.engine import Engine

    name = "dpdfnet2_48khz_hr"
    cfg = get_config(name)
    eng = Engine(cfg, _folded(params_from_jax(jax_params_np(name), device="cpu"), cfg),
                 precision="highest", fuse=False, device="cpu")
    assert "erb_conv0_folded" in eng.params["enc"]
    f = (0.1 * np.random.default_rng(5).normal(size=(2, 6, eng.cfg.win_len))).astype(np.float32)
    outs = []
    for cuts in ([6], [1] * 6, [2, 4]):
        st, ys, pos = eng.init_stream_state(batch=2), [], 0
        for n in cuts:
            y, st = eng.process_frames(f[:, pos:pos + n], st)
            ys.append(y)
            pos += n
        outs.append(np.concatenate(ys, axis=1))
    for y in outs[1:]:
        np.testing.assert_array_equal(y, outs[0])
