"""The port's model forward against the JAX package.

Weights: the JAX package's ``init_params`` + ``contract_params`` (weight
statistics of a trained checkpoint), carried across with
``params_from_jax``.  Inputs come from numpy seeds.  JAX runs on the CPU on
its plain path (``pallas_gru.enabled()`` is false off the TPU); the port
runs on ``device="cpu"``, where every kernel wrapper takes its plain
version.

The "prepared" cases run the port's ``prepare_inference_params`` tree
(fused convs, packed DPRNN weights; the port leaves out the JAX
package's fold of the 48 kHz plane, ``PERF.md``) against the JAX
forward on the raw tree; ``test_torch_fold.py`` holds the port's
``fold_hr_tail`` tree against JAX's folded tree.

Tolerance: 3e-5 max-abs on ``spec_e`` and on every state leaf,
  the bound the JAX package's own fused-vs-plain test uses.  Both sides are
  float32; they differ in summation order, in the EMA associative-scan
  tree, and (prepared params) in the fused conv weights.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dpdfnet_tpu.config import get_config as jax_get_config
from dpdfnet_tpu.models import dpdfnet as jax_dpdfnet
from dpdfnet_tpu.models.dpdfnet import forward_spec as jax_forward_spec
from dpdfnet_tpu.models.state import init_state as jax_init_state

from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.models import dpdfnet as tdpdfnet
from dpdfnet_tpu_torch.models.dpdfnet import forward_spec
from dpdfnet_tpu_torch.models.fuse import prepare_inference_params
from dpdfnet_tpu_torch.models.state import init_state
from dpdfnet_tpu_torch.utils.serialization import params_from_jax
from dpdfnet_tpu_torch.utils.tree import tree_leaves

from torch_testing import jax_params_np

CONFIGS = ["dpdfnet2", "dpdfnet8_48khz_hr"]


def _leaves(tree):
    return {k: np.asarray(v) for k, v in tree_leaves(tree)}


def _state_to_torch(st):
    return {k: ([torch.tensor(np.asarray(u)) for u in v] if isinstance(v, list)
                else torch.tensor(np.asarray(v))) for k, v in st.items()}


@functools.lru_cache(maxsize=None)
def _jax_reference(name):
    """One JAX run per config: a T=1 frame from the fresh state, then T=6
    frames from the state it leaves (a carried state that is not fresh)."""
    cfg = jax_get_config(name)
    p_np = jax_params_np(name)
    rng = np.random.default_rng(7)
    B = 2
    spec1 = (rng.normal(size=(B, 1, cfg.freq_bins, 2)) * 0.05).astype(np.float32)
    spec6 = (rng.normal(size=(B, 6, cfg.freq_bins, 2)) * 0.05).astype(np.float32)
    st0 = jax_init_state(cfg, batch=B)
    fwd = jax.jit(jax_forward_spec, static_argnums=1)     # one compile, not per op
    with jax.default_matmul_precision("highest"):
        out1, st1, lsnr1 = fwd(p_np, cfg, jnp.asarray(spec1), st0)
        out6, st6, lsnr6 = fwd(p_np, cfg, jnp.asarray(spec6), st1)
    return p_np, {
        1: (spec1, st0, (np.asarray(out1), np.asarray(lsnr1), _leaves(st1))),
        6: (spec6, st1, (np.asarray(out6), np.asarray(lsnr6), _leaves(st6))),
    }


@pytest.mark.parametrize("prepared", [False, True], ids=["raw", "prepared"])
@pytest.mark.parametrize("T", [6, 1])
@pytest.mark.parametrize("name", CONFIGS)
def test_forward_spec_matches_jax(name, T, prepared):
    cfg = get_config(name)
    p_np, runs = _jax_reference(name)
    spec, st_in, (out_j, lsnr_j, leaves_j) = runs[T]

    params = params_from_jax(p_np, device="cpu")
    if prepared:
        params = prepare_inference_params(params, cfg)
    with torch.no_grad():
        out_t, new_t, lsnr_t = forward_spec(params, cfg, torch.from_numpy(spec),
                                            _state_to_torch(st_in))

    assert out_t.shape == (2, T, cfg.freq_bins, 2)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=3e-5)
    np.testing.assert_allclose(lsnr_t.numpy(), lsnr_j, atol=3e-5)
    leaves_t = _leaves(new_t)
    assert leaves_t.keys() == leaves_j.keys()
    for k in leaves_j:
        np.testing.assert_allclose(leaves_t[k], leaves_j[k], atol=3e-5, err_msg=k)


def test_init_state_matches_jax():
    for name in CONFIGS:
        cfg_j, cfg = jax_get_config(name), get_config(name)
        lj = _leaves(jax_init_state(cfg_j, batch=3))
        lt = _leaves(init_state(cfg, batch=3, device="cpu"))
        assert lj.keys() == lt.keys()
        for k in lj:
            assert lt[k].shape == lj[k].shape, k
            np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)


@pytest.mark.parametrize("position", ["output", "inner"])
@pytest.mark.parametrize("skip", ["identity", "groupedlinear"])
def test_squeezed_gru_skips_match_jax(skip, position):
    """Both reference SqueezedGRU generations and both skips, including the
    grouped-linear skip that sees only the first half of a wider input."""
    rng = np.random.default_rng(13)

    def gl(i, o, g):
        return {"w": rng.normal(size=(g, i // g, o // g)).astype(np.float32) * 0.3,
                "b": rng.normal(size=(o,)).astype(np.float32) * 0.1}

    def gru(i, h):
        return {"wi": rng.normal(size=(i, 3 * h)).astype(np.float32) * 0.3,
                "bi": rng.normal(size=(3 * h,)).astype(np.float32) * 0.1,
                "wh": rng.normal(size=(h, 3 * h)).astype(np.float32) * 0.3,
                "bh": rng.normal(size=(3 * h,)).astype(np.float32) * 0.1}

    I, H = (16, 16) if skip == "identity" else (32, 16)
    p = {"lin_in": gl(I, H, 4), "grus": [gru(H, H), gru(H, H)], "lin_out": gl(H, 16, 4)}
    if skip == "groupedlinear":
        p["skip"] = gl(16, 16, 4)
    x = rng.normal(size=(2, 5, I)).astype(np.float32)
    hs = [rng.normal(size=(2, H)).astype(np.float32) * 0.2 for _ in range(2)]
    ref, ref_hs = jax_dpdfnet._squeezed_gru(p, jnp.asarray(x), [jnp.asarray(h) for h in hs],
                                            skip=skip, skip_position=position)
    tp = params_from_jax(p, device="cpu")
    got, got_hs = tdpdfnet._squeezed_gru(tp, torch.from_numpy(x),
                                         [torch.from_numpy(h) for h in hs],
                                         skip=skip, skip_position=position)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    for a, b in zip(got_hs, ref_hs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
