"""The port's checkpoint converter against the JAX package's.

No zoo ``.pth`` is in the repository, so the state dicts are synthetic:
``tools.synth_checkpoint`` writes the reference layout (offline names, or
the streaming GRUCell names) from a parameter tree.  The trees are random
contracted weights (``init_params`` + ``contract_params``) as numpy
arrays, drawn by the port's ``init_params``, whose tree and shapes are the
JAX package's (``test_torch_package.py``; the JAX package's eager
``init_params`` spends seconds in CPU compiles per config), with every 1-D
leaf (BN scale / shift, biases, LayerNorm) drawn from a numpy seed so that
no converter sees only ones and zeros; the BatchNorm running statistics are
drawn from a seed too, so the fold rounds.  Every config runs, plus
``dpdfnet2`` with transposed-conv upsampling, grouped GRUs and the
grouped-linear skip (no shipped config has them).

Tolerance: 1e-7 max-abs, array for array, between the two converters (both
fold BatchNorm in float32 with the same operations; every other layer is
a re-layout); bit equality for the round trip with exact BatchNorm
statistics (``synth_checkpoint`` with ``seed=None``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import torch

from dpdfnet_tpu.config import get_config as jax_get_config
from dpdfnet_tpu.models import convert as jax_convert

from dpdfnet_tpu_torch.config import MODEL_CONFIGS, get_config
from dpdfnet_tpu_torch.models import convert
from dpdfnet_tpu_torch.models.params import contract_params, init_params
from dpdfnet_tpu_torch.tools import synth_checkpoint
from dpdfnet_tpu_torch.utils.tree import tree_leaves, tree_map

import torch_testing  # noqa: F401  (the thread budget)

TOL = 1e-7
VARIANT = "dpdfnet2+transpose+group_gru+skip"
CONFIGS = sorted(MODEL_CONFIGS) + [VARIANT]


def _cfgs(name):
    """(port config, JAX config) of a name; the variant is dpdfnet2 with
    every optional layer the converter knows."""
    if name != VARIANT:
        return get_config(name), jax_get_config(name)
    extra = dict(upsample="transpose", group_gru=4, emb_gru_skip="groupedlinear")
    return (dataclasses.replace(get_config("dpdfnet2"), **extra),
            dataclasses.replace(jax_get_config("dpdfnet2"), **extra))


@functools.lru_cache(maxsize=None)
def _source(name):
    """Contracted random weights, 1-D leaves drawn from a seed, as numpy
    arrays."""
    cfg, _ = _cfgs(name)
    rng = np.random.default_rng(11)

    def leaf(path, x):
        x = x.numpy()
        if x.ndim == 1 and not {"erb_fb", "erb_inv_fb"} & set(path.split("/")):
            return (rng.normal(size=x.shape) * 0.5).astype(np.float32)
        return x

    return tree_map(leaf, contract_params(init_params(cfg, seed=2, device="cpu")))


def _flat(tree):
    return {k: np.asarray(v) for k, v in tree_leaves(
        jax.tree_util.tree_map(np.asarray, tree))}


def _port_flat(tree):
    return {k: v.numpy() for k, v in tree_leaves(tree)}


@pytest.mark.parametrize("streaming", [False, True], ids=["offline", "streaming"])
@pytest.mark.parametrize("name", CONFIGS)
def test_convert_matches_jax(name, streaming):
    cfg, jcfg = _cfgs(name)
    sd = synth_checkpoint.state_dict_from_params(_source(name), cfg, streaming=streaming,
                                                 seed=4)
    assert any(".grucell." in k for k in sd) == streaming
    ours = _port_flat(convert.convert_state_dict(sd, cfg, strict=True, device="cpu"))
    theirs = _flat(jax_convert.convert_state_dict(sd, jcfg, strict=True))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == np.float32 and ours[k].shape == theirs[k].shape, k
        assert np.abs(ours[k] - theirs[k]).max(initial=0.0) <= TOL, k


@pytest.mark.parametrize("name", CONFIGS)
def test_round_trip_is_exact(name):
    """Exact BatchNorm statistics: the converted tree is the source tree,
    bit for bit, every leaf contiguous float32 on the device asked for."""
    cfg, _ = _cfgs(name)
    src = _flat(_source(name))
    got = convert.convert_state_dict(
        synth_checkpoint.state_dict_from_params(_source(name), cfg), cfg, device="cpu")
    for k, v in tree_leaves(got):
        assert v.device.type == "cpu" and v.dtype == torch.float32 and v.is_contiguous(), k
    got = _port_flat(got)
    assert got.keys() == src.keys()
    for k in got:
        assert np.array_equal(got[k], src[k]), k


@pytest.mark.parametrize("streaming", [False, True], ids=["offline", "streaming"])
def test_surplus_and_missing_keys_raise_in_both(streaming):
    name = "dpdfnet2"
    cfg, jcfg = _cfgs(name)
    sd = synth_checkpoint.state_dict_from_params(_source(name), cfg, streaming=streaming)
    surplus = dict(sd, **{"enc.extra_layer.weight": np.zeros((3, 3), np.float32)})
    for fn in (lambda d, **kw: convert.convert_state_dict(d, cfg, device="cpu", **kw),
               lambda d, **kw: jax_convert.convert_state_dict(d, jcfg, **kw)):
        with pytest.raises(ValueError, match="unconverted checkpoint keys"):
            fn(surplus)
        fn(surplus, strict=False)                     # not strict: the key is ignored
    missing = {k: v for k, v in sd.items() if not k.startswith("enc.dprnn_df.blocks.1.")}
    with pytest.raises(KeyError):
        convert.convert_state_dict(missing, cfg, device="cpu")
    with pytest.raises(KeyError):
        jax_convert.convert_state_dict(missing, jcfg)


def test_erb_fb_mismatch_raises_in_both():
    name = "dpdfnet2"
    cfg, jcfg = _cfgs(name)
    sd = synth_checkpoint.state_dict_from_params(_source(name), cfg)
    sd["erb_fb"] = sd["erb_fb"] * 1.01
    with pytest.raises(ValueError, match="erb_fb differs"):
        convert.convert_state_dict(sd, cfg, device="cpu")
    with pytest.raises(ValueError, match="erb_fb differs"):
        jax_convert.convert_state_dict(sd, jcfg)


@pytest.mark.parametrize("name", ["dpdfnet2", "dpdfnet8_48khz_hr"])
def test_pth_io_through_load_params(name, tmp_path):
    """A ``.pth`` written with ``torch.save`` loads through the port's
    ``load_params`` as the JAX package's reads it."""
    cfg, jcfg = _cfgs(name)
    path = tmp_path / f"{name}.pth"
    synth_checkpoint.save_checkpoint(path, _source(name), cfg, streaming=True, seed=9)
    raw = convert.load_torch_checkpoint(path)
    assert raw["enc.erb_conv0.2.num_batches_tracked"].dtype == torch.int64
    assert raw["enc.erb_conv0.2.num_batches_tracked"].dim() == 0
    ours = _port_flat(convert.load_params(path, cfg, device="cpu"))
    theirs = _flat(jax_convert.load_params(path, jcfg))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert np.abs(ours[k] - theirs[k]).max(initial=0.0) <= TOL, k


def test_default_device_is_cuda():
    """``device=None`` is the card: without one the converter raises
    rather than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, _ = _cfgs("baseline")
    sd = synth_checkpoint.state_dict_from_params(_source("baseline"), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.convert_state_dict(sd, cfg)
