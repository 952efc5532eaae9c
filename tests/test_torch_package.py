"""The port's package surface against the JAX package: configs, parameter
trees, weight carry-over, STFT, model variants, and the port's import and
device rules."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dpdfnet_tpu import config as jax_config
from dpdfnet_tpu.models import params as jax_params
from dpdfnet_tpu.models.dpdfnet import forward_spec as jax_forward_spec
from dpdfnet_tpu.models.state import init_state as jax_init_state
from dpdfnet_tpu.ops import stft as jax_stft
from dpdfnet_tpu.ops.windows import vorbis_window as jax_vorbis_window
from dpdfnet_tpu.utils.serialization import save_params

from dpdfnet_tpu_torch import config
from dpdfnet_tpu_torch.models import params as tparams
from dpdfnet_tpu_torch.models.dpdfnet import forward_spec
from dpdfnet_tpu_torch.models.fuse import prepare_inference_params
from dpdfnet_tpu_torch.models.state import init_state
from dpdfnet_tpu_torch.ops import stft as tstft
from dpdfnet_tpu_torch.ops.windows import vorbis_window
from dpdfnet_tpu_torch.utils.serialization import load_params, params_from_jax
from dpdfnet_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROPS = ("win_len", "freq_bins", "frame_ms", "wnorm", "erb_in_bins", "erb_fstrides",
          "erb_widths", "dprnn_erb_feat", "dprnn_df_feat", "emb_out_dim",
          "enc_emb_in_dim", "dec_f8", "dec_fstrides", "mask_bins")


@pytest.mark.parametrize("name", sorted(jax_config.MODEL_CONFIGS))
def test_config_matches_jax_field_by_field(name):
    cj, ct = jax_config.get_config(name), config.get_config(name)
    fj = {f.name: getattr(cj, f.name) for f in dataclasses.fields(cj)}
    ft = {f.name: getattr(ct, f.name) for f in dataclasses.fields(ct)}
    assert ft == fj
    for prop in _PROPS:
        assert getattr(ct, prop) == getattr(cj, prop), prop
    assert config.DEFAULT_MODEL == jax_config.DEFAULT_MODEL
    with pytest.raises(ValueError):
        config.get_config("nope")


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in tree_leaves(tree)}


@pytest.mark.parametrize("name", ["dpdfnet2", "dpdfnet8_48khz_hr"])
def test_init_params_tree_and_shapes_match_jax(name):
    cj, ct = jax_config.get_config(name), config.get_config(name)
    pj = jax.tree_util.tree_map(np.asarray, jax_params.init_params(cj, seed=0))
    pt = tparams.init_params(ct, seed=0, device="cpu")
    assert _shapes(pt) == _shapes(pj)
    # deterministic from the seed, and the ERB banks are the fixed constants
    again = tparams.init_params(ct, seed=0, device="cpu")
    for (k, a), (_, b) in zip(tree_leaves(pt), tree_leaves(again)):
        assert torch.equal(a, b), k
    np.testing.assert_array_equal(pt["erb_fb"].numpy(), pj["erb_fb"])
    contracted = tparams.contract_params(pt)
    w = contracted["enc"]["dprnn_erb"][0]["inter"]["gru"]["wh"]
    assert torch.linalg.matrix_norm(w, ord=2) <= 0.7 + 1e-5


def test_params_round_trip_through_npz(tmp_path):
    """save_params (JAX) -> load_params (port) gives the same tree, and
    params_from_jax of the in-memory tree agrees leaf for leaf."""
    cfg = jax_config.get_config("dpdfnet2")
    pj = jax_params.init_params(cfg, seed=1)
    pj["enc"]["emb_gru"]["grus"].append(None)          # a '#none' list marker
    path = tmp_path / "p.npz"
    save_params(path, pj)
    loaded = load_params(path, device="cpu")
    direct = params_from_jax(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    assert loaded["enc"]["emb_gru"]["grus"][-1] is None
    assert "b" not in loaded["enc"]["erb_conv0"]        # None dict values are absent
    lj = {k: np.asarray(v) for k, v in tree_leaves(pj)}
    for tree in (loaded, direct):
        lt = {k: v.numpy() for k, v in tree_leaves(tree)}
        assert lt.keys() == lj.keys()
        for k in lj:
            np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)


def test_stft_istft_match_jax():
    rng = np.random.default_rng(0)
    win, hop = 320, 160
    x = rng.normal(size=(2, 4000)).astype(np.float32)
    np.testing.assert_array_equal(vorbis_window(win), jax_vorbis_window(win))
    wj = jnp.asarray(jax_vorbis_window(win))
    wt = torch.from_numpy(vorbis_window(win))
    with jax.default_matmul_precision("highest"):
        sj = jax_stft.stft_matmul(jnp.asarray(x), wj, hop, center=True)
        yj = jax_stft.istft_matmul(sj, wj, hop, center=True)
    st = tstft.stft_matmul(torch.from_numpy(x), wt, hop, center=True)
    yt = tstft.istft_matmul(st, wt, hop, center=True)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    # the generic (scatter) overlap-add agrees with the 50%-overlap fold
    frames = torch.from_numpy(rng.normal(size=(2, 7, 8)).astype(np.float32))
    idx = np.arange(7)[:, None] * 4 + np.arange(8)[None, :]
    ref = np.zeros((2, 32), np.float32)
    np.add.at(ref, (slice(None), idx.reshape(-1)), frames.numpy().reshape(2, -1))
    np.testing.assert_allclose(tstft._overlap_add(frames, 4, 32).numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(tstft._overlap_add(frames[..., :6], 3, 24).numpy(),
                               _ola_np(frames[..., :6].numpy(), 3, 24), atol=1e-6)


def _ola_np(frames, hop, total):
    out = np.zeros((frames.shape[0], total), np.float32)
    for t in range(frames.shape[1]):
        out[:, t * hop:t * hop + frames.shape[2]] += frames[:, t]
    return out


_VARIANTS = {
    "transpose_after_df": dict(upsample="transpose", mask_method="after_df"),
    "grouped_gru_separate": dict(group_gru=4, emb_gru_skip="groupedlinear",
                                 mask_method="separate"),
    "postfilter_atten_lim": dict(post_filter=True),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_forward_spec_variants_match_jax(variant):
    """Options no shipped checkpoint uses (transpose upsampling, grouped
    GRUs, the grouped-linear skip, the other mask methods, post-filter,
    mask floor): raw and prepared params against JAX, atol 3e-5."""
    kw = _VARIANTS[variant]
    cj = dataclasses.replace(jax_config.get_config("dpdfnet2"), **kw)
    ct = dataclasses.replace(config.get_config("dpdfnet2"), **kw)
    pj = jax.tree_util.tree_map(
        np.asarray, jax_params.contract_params(jax_params.init_params(cj, seed=5)))
    rng = np.random.default_rng(9)
    spec = (rng.normal(size=(2, 5, ct.freq_bins, 2)) * 0.05).astype(np.float32)
    atten = np.array([6.0, 20.0], np.float32) if ct.post_filter else None
    fwd = jax.jit(jax_forward_spec, static_argnums=1)
    with jax.default_matmul_precision("highest"):
        out_j, st_j, _ = fwd(pj, cj, jnp.asarray(spec), jax_init_state(cj, batch=2),
                             atten_lim_db=None if atten is None else jnp.asarray(atten))
    raw = params_from_jax(pj, device="cpu")
    for params in (raw, prepare_inference_params(raw, ct)):
        with torch.no_grad():
            out_t, st_t, _ = forward_spec(
                params, ct, torch.from_numpy(spec), init_state(ct, batch=2, device="cpu"),
                atten_lim_db=None if atten is None else torch.from_numpy(atten))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=3e-5)
        lj = dict(tree_leaves(st_j))
        for k, v in tree_leaves(st_t):
            np.testing.assert_allclose(v.numpy(), np.asarray(lj[k]), atol=3e-5, err_msg=k)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of the port in a fresh interpreter and check
    sys.modules; importing the package touches neither CUDA nor torch.cuda."""
    code = r"""
import importlib, pkgutil, sys
import dpdfnet_tpu_torch as pkg
assert "torch.cuda" not in sys.modules or not __import__("torch").cuda.is_initialized()
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib", "dpdfnet_tpu."))
             or n == "dpdfnet_tpu")
assert not bad, bad
import torch
assert not torch.cuda.is_initialized()
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_raise_without_gpu_unless_cpu_requested(tmp_path, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from dpdfnet_tpu_torch import (Engine, MultiStreamEnhancer, StreamEnhancer, api,
                                   audio_io, cli, init_params, init_state)

    cfg = config.get_config("dpdfnet2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params)
    assert Engine(cfg, params, device="cpu").device.type == "cpu"
    # the user-facing entry points: the device is resolved before any model
    # lookup, so nothing is read or fetched
    monkeypatch.setenv("DPDFNET_TPU_MODEL_DIR", str(tmp_path))
    x = np.zeros(1600, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.enhance(x, 16000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.enhance_batch([x], 16000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamEnhancer(model="dpdfnet2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiStreamEnhancer(2, model="dpdfnet2")
    src = tmp_path / "in.wav"
    audio_io.write_wav(src, x, 16000)
    assert cli.main(["enhance", str(src), str(tmp_path / "out.wav")]) == 2
    assert "device='cpu'" in capsys.readouterr().err
    assert not (tmp_path / "out.wav").exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["in.wav"]
