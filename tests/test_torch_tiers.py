"""The port's ``fast`` and ``turbo`` quality tiers against the JAX package's:
offline waveforms, ``forward_spec`` and the tiers' helpers here, the
streaming cases in ``test_torch_tiers_stream.py``.

Weights: the JAX package's ``init_params`` + ``contract_params``, carried
across with ``params_from_jax``; inputs from numpy seeds (the speech-shaped
``speechlike_test_signal`` for waveforms).  The JAX engines run on the CPU
on their plain path; the V2 ``forward_spec`` case runs the JAX fused path
with its Pallas kernels in interpret mode (``DPDFNET_TPU_PALLAS=1``,
``DPDFNET_TPU_PALLAS_INTERPRET=1``), as ``tests/test_pallas_gru.py`` does.

Tolerances:
- waveforms and time frames against the JAX tier: max-abs <= 2e-6 and
  rel_rms (the rms of the difference over the JAX output's rms) <= 3e-3,
  on speech-shaped input (``speechlike_test_signal``), whose enhanced
  output has an rms of about 1e-4 and a peak of about 1e-3 under
  contractive weights.  Measured at most 6.0e-7 max-abs and 8.5e-4
  rel_rms (the 48 kHz model's ``turbo`` frames): the port mirrors the JAX
  casts, and what is left is bf16 rounding at other points (torch's CPU
  matmuls and convs, the kernels' float32 carries against XLA's bf16 GRU
  scan).  The JAX package's envelope of a tier against ``highest``
  (2.0e-4 max-abs, ``docs/performance.md``) is a hundred times wider.
  (On white-noise frames the JAX ``turbo`` tier itself leaves that
  envelope, 5.1e-4 from ``highest`` on the 48 kHz model: that input is not
  what the envelope describes.);
- the state carried out of ``process_frames``: every leaf at the JAX
  leaf's dtype and within rel_rms 0.1 of it (measured at most 0.031, on
  the ``turbo`` conv tails, whose bf16 inputs round apart).  Contractive
  weights make the output barely depend on the DPRNN: a port that drops a
  DPRNN block moves the output by less than bf16 rounding does, but leaves
  that block's carried hidden at rel_rms 1.0.  A ``turbo`` port that skips
  its bf16 casts fails the dtypes, and the output bounds on the 48 kHz
  model (measured 1.1e-5 max-abs on waveforms, 3.9e-6 on frames);
- 2e-3 for the V2 ``forward_spec`` under ``fast`` (float32 planes, bf16 xp):
  the two packages sum ``x . Wi`` in different orders before rounding it to
  bf16, so a value near a rounding midpoint lands one bf16 ulp apart and
  moves that row's recurrence; measured 9.3e-4 on a DPRNN hidden;
- 1e-7 for a ``turbo`` pool slot against a lone stream: torch's CPU bf16
  GEMMs round a batch of 8 and a batch of 1 differently (measured 5.2e-10
  on outputs of about 1e-4);
- bit equality where the port is compared with itself on one batch
  (exact-mode chunking, save / load).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dpdfnet_tpu.config import get_config as jax_get_config
from dpdfnet_tpu.runtime import engine as jax_engine

from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.quality import speechlike_test_signal
from dpdfnet_tpu_torch.runtime import engine as engine_lib
from dpdfnet_tpu_torch.runtime.engine import Engine, engine_from_quality
from dpdfnet_tpu_torch.utils.serialization import params_from_jax
from dpdfnet_tpu_torch.utils.tree import tree_leaves

from torch_testing import jax_params_np

ATOL = 2e-6
REL_RMS = 3e-3
CASES = [("dpdfnet2", "fast"), ("dpdfnet2", "turbo"),
         ("dpdfnet8_48khz_hr", "fast"), ("dpdfnet8_48khz_hr", "turbo")]


def _rel_rms(got, ref):
    d = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    ref_ms = np.mean(np.square(np.asarray(ref, np.float64)))
    return float(np.sqrt(np.mean(d * d) / max(ref_ms, 1e-30)))


def _assert_matches_jax(got, ref):
    """max-abs <= ATOL and rel_rms <= REL_RMS (see the module notes)."""
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    rel = _rel_rms(got, ref)
    assert rel <= REL_RMS, f"rel_rms {rel:.3e} > {REL_RMS}"


@functools.lru_cache(maxsize=None)
def _engines(name, quality):
    """(JAX engine, port engine) of one tier, the same weights."""
    p = jax_params_np(name)
    return (jax_engine.engine_from_quality(jax_get_config(name), p, quality),
            engine_from_quality(get_config(name), params_from_jax(p, device="cpu"),
                                quality, device="cpu"))


def test_quality_tiers_match_jax():
    assert engine_lib.QUALITY_TIERS == jax_engine.QUALITY_TIERS


@pytest.mark.parametrize("name,quality", CASES)
def test_enhance_waveforms_matches_jax_tier(name, quality):
    j, t = _engines(name, quality)
    sr = get_config(name).sample_rate
    wavs = speechlike_test_signal(0.2, sr, seed=1, batch=2)
    lengths = np.array([wavs.shape[1], wavs.shape[1] - sr // 20])
    ref = j.enhance_waveforms(wavs, lengths=lengths)
    got = t.enhance_waveforms(wavs, lengths=lengths)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    _assert_matches_jax(got, ref)


@pytest.mark.parametrize("f32h", ["1", "0"])
def test_turbo_state_leaf_dtypes_match_jax(monkeypatch, f32h):
    """Under ``turbo`` every state leaf, fresh and after a ``forward_spec``
    step, has the JAX package's dtype: bf16 tails and delay lines, float32
    DPRNN hiddens (bf16 with ``DPDFNET_TPU_STATE_F32H=0``)."""
    from dpdfnet_tpu.models.dpdfnet import forward_spec as jax_forward_spec
    from dpdfnet_tpu_torch.models.dpdfnet import forward_spec

    monkeypatch.setenv("DPDFNET_TPU_STATE_F32H", f32h)
    j, t = _engines("dpdfnet2", "turbo")
    cfg = get_config("dpdfnet2")
    spec = np.random.default_rng(3).normal(size=(2, 2, cfg.freq_bins, 2)).astype(np.float32)
    st_j, st_t = j.init_stream_state(batch=2), t.init_stream_state(batch=2)

    def dtypes(st, conv):
        return {k: conv(v.dtype) for k, v in tree_leaves(st)}

    want = dtypes(st_j, lambda d: str(jnp.dtype(d)))
    assert dtypes(st_t, lambda d: str(d).replace("torch.", "")) == want
    assert want["dprnn_df/0"] == ("float32" if f32h == "1" else "bfloat16")
    assert want["df_spec_tail"] == "bfloat16"
    fwd = jax.jit(jax_forward_spec, static_argnums=1)     # one compile, not per op
    _, st_j, _ = fwd(j.params, cfg, jnp.asarray(spec, jnp.bfloat16), st_j)
    with torch.no_grad():
        _, st_t, _ = forward_spec(t.params, cfg, torch.from_numpy(spec).to(torch.bfloat16),
                                  st_t, precision="default")
    assert dtypes(st_t, lambda d: str(d).replace("torch.", "")) == \
        dtypes(st_j, lambda d: str(jnp.dtype(d)))


def test_v2_forward_spec_fast_matches_jax(monkeypatch):
    """``DPDFNET_TPU_PALLAS_V2=1`` under ``fast`` (precision ``"default"``):
    every block's inter stage is ``dprnn_inter_block_v2`` on bf16 xp, in
    both packages (JAX: Pallas interpret mode); outputs and every state
    leaf within 2e-3 (see the module notes)."""
    from dpdfnet_tpu.models.dpdfnet import forward_spec as jax_forward_spec
    from dpdfnet_tpu.models.fuse import fuse_separable, pack_dprnn_bidir
    from dpdfnet_tpu.models.state import init_state as jax_init_state
    from dpdfnet_tpu_torch.models.dpdfnet import forward_spec
    from dpdfnet_tpu_torch.models.fuse import prepare_inference_params
    from dpdfnet_tpu_torch.models.state import init_state
    from dpdfnet_tpu_torch.ops import gru_kernels

    for k, v in (("DPDFNET_TPU_PALLAS_V2", "1"), ("DPDFNET_TPU_PALLAS", "1"),
                 ("DPDFNET_TPU_PALLAS_INTERPRET", "1")):
        monkeypatch.setenv(k, v)
    name = "dpdfnet2"
    cfg_j, cfg = jax_get_config(name), get_config(name)
    p_np = jax_params_np(name)
    spec = (0.3 * np.random.default_rng(4).normal(size=(2, 6, cfg.freq_bins, 2))).astype(np.float32)
    fused_j = pack_dprnn_bidir(fuse_separable(p_np, cfg_j), cfg_j)
    assert "whfc" in fused_j["enc"]["dprnn_df"][0]["inter"]
    fwd = jax.jit(jax_forward_spec, static_argnums=1)     # one compile, not per op
    with jax.default_matmul_precision("default"):
        out_j, st_j, _ = fwd(fused_j, cfg_j, jnp.asarray(spec), jax_init_state(cfg_j, batch=2))

    params = prepare_inference_params(params_from_jax(p_np, device="cpu"), cfg)
    blk = params["enc"]["dprnn_df"][0]
    np.testing.assert_array_equal(blk["inter"]["whfc"].numpy(),
                                  np.asarray(fused_j["enc"]["dprnn_df"][0]["inter"]["whfc"]))
    assert set(blk["intra"]["packed"]) == {"wi2", "wh2", "b2", "wi_cat", "wh_big"}
    calls = []
    real = gru_kernels.dprnn_inter_block_v2_plain
    monkeypatch.setattr(gru_kernels, "dprnn_inter_block_v2_plain",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        out_t, st_t, _ = forward_spec(params, cfg, torch.from_numpy(spec),
                                      init_state(cfg, batch=2, device="cpu"),
                                      precision="default")
    assert len(calls) == 2 * cfg.dprnn_blocks
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-3)
    lj = {k: np.asarray(v) for k, v in tree_leaves(st_j)}
    for k, v in tree_leaves(st_t):
        np.testing.assert_allclose(v.numpy(), lj[k], atol=2e-3, err_msg=k)


def test_highest_engine_after_fast_keeps_tf32_off(monkeypatch):
    """The ``fast`` tier turns TF32 on only inside its own calls: a
    ``highest`` engine built and run after it sees TF32 off, and the
    caller's settings are back after every call."""
    from dpdfnet_tpu_torch.runtime import engine as eng_mod

    seen = []
    real = eng_mod.forward_spec

    def spy(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(*a, **k)

    monkeypatch.setattr(eng_mod, "forward_spec", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = get_config("dpdfnet2")
    params = params_from_jax(jax_params_np("dpdfnet2"), device="cpu")
    wav = speechlike_test_signal(0.05, cfg.sample_rate)
    engine_from_quality(cfg, params, "fast", device="cpu").enhance_waveforms(wav)
    assert seen and all(s == (True, True) for s in seen)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    seen.clear()
    hi = Engine(cfg, params, precision="highest", device="cpu")
    hi.enhance_waveforms(wav)
    hi.process_frames(np.zeros((1, 2, cfg.win_len), np.float32), hi.init_stream_state())
    assert seen and all(s == (False, False) for s in seen)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_quality_helpers():
    """``speechlike_test_signal`` gives the JAX package's numbers;
    ``tier_deviation`` on the CPU gives ``high`` and ``fast`` no deviation
    (TF32 is a CUDA math mode: on the CPU both run ``highest``'s float32)
    and ``turbo`` a nonzero one inside the card gate of 5e-4, with the JAX
    function's keys."""
    from dpdfnet_tpu.quality import speechlike_test_signal as jax_signal
    from dpdfnet_tpu_torch.quality import tier_deviation

    np.testing.assert_array_equal(speechlike_test_signal(0.05, 16000, seed=4, batch=2),
                                  jax_signal(0.05, 16000, seed=4, batch=2))
    params = params_from_jax(jax_params_np("dpdfnet2"), device="cpu")
    # 0.4 s: STOI, one of the columns, needs 384 ms of speech
    dev = tier_deviation("dpdfnet2", seconds=0.4, batch=1, params=params, contract=None,
                         device="cpu")
    assert dev["_ref_rms"] > 0 and dev["_input_rms"] > 0
    for tier in ("high", "fast", "turbo"):
        assert set(dev[tier]) == {"rel_rms", "max_abs", "rms_vs_input_db", "stoi_vs_highest",
                                  "sisnr_vs_highest_db"}
    assert dev["high"]["max_abs"] == 0.0 and dev["fast"]["max_abs"] == 0.0
    assert 0.0 < dev["turbo"]["max_abs"] <= 5e-4
