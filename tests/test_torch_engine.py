"""The port's offline engine against the JAX package's.

Weights: the JAX package's ``init_params`` + ``contract_params``, carried
across with ``params_from_jax``; inputs from numpy seeds.  The JAX engine
runs on the CPU at ``precision="highest"``, the port's on ``device="cpu"``
(every kernel wrapper takes its plain version).

Tolerance: 1e-4 max-abs on the waveform.  The JAX engine runs the 48 kHz
plane folded (``fold_hr_tail``), the port's engine unfolded (its
``prepare_inference_params`` leaves the fold out: ``PERF.md``);
the two forms agree to float32 rounding (``test_torch_fold.py``).  The
DFT / iDFT GEMMs over 960-sample frames and the overlap-add accumulate
float32 rounding; the network's own deviation is pinned at 3e-5 by
``test_torch_model.py``.
"""

import numpy as np
import pytest
import torch

from dpdfnet_tpu.config import get_config as jax_get_config
from dpdfnet_tpu.runtime.engine import Engine as JaxEngine

from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.runtime.engine import Engine, engine_from_quality
from dpdfnet_tpu_torch.utils.serialization import params_from_jax

from torch_testing import jax_params_np

CONFIGS = ["dpdfnet2", "dpdfnet8_48khz_hr"]


@pytest.mark.parametrize("name", CONFIGS)
def test_engine_enhance_waveforms_matches_jax(name):
    cfg_j, cfg = jax_get_config(name), get_config(name)
    p_np = jax_params_np(name)
    rng = np.random.default_rng(11)
    S = cfg.sample_rate // 2                                     # 0.5 s
    t = np.arange(S) / cfg.sample_rate
    wavs = np.stack([0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=S),
                     0.1 * rng.normal(size=S)]).astype(np.float32)
    lengths = np.array([S, S - 3000])

    ref = JaxEngine(cfg_j, p_np, precision="highest").enhance_waveforms(
        wavs, lengths=lengths)
    got = Engine(cfg, params_from_jax(p_np, device="cpu"), precision="highest",
                 device="cpu").enhance_waveforms(wavs, lengths=lengths)
    assert got.shape == wavs.shape and np.isfinite(got).all()
    assert np.all(got[1, S - 3000:] == 0.0)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_engine_segments_match_single_span():
    """The segment loop with carried state equals one long forward."""
    cfg = get_config("dpdfnet2")
    params = params_from_jax(jax_params_np("dpdfnet2"), device="cpu")
    rng = np.random.default_rng(12)
    wav = (0.1 * rng.normal(size=(1, 8000))).astype(np.float32)
    one = Engine(cfg, params, device="cpu").enhance_waveforms(wav)
    seg = Engine(cfg, params, seg_frames=16, device="cpu").enhance_waveforms(wav)
    np.testing.assert_allclose(seg, one, atol=1e-5)


def test_engine_rejects_unported_tiers():
    """Every tier of the JAX table builds (the bf16 tiers since their port);
    an unknown tier or precision raises; the progress path (once unported)
    runs and reports the JAX package's sequence."""
    cfg = get_config("dpdfnet2")
    params = params_from_jax(jax_params_np("dpdfnet2"), device="cpu")
    with pytest.raises(ValueError, match="Unknown quality"):
        engine_from_quality(cfg, params, "ultra", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        Engine(cfg, params, precision="tf32", device="cpu")
    events = []
    Engine(cfg, params, device="cpu").enhance_waveforms(
        np.zeros(1600, np.float32), progress_callback=lambda *a: events.append(a))
    assert events[0][0] == 0 and events[-1][0] == events[-1][1] > 0
    assert engine_from_quality(cfg, params, "high", device="cpu").precision == "high"
    fast = engine_from_quality(cfg, params, "fast", device="cpu")
    turbo = engine_from_quality(cfg, params, "turbo", device="cpu")
    assert (fast.precision, fast.compute_dtype) == ("default", torch.float32)
    assert (turbo.precision, turbo.compute_dtype) == ("default", torch.bfloat16)


def test_engine_unfused_matches_jax_unfused():
    """``Engine(fuse=False)``: raw params, so each DPRNN block takes the
    unpacked route (``gru_bidir`` + linear + LN, ``gru_seq`` + linear + LN)
    in both packages.  dpdfnet2, two 0.4 s utterances, atol 1e-4 as above."""
    name = "dpdfnet2"
    cfg_j, cfg = jax_get_config(name), get_config(name)
    p_np = jax_params_np(name)
    rng = np.random.default_rng(13)
    wavs = (0.1 * rng.normal(size=(2, 6400))).astype(np.float32)
    ref = JaxEngine(cfg_j, p_np, precision="highest", fuse=False).enhance_waveforms(wavs)
    eng = Engine(cfg, params_from_jax(p_np, device="cpu"), precision="highest",
                 fuse=False, device="cpu")
    assert "packed" not in eng.params["enc"]["dprnn_df"][0]["intra"]
    got = eng.enhance_waveforms(wavs)
    np.testing.assert_allclose(got, ref, atol=1e-4)
