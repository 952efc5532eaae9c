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
from dpdfnet_tpu_torch.parallel.mesh import make_mesh
from dpdfnet_tpu_torch.runtime import telemetry
from dpdfnet_tpu_torch.runtime.engine import Engine, engine_from_quality
from dpdfnet_tpu_torch.utils.serialization import params_from_jax

from offline_host_path import enhance_host_padded
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


# Mixed lengths at ``seg_frames=16`` on dpdfnet2 (hop 160, win 320): a
# segment is 2560 samples and ``bucket_len`` pads to ``k * 2560 - 480``.
# Rows: 2 segments, empty, exactly one segment (1760 + win_len = 2080),
# one sample past it (2), the batch's longest (4), three segments.
MIXED = np.array([2500, 0, 1760, 7000, 1761, 5000])
MIXED_NEED = [2, 0, 1, 4, 2, 3]


def _mixed_engine(**kwargs):
    cfg = get_config("dpdfnet2")
    params = params_from_jax(jax_params_np("dpdfnet2"), device="cpu")
    return Engine(cfg, params, seg_frames=16, bucket_s=0.0, device="cpu", **kwargs)


def _mixed_batch(lengths, seed):
    """Rows of noise, each zero past its length."""
    rng = np.random.default_rng(seed)
    wavs = np.zeros((len(lengths), int(max(lengths))), np.float32)
    for i, n in enumerate(lengths):
        wavs[i, :n] = 0.1 * rng.normal(size=n)
    return wavs


def _rows_run(monkeypatch):
    """The rows of every segment the engines run, in call order."""
    rows = []
    orig = Engine._segment

    def seg(self, spec_seg, st):
        rows.append((id(self), spec_seg.shape[0]))
        return orig(self, spec_seg, st)
    monkeypatch.setattr(Engine, "_segment", seg)
    return rows


def test_bucket_len_fills_whole_segments_and_clears_win_len():
    eng = _mixed_engine()
    cfg, seg = eng.cfg, 16 * eng.cfg.hop
    assert [eng.bucket_len(S) for S in (0, 1760, 1761, 4320, 7000)] == [
        seg - 480, seg - 480, 2 * seg - 480, 2 * seg - 480, 4 * seg - 480]
    for S in (0, 1, 1760, 1761, 7000, 48000):
        S_pad = eng.bucket_len(S)
        frames = (S_pad + cfg.win_len) // cfg.hop + 1
        assert S_pad >= S + cfg.win_len and frames % 16 == 0
        assert S_pad - seg < S + cfg.win_len                       # the least such length
        assert frames // 16 == eng._bucket_segments(S)
    np.testing.assert_array_equal(eng._bucket_segments(MIXED[MIXED > 0]),
                                  [n for n in MIXED_NEED if n])
    floor = Engine(eng.cfg, eng.params, seg_frames=16, bucket_s=1.0, fuse=False,
                   device="cpu")
    assert floor.bucket_len(0) == 7 * seg - 480 >= 16000           # bucket_s is the floor


def test_engine_rows_run_only_the_segments_their_lengths_need(monkeypatch):
    """An unsorted batch of mixed lengths: each row equals that row
    enhanced alone at its own length (1e-6: another batch takes another
    GEMM order) and is zero past its length; the rows drop out longest
    need last, and the counters count the row-segments run and the full
    rectangle."""
    eng = _mixed_engine()
    wavs = _mixed_batch(MIXED, seed=21)
    rows = _rows_run(monkeypatch)
    with telemetry.recording():
        telemetry.reset()
        got = eng.enhance_waveforms(wavs, lengths=MIXED)
        counts = telemetry.counters()
        telemetry.reset()
    assert [n for _, n in rows] == [5, 4, 2, 1]
    assert counts == {"engine.row_segments": sum(MIXED_NEED),
                      "engine.row_segments_full": len(MIXED) * max(MIXED_NEED)}
    assert got.shape == wavs.shape and np.isfinite(got).all()
    for i, n in enumerate(MIXED):
        assert np.all(got[i, n:] == 0.0)
        if n:
            alone = eng.enhance_waveforms(wavs[i, :n])
            assert float(np.abs(alone).max()) > 0
            np.testing.assert_allclose(got[i, :n], alone, atol=1e-6)


def test_engine_without_lengths_runs_every_row_segment(monkeypatch):
    """Without ``lengths`` every row is the batch's length: the whole
    rectangle runs (share 1.0), and the output matches the same batch
    given full lengths bit for bit."""
    eng = _mixed_engine()
    wavs = _mixed_batch([5000, 5000, 5000], seed=22)
    rows = _rows_run(monkeypatch)
    with telemetry.recording():
        telemetry.reset()
        got = eng.enhance_waveforms(wavs)
        counts = telemetry.counters()
        telemetry.reset()
    assert [n for _, n in rows] == [3, 3, 3]
    assert counts["engine.row_segments"] == counts["engine.row_segments_full"] == 9
    np.testing.assert_array_equal(got, eng.enhance_waveforms(wavs, lengths=np.full(3, 5000)))


def test_engine_progress_reports_one_per_segment_with_rows_dropping_out():
    """The stepped path reports ``(0, T)`` then ``(16 * (i + 1), T)`` after
    each of the call's segments, also those no row reaches, with the
    unstepped output."""
    eng = _mixed_engine()
    lengths = np.array([2500, 1200, 900])
    wavs = np.zeros((3, 9000), np.float32)
    wavs[:, :2500] = _mixed_batch(lengths, seed=23)
    calls = []
    stepped = eng.enhance_waveforms(wavs, lengths=lengths,
                                    progress_callback=lambda d, n: calls.append((d, n)))
    T = 16 * eng._bucket_segments(9000)
    assert calls == [(0, T)] + [(16 * (i + 1), T) for i in range(T // 16)]
    assert all(type(v) is int for c in calls for v in c)
    np.testing.assert_array_equal(stepped, eng.enhance_waveforms(wavs, lengths=lengths))


def _host_path_case(case):
    """(engine, wavs, kwargs) of one case of the host-path comparison."""
    eng = _mixed_engine()
    if case.startswith("mesh"):
        # B=3 on two replicas: the second shard is one row and a zero row;
        # B=2 on three: an empty row, and a replica with only a zero row
        n, lengths = (2, [7000, 900, 6000]) if case == "mesh_padding_row" else (3, [5000, 0])
        eng = Engine(eng.cfg, eng.params, seg_frames=16, bucket_s=0.0, fuse=False,
                     mesh=make_mesh(["cpu"] * n))
        return eng, _mixed_batch(lengths, seed=33), {"lengths": np.array(lengths)}
    rng = np.random.default_rng(34)
    if case == "no_lengths":
        return eng, (0.1 * rng.normal(size=(3, 5000))).astype(np.float32), {}
    if case == "one_d":
        return eng, (0.1 * rng.normal(size=4321)).astype(np.float32), {}
    kwargs = {"lengths": MIXED}
    if case == "attn_limit":
        kwargs["attn_limit_db"] = 12.0
    return eng, _mixed_batch(MIXED, seed=35), kwargs


@pytest.mark.parametrize("case", ["mixed_with_empty_row", "no_lengths", "one_d", "attn_limit",
                                  "mesh_padding_row", "mesh_replica_without_rows"])
def test_device_pad_and_cut_bit_equal_to_the_host_path(case):
    """The engine pads, cuts and zeroes on the device and fetches only the
    caller's ``[B, S]``: its output equals, bit for bit, the host-side pad,
    fetch of the padded output and cut (``offline_host_path``), and is an
    array of its own that a second call leaves as it was."""
    eng, wavs, kwargs = _host_path_case(case)
    got = eng.enhance_waveforms(wavs, **kwargs)
    ref = enhance_host_padded(eng, wavs, **kwargs)
    assert got.shape == wavs.shape and got.dtype == np.float32
    assert float(np.abs(got).max()) > 0
    np.testing.assert_array_equal(got, ref)
    kept = got.copy()
    again = eng.enhance_waveforms(np.flip(wavs, -1), **kwargs)
    np.testing.assert_array_equal(got, kept)
    assert not np.shares_memory(got, again) and not np.shares_memory(got, wavs)


def test_lengths_give_one_per_row_and_a_negative_one_zeroes_its_row():
    """``lengths`` must hold one length per row; a length below 0 is
    clipped to 0, so the card zeroes the whole row, also where the
    attenuation limit blends in the noisy signal."""
    eng = _mixed_engine()
    wavs = _mixed_batch([3000, 3000], seed=36)
    with pytest.raises(ValueError, match="1 lengths for a batch of 2"):
        eng.enhance_waveforms(wavs, lengths=np.array([3000]))
    got = eng.enhance_waveforms(wavs, attn_limit_db=6.0, lengths=np.array([-5, 3000]))
    assert np.all(got[0] == 0.0) and float(np.abs(got[1]).max()) > 0
