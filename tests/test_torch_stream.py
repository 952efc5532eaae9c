"""The port's streaming path against the JAX package's: ``process_frames``
in both modes, the flat state, and ``StreamEnhancer`` with the behaviours
``tests/test_stream.py`` pins for JAX.

Weights: the JAX package's ``init_params`` + ``contract_params``, carried
across with ``params_from_jax``; signals from numpy seeds.  The JAX engine
runs on the CPU at ``precision="highest"`` on its plain path, the port's
on ``device="cpu"`` (every kernel wrapper takes its plain version).

Tolerances: 1e-4 max-abs on time frames and waveforms against JAX (the
rfft front and back ends over the frame add their float32 rounding to the
network's 3e-5 bound of ``test_torch_model.py``); bit equality where the
port is compared with itself (exact-mode chunking, reset, save/load).
"""

import functools

import numpy as np
import pytest
import jax
import torch

from dpdfnet_tpu.config import get_config as jax_get_config
from dpdfnet_tpu.models import params as jax_params
from dpdfnet_tpu.models import state as jax_state
from dpdfnet_tpu.runtime.engine import Engine as JaxEngine
from dpdfnet_tpu.stream import StreamEnhancer as JaxStreamEnhancer

from dpdfnet_tpu_torch.config import get_config
from dpdfnet_tpu_torch.models import state as state_lib
from dpdfnet_tpu_torch.runtime.engine import Engine
from dpdfnet_tpu_torch.stream import StreamEnhancer
from dpdfnet_tpu_torch.utils.serialization import params_from_jax

torch.set_num_threads(1)
ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _engines(name):
    """(JAX engine, port engine) for one config, the same weights."""
    cfg_j = jax_get_config(name)
    p = jax.tree_util.tree_map(
        np.asarray, jax_params.contract_params(jax_params.init_params(cfg_j, seed=3)))
    return (JaxEngine(cfg_j, p, precision="highest"),
            Engine(get_config(name), params_from_jax(p, device="cpu"),
                   precision="highest", device="cpu"))


@pytest.fixture(scope="module")
def engines():
    return _engines("dpdfnet2")


@pytest.fixture(scope="module")
def signal():
    rng = np.random.default_rng(0)
    return (0.1 * rng.normal(size=4000)).astype(np.float32)


def _frames(rng, cfg, B, T):
    return (0.1 * rng.normal(size=(B, T, cfg.win_len))).astype(np.float32)


def _run_chunked(engine, x, sizes):
    se = StreamEnhancer(engine=engine)
    outs, pos, i = [], 0, 0
    while pos < len(x):
        n = sizes[i % len(sizes)]
        i += 1
        outs.append(se.process(x[pos: pos + n]))
        pos += n
    outs.append(se.flush())
    return np.concatenate(outs)


@pytest.mark.parametrize("mode", ["exact", "throughput"])
def test_process_frames_matches_jax(engines, mode):
    """Two calls (11 frames, then 3 from the carried state), the same
    chunking on both sides: 11 = 8 + 2 + 1 buckets in throughput mode."""
    jeng, teng = engines
    rng = np.random.default_rng(1)
    f1, f2 = _frames(rng, teng.cfg, 3, 11), _frames(rng, teng.cfg, 3, 3)
    st_j, st_t = jeng.init_stream_state(batch=3), teng.init_stream_state(batch=3)
    for f in (f1, f2):
        y_j, st_j = jeng.process_frames(f, st_j, mode=mode)
        y_t, st_t = teng.process_frames(f, st_t, mode=mode)
        assert y_t.shape == f.shape and y_t.dtype == np.float32
        np.testing.assert_allclose(y_t, y_j, atol=ATOL)
    np.testing.assert_allclose(state_lib.flatten_state(teng.cfg, st_t, stream=2),
                               jax_state.flatten_state(jeng.cfg, st_j, stream=2), atol=ATOL)


def test_process_frames_hr_matches_jax():
    """The 48 kHz full-band path (dpdfnet2_48khz_hr), exact mode."""
    jeng, teng = _engines("dpdfnet2_48khz_hr")
    f = _frames(np.random.default_rng(2), teng.cfg, 1, 4)
    y_j, _ = jeng.process_frames(f, jeng.init_stream_state(batch=1))
    y_t, _ = teng.process_frames(f, teng.init_stream_state(batch=1))
    np.testing.assert_allclose(y_t, y_j, atol=ATOL)


def test_exact_mode_is_bit_invariant_to_chunking(engines):
    _, teng = engines
    f = _frames(np.random.default_rng(3), teng.cfg, 2, 12)
    outs = []
    for cuts in ([12], [1] * 12, [3, 5, 4]):
        st, ys, pos = teng.init_stream_state(batch=2), [], 0
        for n in cuts:
            y, st = teng.process_frames(f[:, pos:pos + n], st)
            ys.append(y)
            pos += n
        outs.append(np.concatenate(ys, axis=1))
    for y in outs[1:]:
        np.testing.assert_array_equal(y, outs[0])
    with pytest.raises(ValueError, match="mode"):
        teng.process_frames(f, teng.init_stream_state(batch=2), mode="banana")
    y, _ = teng.process_frames(f[:, :0], teng.init_stream_state(batch=2))
    assert y.shape == (2, 0, teng.cfg.win_len)


def test_stream_block_size_invariance(engines, signal):
    _, teng = engines
    ref = _run_chunked(teng, signal, [4000])
    assert ref.shape == signal.shape
    for sizes in ([7, 313], [160], [171, 1000, 3]):
        np.testing.assert_array_equal(_run_chunked(teng, signal, sizes), ref)


def test_stream_matches_jax_stream(engines, signal):
    jeng, teng = engines
    ref_se = JaxStreamEnhancer(engine=jeng)
    ref = np.concatenate([ref_se.process(signal), ref_se.flush()])
    np.testing.assert_allclose(_run_chunked(teng, signal, [1000]), ref, atol=ATOL)


def test_no_output_until_full_window(engines):
    se = StreamEnhancer(engine=engines[1])
    win = se._win_len
    assert se.process(np.zeros(win - 1, np.float32)).size == 0
    assert se.process(np.zeros(1, np.float32)).size == se._hop_size
    assert se.process(np.zeros(0, np.float32)).size == 0


def test_flush_returns_at_most_one_hop(engines, signal):
    se = StreamEnhancer(engine=engines[1])
    assert se.flush().size == 0                     # empty buffer
    se.process(signal[: se._win_len + 13])
    out = se.flush()
    assert 0 < out.size <= se._hop_size


def test_reset_clears_state(engines, signal):
    se = StreamEnhancer(engine=engines[1])
    a = se.process(signal[:1200])
    se.reset()
    np.testing.assert_array_equal(se.process(signal[:1200]), a)


def test_sample_rate_change_raises(engines, signal):
    se = StreamEnhancer(engine=engines[1])
    se.process(signal[:100], sample_rate=16000)
    with pytest.raises(ValueError, match="Hz"):
        se.process(signal[:100], sample_rate=48000)


def test_stereo_to_mono(engines, signal):
    se = StreamEnhancer(engine=engines[1])
    a = se.process(np.stack([signal[:1200], signal[:1200]], axis=1))
    se.reset()
    np.testing.assert_array_equal(a, se.process(signal[:1200]))


def test_resampled_stream_matches_jax(engines):
    """48 kHz input to the 16 kHz model: resampled in, enhanced, resampled
    back out at the caller's rate, then flushed."""
    jeng, teng = engines
    chunk = (0.1 * np.random.default_rng(7).normal(size=4801)).astype(np.float32)
    outs = []
    for se in (JaxStreamEnhancer(engine=jeng), StreamEnhancer(engine=teng)):
        outs.append((se.process(chunk, sample_rate=48000), se.flush()))
    (ref, ref_tail), (got, got_tail) = outs
    assert got.dtype == np.float32 and got.size > 0
    assert 0 < got_tail.size <= 3 * teng.cfg.hop
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got_tail, ref_tail, atol=ATOL)


def test_save_load_state_resumes_bit_exact(engines, signal):
    teng = engines[1]
    se = StreamEnhancer(engine=teng)
    se.process(signal[:2000])
    snap = se.save_state()
    a = se.process(signal[2000:])
    se2 = StreamEnhancer(engine=teng)
    se2.load_state(snap)
    np.testing.assert_array_equal(se2.process(signal[2000:]), a)


def test_flat_state_matches_jax(engines):
    """``flatten_state`` of the same state gives the JAX package's vector
    bit for bit, and ``unflatten_state`` inverts it."""
    jeng, teng = engines
    f = _frames(np.random.default_rng(4), teng.cfg, 2, 3)
    _, st_j = jeng.process_frames(f, jeng.init_stream_state(batch=2))
    st_t = {k: ([torch.tensor(np.asarray(u)) for u in v] if isinstance(v, list)
                else torch.tensor(np.asarray(v))) for k, v in st_j.items()}
    flat = state_lib.flatten_state(teng.cfg, st_t, stream=1)
    assert flat.shape == (state_lib.state_size(teng.cfg),)
    assert state_lib.state_size(teng.cfg) == jax_state.state_size(jeng.cfg)
    np.testing.assert_array_equal(flat, jax_state.flatten_state(jeng.cfg, st_j, stream=1))
    back = state_lib.unflatten_state(teng.cfg, flat, batch=3, device="cpu")
    assert back["dprnn_df"][0].shape == (3,) + tuple(st_t["dprnn_df"][0].shape[1:])
    np.testing.assert_array_equal(state_lib.flatten_state(teng.cfg, back, stream=2), flat)
    with pytest.raises(ValueError, match="configuration"):
        state_lib.unflatten_state(teng.cfg, flat[:-1], device="cpu")


def test_jax_stream_state_hands_over_to_the_port(engines, signal):
    """A stream saved by the JAX ``StreamEnhancer`` and loaded into the
    port's continues as the JAX stream does."""
    jeng, teng = engines
    jse = JaxStreamEnhancer(engine=jeng)
    jse.process(signal[:1700])
    snap = jse.save_state()
    ref = jse.process(signal[1700:])
    se = StreamEnhancer(engine=teng)
    se.load_state(snap)
    np.testing.assert_allclose(se.process(signal[1700:]), ref, atol=ATOL)


def test_stream_enhancer_needs_an_engine():
    with pytest.raises(NotImplementedError, match="engine"):
        StreamEnhancer()
